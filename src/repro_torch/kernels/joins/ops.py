"""Wrappers for the coarsening's join kernels (``csrc/joins.cu``): the root
join with the Alg. 2 cleanup (``root_join``, and ``cleanup_join`` from given
labels), Alg. 3's phase 2 (``phase2_join``) and phase 3
(``phase3_fixed_point``), each one cooperative launch over a
:class:`~.ref.Layout`, the padded ELL's (``ell_layout``) or the hybrid
layout's (``hybrid_layout``).

A tensor on the CPU goes to the plain-torch twin (``ref``); a tensor on a
CUDA device goes to the hand-written kernel, or the call raises — there is
no fallback from one to the other, and a launch refused (a grid that does
not fit on the card among the reasons) raises ``KernelLaunchError``.
``LAUNCHES`` counts kernel launches (twin calls are not counted).  On the
card a call reads nothing back to the host: the aggregate counts stay on
the device.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref
from .ref import JOIN_ROUNDS, Layout, ell_layout, hybrid_layout

__all__ = ["LAUNCHES", "Layout", "cleanup_join", "ell_layout",
           "hybrid_layout", "phase2_join", "phase3_fixed_point", "root_join"]

LAUNCHES = {"root_join": 0, "phase2_join": 0, "phase3_fixed_point": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_HEAD = (_P, _I, _P, _P, _P, _I64, _I64)     # maps, S, the spill, H, E
_SIGNATURES = {
    "root_join": _HEAD + (_P,) * 7 + (_I64, _I64, _I, _I, _P),
    "phase2_join": _HEAD + (_P,) * 9 + (_I64, _I64, _I, _I, _P),
    "phase3_fixed_point": _HEAD + (_P,) * 5 + (_I64, _I64, _I, _I, _P),
    "join_lanes": (_I,),
    "join_scratch_words": (_I, _I64, _I64, _I64, _I64, _I),
}
_MAP_TABLES: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry(name: str):
    return _build.function("joins", name, _SIGNATURES[name])


def _check(named: dict, dev) -> None:
    """Device, dtype and contiguity of every tensor in ``named``, whose
    name ends in its kind: ``mask`` / ``roots`` / ``set2`` bool, ``phase``
    uint8, the rest int32."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        want = (torch.bool if name.endswith(("mask", "roots", "set2"))
                else torch.uint8 if name.endswith("phase") else torch.int32)
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_layout(layout: Layout, vectors: dict) -> torch.device:
    """The layout's maps and spill, and the ``[V]`` vectors; returns their
    device."""
    rows, seg, cols = layout.spill
    dev = rows.device
    named = {"spill rows": rows, "spill seg": seg, "spill cols": cols}
    for i, (mrows, nbrs, mask) in enumerate(layout.maps):
        named.update({f"map {i} neighbors": nbrs, f"map {i} mask": mask})
        if mrows is not None:
            named[f"map {i} rows"] = mrows
        if nbrs.dim() != 2 or mask.shape != nbrs.shape or (
                mrows is not None and mrows.shape[0] != nbrs.shape[0]):
            raise ValueError(
                f"map {i}: rows {None if mrows is None else tuple(mrows.shape)}"
                f", neighbors {tuple(nbrs.shape)} and mask "
                f"{tuple(mask.shape)} disagree")
    if seg.shape != cols.shape:
        raise ValueError("spill seg and cols differ in length")
    for name, x in vectors.items():
        if x.shape != (layout.v,):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"({layout.v},)")
    _check(named | vectors, dev)
    return dev


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _map_table(layout: Layout, dev) -> tuple[torch.Tensor, int]:
    """The kernels' ``[S, 7]`` int64 table on the card (``JoinMap``): each
    map's rows, ids and mask pointers, R, D, its G lanes a row and the
    rows of the maps before it; and their rows in all.  A pure function of
    the maps' pointers and shapes, so it is built and copied once per
    layout and kept, keyed by them."""
    shapes = [(_ptr(rows), _ptr(nbrs), _ptr(mask), *nbrs.shape)
              for rows, nbrs, mask in layout.maps]
    key = (str(dev), *shapes)
    hit = _MAP_TABLES.get(key)
    if hit is None:
        words, off = [], 0
        for rows, nbrs, mask, r, d in shapes:
            words += [rows, nbrs, mask, r, d, _entry("join_lanes")(d), off]
            off += r
        hit = (torch.tensor(words, dtype=torch.int64).to(dev), off)
        if len(_MAP_TABLES) >= 64:
            _MAP_TABLES.pop(next(iter(_MAP_TABLES)))
        _MAP_TABLES[key] = hit
    return hit


def _scratch_words():
    """``join_scratch_words``, which returns an int64."""
    fn = _entry("join_scratch_words")
    fn.restype = ctypes.c_int64
    return fn


def _launch(name: str, dev, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _entry(name)(*args, stream)
    _build.check(status, name)
    LAUNCHES[name] += 1


def _frame(layout: Layout, dev, table: bool):
    """The table, the spill's pointers and sizes, and a fresh scratch."""
    maps, sum_r = _map_table(layout, dev)
    rows, seg, cols = layout.spill
    h, e = rows.shape[0], cols.shape[0]
    words = _scratch_words()(len(layout.maps), sum_r, h, e, layout.v,
                             int(table))
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    head = (maps.data_ptr(), len(layout.maps), rows.data_ptr(),
            seg.data_ptr(), cols.data_ptr(), h, e)
    return head, scratch, sum_r


def _outputs(v: int, dev):
    return (torch.empty(v, dtype=torch.int32, device=dev),
            torch.empty(v, dtype=torch.uint8, device=dev))


def root_join(layout: Layout, roots, *, cleanup_rounds: int = 0):
    """Phase-1 aggregates from the MIS-2 ``roots`` (bool ``[V]``): each
    root and its direct neighbours, ids in the roots' row order; then up to
    ``cleanup_rounds`` rounds of the Alg. 2 cleanup.  Returns ``(labels
    int32 [V], phase uint8 [V], aux int32 [2]: the aggregates and the rows
    left unlabeled)`` on the layout's device."""
    dev = _check_layout(layout, {"roots": roots})
    if cleanup_rounds < 0:
        raise ValueError(f"cleanup_rounds={cleanup_rounds} is negative")
    if dev.type == "cpu":
        return ref.root_join_ref(layout, roots,
                                 cleanup_rounds=cleanup_rounds)
    return _root_join_on_card(layout, roots, None, None, cleanup_rounds)


def cleanup_join(layout: Layout, labels, phase):
    """The Alg. 2 cleanup alone from ``labels`` (int32 ``[V]``) and
    ``phase`` (uint8 ``[V]``): up to four min-adjacent-label join rounds,
    each row joined marked 3.  Returns new ``(labels, phase)``; on the card
    one launch of the ``root_join`` kernel without roots."""
    dev = _check_layout(layout, {"labels": labels, "phase": phase})
    if dev.type == "cpu":
        return ref.cleanup_join_ref(layout, labels, phase)
    return _root_join_on_card(layout, None, labels, phase, JOIN_ROUNDS)[:2]


def phase2_join(layout: Layout, labels, phase, in_set2, nagg, *,
                min_secondary: int):
    """Alg. 3 phase 2 from ``labels`` / ``phase`` and the second MIS-2's
    set ``in_set2`` (bool ``[V]``): the rows of the set with at least
    ``min_secondary`` unaggregated real neighbours become roots, numbered
    from ``nagg`` (int32 ``[1]`` on the device) in row order, and the
    unlabeled rows join them (marked 2).  Returns ``(labels, phase, roots2
    bool [V], nagg int32 [1])``."""
    dev = _check_layout(layout, {"labels": labels, "phase": phase,
                                 "in_set2": in_set2})
    _check({"nagg": nagg}, dev)
    if nagg.shape != (1,):
        raise ValueError(f"nagg has shape {tuple(nagg.shape)}, expected (1,)")
    if dev.type == "cpu":
        return ref.phase2_join_ref(layout, labels, phase, in_set2, nagg,
                                   min_secondary=min_secondary)
    return _phase2_on_card(layout, labels, phase, in_set2, nagg,
                           min_secondary)


def phase3_fixed_point(layout: Layout, labels, phase):
    """Alg. 3 phase 3 from ``labels`` / ``phase``: up to four max-coupling
    join rounds against frozen tentative labels (ties -> smaller aggregate
    -> smaller label), each row joined marked 3.  Returns new ``(labels,
    phase)``."""
    dev = _check_layout(layout, {"labels": labels, "phase": phase})
    if dev.type == "cpu":
        return ref.phase3_fixed_point_ref(layout, labels, phase)
    return _phase3_on_card(layout, labels, phase)


# The card paths: ``blocks`` is the cooperative grid, 0 for every block that
# fits on the card (a test asks for more, which the launch refuses).

def _root_join_on_card(layout: Layout, roots, labels, phase, rounds: int,
                       blocks: int = 0):
    """One ``root_join`` launch: from ``roots``, or (roots None) the
    cleanup alone from ``labels`` / ``phase``."""
    dev = layout.spill[0].device
    head, scratch, sum_r = _frame(layout, dev, False)
    out_labels, out_phase = _outputs(layout.v, dev)
    aux = torch.empty(2, dtype=torch.int32, device=dev)
    _launch("root_join", dev, *head, _ptr(roots), _ptr(labels), _ptr(phase),
            out_labels.data_ptr(), out_phase.data_ptr(), scratch.data_ptr(),
            aux.data_ptr(), layout.v, sum_r, rounds, blocks)
    return out_labels, out_phase, aux


def _phase2_on_card(layout: Layout, labels, phase, in_set2, nagg,
                    min_secondary: int, blocks: int = 0):
    dev = layout.spill[0].device
    head, scratch, sum_r = _frame(layout, dev, False)
    out_labels, out_phase = _outputs(layout.v, dev)
    roots2 = torch.empty(layout.v, dtype=torch.bool, device=dev)
    nagg_out = torch.empty(1, dtype=torch.int32, device=dev)
    _launch("phase2_join", dev, *head, labels.data_ptr(), phase.data_ptr(),
            in_set2.data_ptr(), nagg.data_ptr(), out_labels.data_ptr(),
            out_phase.data_ptr(), roots2.data_ptr(), scratch.data_ptr(),
            nagg_out.data_ptr(), layout.v, sum_r, min_secondary, blocks)
    return out_labels, out_phase, roots2, nagg_out


def _phase3_on_card(layout: Layout, labels, phase, blocks: int = 0,
                    rounds: int = JOIN_ROUNDS):
    """One ``phase3_fixed_point`` launch of at most ``rounds`` rounds (the
    wrapper's four; the tests and the timing tools cap it)."""
    dev = layout.spill[0].device
    head, scratch, sum_r = _frame(layout, dev, True)
    out_labels, out_phase = _outputs(layout.v, dev)
    _launch("phase3_fixed_point", dev, *head, labels.data_ptr(),
            phase.data_ptr(), out_labels.data_ptr(), out_phase.data_ptr(),
            scratch.data_ptr(), layout.v, sum_r, rounds, blocks)
    return out_labels, out_phase
