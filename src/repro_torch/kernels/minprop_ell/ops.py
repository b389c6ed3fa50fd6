"""Wrappers for the MIS-2 round passes: the fused ones over padded ELL and
over one slab of the hybrid layout, and the unfused ones of the host-driven
round; and for the whole fixed point in one launch, over padded ELL
(``resident_fixed_point``; ``resident_fixed_point_batched`` over a bucket
of graphs laid end to end, ``resident_fixed_point_seeded`` from a given T)
and over the hybrid layout (``hybrid_fixed_point``: its slabs and its COO
spill).

``fused_*`` and ``sliced_*`` take the resident drivers' state as it lies
on the device and update it in place.  ``refresh_columns_rows`` /
``decide_rows`` take pre-gathered worklist rows ``[W, D]`` and return a
new ``[W]`` output; ``refresh_columns`` / ``decide`` wrap them in the
host-driven round's plain-torch row gather and drop-scatter, as the JAX
package wraps its Pallas kernels in XLA.  A tensor on the CPU goes to the
plain-torch twin (``ref``); a tensor on a CUDA device goes to the
hand-written kernel (``csrc/minprop_ell.cu``), or the call raises — there
is no fallback from one to the other.

The spill's passes by ``scatter_reduce`` (the reference's XLA segment
reductions) live with the twins (``ref.spill_refresh_columns`` /
``ref.spill_decide``): ``hybrid_fixed_point`` runs the spill inside its
kernel, so only its twin and the tools that time the slab kernels call them.

``LAUNCHES`` counts kernel launches per wrapper (twin calls are not
counted), so a run can show that its hot loop went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.hashing import PRIORITY_CODES
from .. import _build
from . import ref
from .ref import set_drop

LAUNCHES = {"fused_refresh_columns": 0, "fused_decide": 0,
            "sliced_refresh_columns": 0, "sliced_decide": 0,
            "refresh_columns": 0, "decide": 0, "resident_fixed_point": 0,
            "resident_fixed_point_batched": 0,
            "resident_fixed_point_seeded": 0, "hybrid_fixed_point": 0}

_TAIL = (ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p)
_ROWS_TAIL = (ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p)
_SIGNATURES = {
    "fused_refresh_columns": (ctypes.c_void_p,) * 7 + _TAIL,
    "fused_decide": (ctypes.c_void_p,) * 7 + _TAIL,
    "sliced_refresh_columns": (ctypes.c_void_p,) * 7 + _TAIL,
    "sliced_decide": (ctypes.c_void_p,) * 8 + _TAIL,
    "refresh_columns": (ctypes.c_void_p,) * 3 + _ROWS_TAIL,
    "decide": (ctypes.c_void_p,) * 5 + _ROWS_TAIL,
    "resident_fixed_point": (ctypes.c_void_p,) * 7 + (
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    "resident_fixed_point_batched": (ctypes.c_void_p,) * 7 + (
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p),
    "resident_fixed_point_seeded": (ctypes.c_void_p,) * 7 + (
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    "hybrid_fixed_point": (ctypes.c_void_p,) * 4 + (ctypes.c_int,) + (
        ctypes.c_void_p,) * 4 + (ctypes.c_int64, ctypes.c_int64) + (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p),
    "hybrid_slab_shape": (ctypes.c_int, ctypes.c_int64),
}

#: the most blocks a Hopper SM holds at once, which bounds the grid of the
#: hybrid and misk persistent kernels and so their compaction's block counts
MAX_BLOCKS_PER_SM = 32

# ---------------------------------------------------------------------------
# adjacency row traffic of one live worklist row per pass: the host-driven
# round gathers the row in plain torch (1 read), writes the [W, D] copy (1
# write) and the kernel reads the copy back (1 read); the fused and sliced
# kernels read the row's ids once and materialize no copy; the spill is
# COO, counted per entry
# ---------------------------------------------------------------------------

ELL_ROW_TRAFFIC = {"cuda_compacted": {"reads": 2, "writes": 1},
                   "cuda_resident": {"reads": 1, "writes": 0},
                   "cuda_hybrid": {"reads": 1, "writes": 0}}


def ell_row_movements(engine: str) -> int:
    """Device-memory movements of one worklist row's ids per pass."""
    t = ELL_ROW_TRAFFIC[engine]
    return t["reads"] + t["writes"]


def hybrid_row_traffic_bytes(slice_widths, slice_rows_processed,
                             spill_entries: int, spill_passes: int) -> int:
    """Analytic adjacency traffic of one hybrid MIS-2 solve, in bytes:
    every live worklist row of slice ``i`` (refresh and decide, every round)
    moves its ``W_i`` int32 ids ``ell_row_movements('cuda_hybrid')`` times;
    every spill pass reads all ``spill_entries`` int32 column ids once."""
    moves = ell_row_movements("cuda_hybrid")
    total = 0
    for w, rows in zip(slice_widths, slice_rows_processed):
        total += int(rows) * int(w) * 4 * moves
    total += int(spill_passes) * int(spill_entries) * 4
    return total


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry(name: str):
    return _build.function("minprop_ell", name, _SIGNATURES[name])


def _check_args(t, nbrs_flat, wl, count, it, state, b: int, priority: str,
                slab_rows=None) -> tuple[int, int, int]:
    """Validate device, dtype, shape and contiguity; returns (V, R, D),
    with ``R = V`` for the padded ELL and ``R = len(slab_rows)`` for a
    hybrid slab.  A ``state`` entry that is None is not checked."""
    named = {"wl": wl, "count": count, "it": it}
    if slab_rows is not None:
        named["slab_rows"] = slab_rows
    v, d = _check_state(t, nbrs_flat, state, b, priority, named,
                        rows=None if slab_rows is None
                        else slab_rows.shape[0])
    if count.shape[0] != 1 or it.shape[0] != 1:
        raise ValueError("count and it must hold one element each")
    return v, v if slab_rows is None else slab_rows.shape[0], d


def _check_state(t, nbrs_flat, state, b: int, priority: str, others,
                 rows=None) -> tuple[int, int]:
    """Validate the ``[V]`` state (``t`` and the ``state`` entries that are
    not None), the flat ELL of ``rows`` rows (V if None) and ``others``:
    device, dtype, 1-D, contiguity; returns (V, D)."""
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    state = {k: x for k, x in state.items() if x is not None}
    named = {"t": t, "nbrs_flat": nbrs_flat, **others, **state}
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, t on {dev}")
        want = torch.bool if name == "active" else torch.int32
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(x.shape)}")
    v = t.shape[0]
    for name, x in state.items():
        if x.shape[0] != v:
            raise ValueError(f"{name} has {x.shape[0]} rows, t has {v}")
    r = v if rows is None else rows
    if r == 0 or nbrs_flat.shape[0] % r:
        raise ValueError(f"nbrs_flat length {nbrs_flat.shape[0]} is not a "
                         f"multiple of the {r} rows")
    if not 0 < b < 32:
        raise ValueError(f"id bits b={b} out of range")
    if priority not in PRIORITY_CODES:
        raise ValueError(f"unknown priority {priority!r}")
    return v, nbrs_flat.shape[0] // r


def _launch(name: str, t, *ptrs_and_sizes) -> None:
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        status = _entry(name)(*ptrs_and_sizes, stream)
    _build.check(status, name)
    LAUNCHES[name] += 1


def card_sms(device) -> int:
    """The card's SM count, which sizes a persistent kernel's grid."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_refresh_columns(t, m, nbrs_flat, wl, count, it, *, priority: str,
                          b: int) -> torch.Tensor:
    """M[wl[i]] <- min over the closed neighborhood of the refreshed T, with
    IN -> OUT, for every live slot ``i < count`` (in place; returns ``m``).

    ``t``, ``m``: int32 [V] (uint32 bit patterns); ``nbrs_flat``: int32
    [V*D] self-padded ELL; ``wl``: int32 [W] (sentinel V); ``count``,
    ``it``: int32 [1] on the same device.  On the card, at wide rows, the
    kernel first hashes each vertex once into a ``[V]`` scratch allocated
    here; ``t`` is not written.
    """
    v, _, d = _check_args(t, nbrs_flat, wl, count, it, {"m": m}, b,
                          priority)
    if t.device.type == "cpu":
        return ref.fused_refresh_columns_ref(t, m, nbrs_flat, wl, count, it,
                                             priority=priority, b=b)
    scratch = torch.empty_like(t)
    _launch("fused_refresh_columns", t, t.data_ptr(), m.data_ptr(),
            scratch.data_ptr(), nbrs_flat.data_ptr(), wl.data_ptr(),
            count.data_ptr(), it.data_ptr(), v, wl.shape[0], d, b,
            PRIORITY_CODES[priority])
    return m


def fused_decide(t, m, active, nbrs_flat, wl, count, it, *, priority: str,
                 b: int) -> torch.Tensor:
    """T[wl[i]] <- OUT if an active neighbor's M is OUT, else IN if every
    active neighbor's M equals the row's refreshed tuple, else that tuple,
    for every live slot ``i < count`` whose row is undecided (in place;
    returns ``t``).  ``active``: bool [V]; the rest as
    :func:`fused_refresh_columns`.
    """
    v, _, d = _check_args(t, nbrs_flat, wl, count, it,
                          {"m": m, "active": active}, b, priority)
    if t.device.type == "cpu":
        return ref.fused_decide_ref(t, m, active, nbrs_flat, wl, count, it,
                                    priority=priority, b=b)
    _launch("fused_decide", t, t.data_ptr(), m.data_ptr(), active.data_ptr(),
            nbrs_flat.data_ptr(), wl.data_ptr(), count.data_ptr(),
            it.data_ptr(), v, wl.shape[0], d, b, PRIORITY_CODES[priority])
    return t


def resident_fixed_point(t, m, active, nbrs_flat, *, priority: str, b: int,
                         max_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The §V-B fixed point over the self-padded ELL ``nbrs_flat`` (int32
    ``[V*D]``) from the mask ``active`` (bool ``[V]``), as
    ``ref.resident_fixed_point_ref`` defines it.  ``t``, ``m``: int32
    ``[V]``, written (T and M at the end; nothing in them is read).
    Returns ``(t, int32 [2])``, the rounds run and the undecided
    worklist's last count, on t's device.

    On the card one cooperative launch runs every round and reads no
    value from the host; the worklists and their counts live in scratch
    allocated here.  It raises (``KernelLaunchError``) where the card has
    no cooperative launch or the launch is refused: there is no per-round
    fallback."""
    _check_state(t, nbrs_flat, {"m": m, "active": active}, b, priority, {})
    _check_iters(max_iters)
    if t.device.type == "cpu":
        return ref.resident_fixed_point_ref(t, m, active, nbrs_flat,
                                            priority=priority, b=b,
                                            max_iters=max_iters)
    aux = _resident_on_card("resident_fixed_point", t, m, active, nbrs_flat,
                            b, PRIORITY_CODES[priority], max_iters)
    return t, aux[4:6]


def resident_fixed_point_batched(t, m, active, nbrs_flat, *, priority: str,
                                 bits: torch.Tensor, rows: int,
                                 max_iters: int):
    """:func:`resident_fixed_point` over a bucket of ``B`` graphs laid end
    to end, ``rows`` (a power of two) each: ``nbrs_flat`` the
    block-diagonal ELL of ``V = B * rows`` rows, ``bits`` (int32 ``[B]``,
    on t's device, each ``0 < b < 32``; not read back here) the members'
    id bits, ``active`` False on padding; as
    ``ref.resident_fixed_point_batched_ref`` defines it.  Returns ``(t,
    int32 [2], int32 [B])``: the rounds run and the last live count, and
    each member's rounds with an undecided row.  On the card one
    cooperative launch, as :func:`resident_fixed_point`."""
    if rows < 1 or rows & (rows - 1):
        raise ValueError(f"rows={rows} is not a power of two")
    if bits.dtype != torch.int32 or bits.dim() != 1 \
            or not bits.is_contiguous():
        raise TypeError("bits must be a contiguous 1-D int32 tensor")
    if bits.device != t.device:
        raise ValueError(f"bits is on {bits.device}, t on {t.device}")
    _check_state(t, nbrs_flat, {"m": m, "active": active}, 1, priority, {})
    if t.shape[0] != bits.shape[0] * rows:
        raise ValueError(f"t has {t.shape[0]} rows, {bits.shape[0]} members "
                         f"of {rows} rows make {bits.shape[0] * rows}")
    _check_iters(max_iters)
    if t.device.type == "cpu":
        return ref.resident_fixed_point_batched_ref(
            t, m, active, nbrs_flat, priority=priority, bits=bits, rows=rows,
            max_iters=max_iters)
    its = torch.empty(bits.shape[0], dtype=torch.int32, device=t.device)
    aux = _resident_on_card("resident_fixed_point_batched", t, m, active,
                            nbrs_flat, bits.data_ptr(), rows.bit_length() - 1,
                            its.data_ptr(), bits.shape[0],
                            PRIORITY_CODES[priority], max_iters)
    return t, aux[4:6], its


def resident_fixed_point_seeded(t, m, nbrs_flat, *, priority: str, b: int,
                                max_iters: int):
    """:func:`resident_fixed_point` from the T that ``t`` holds (read: IN /
    OUT on frozen rows, undecided words on the rows to solve; written: T at
    the end), every row active, as ``ref.resident_fixed_point_seeded_ref``
    defines it (the reference's ``mis2_repair_fixed_point``).  Returns
    ``(t, int32 [2])``.  On the card one cooperative launch, as
    :func:`resident_fixed_point`."""
    _check_state(t, nbrs_flat, {"m": m}, b, priority, {})
    _check_iters(max_iters)
    if t.device.type == "cpu":
        return ref.resident_fixed_point_seeded_ref(
            t, m, nbrs_flat, priority=priority, b=b, max_iters=max_iters)
    every = torch.ones(t.shape[0], dtype=torch.bool, device=t.device)
    aux = _resident_on_card("resident_fixed_point_seeded", t, m, every,
                            nbrs_flat, b, PRIORITY_CODES[priority], max_iters)
    return t, aux[4:6]


def _check_iters(max_iters: int) -> None:
    if max_iters < 0:
        raise ValueError(f"max_iters={max_iters} is negative")


def _resident_on_card(name: str, t, m, active, nbrs_flat, *tail):
    """One launch of the resident kernel through the C entry ``name``:
    the scratch and the worklists allocated here, ``tail`` the entry's own
    arguments after V and D.  Returns the ``aux`` words (the lists' four
    counts, then the rounds run and the last live count)."""
    v = t.shape[0]
    scratch = torch.empty_like(t)
    wl = torch.empty(4 * v, dtype=torch.int32, device=t.device)
    aux = torch.empty(6, dtype=torch.int32, device=t.device)
    _launch(name, t, t.data_ptr(), m.data_ptr(), scratch.data_ptr(),
            active.data_ptr(), nbrs_flat.data_ptr(), wl.data_ptr(),
            aux.data_ptr(), aux.shape[0], v, nbrs_flat.shape[0] // v, *tail)
    return aux


# ---------------------------------------------------------------------------
# the hybrid layout's fixed point in one launch
# ---------------------------------------------------------------------------

def _check_hybrid(t, m, active, slabs, spill, b: int, priority: str,
                  max_iters: int) -> None:
    """Validate the hybrid fixed point's arguments: device, dtype, 1-D and
    contiguity of every tensor, each slab's ids a whole number of rows,
    the spill's seg and cols of one length."""
    named = {"t": t, "m": m, "active": active}
    for i, (rows, nbrs) in enumerate(slabs):
        named[f"slab {i} rows"] = rows
        named[f"slab {i} nbrs"] = nbrs
        if rows.shape[0] == 0 or nbrs.shape[0] % rows.shape[0]:
            raise ValueError(f"slab {i}: {nbrs.shape[0]} ids are not a "
                             f"whole number of its {rows.shape[0]} rows")
    for name, x in zip(("spill_rows", "spill_seg", "spill_cols"), spill):
        named[name] = x
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, x in named.items():
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, t on {dev}")
        want = torch.bool if name == "active" else torch.int32
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if not x.is_contiguous() or x.dim() != 1:
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    v = t.shape[0]
    for name in ("m", "active"):
        if named[name] is not None and named[name].shape[0] != v:
            raise ValueError(f"{name} has {named[name].shape[0]} rows, t "
                             f"has {v}")
    if spill[1].shape != spill[2].shape:
        raise ValueError("spill_seg and spill_cols differ in length")
    if not 0 < b < 32:
        raise ValueError(f"id bits b={b} out of range")
    if priority not in PRIORITY_CODES:
        raise ValueError(f"unknown priority {priority!r}")
    _check_iters(max_iters)


_SLAB_TABLES: dict = {}


def _slab_table(slabs, device) -> torch.Tensor:
    """The hybrid kernel's ``[S, 7]`` int64 slab table on the card (the
    kernel's ``HybridSlab``): each slab's rows and ids pointers, R, D, its
    passes' group shape and the offset of its list buffers.  A pure
    function of the slabs' pointers and shapes, so it is built and copied
    once per layout and kept, keyed by them."""
    key = (str(device),) + tuple((rows.data_ptr(), nbrs.data_ptr(),
                                  rows.shape[0], nbrs.shape[0])
                                 for rows, nbrs in slabs)
    table = _SLAB_TABLES.get(key)
    if table is None:
        words, offset = [], 0
        for rows, nbrs in slabs:
            r = rows.shape[0]
            d = nbrs.shape[0] // r
            shape = _entry("hybrid_slab_shape")(d, r)
            words += [rows.data_ptr(), nbrs.data_ptr(), r, d, shape >> 8,
                      shape & 0xFF, offset]
            offset += 4 * r
        table = torch.tensor(words, dtype=torch.int64).to(device)
        if len(_SLAB_TABLES) >= 64:
            _SLAB_TABLES.pop(next(iter(_SLAB_TABLES)))
        _SLAB_TABLES[key] = table
    return table


def hybrid_fixed_point(t, m, active, slabs, spill, *, priority: str, b: int,
                       max_iters: int):
    """The §V-B fixed point over the hybrid layout, as
    ``ref.hybrid_fixed_point_ref`` defines it (the reference's
    ``_hybrid_fixed_point``).  ``t``, ``m``: int32 ``[V]``, written (T and
    M at the end; nothing in them is read); ``active``: bool ``[V]``, or
    None for every vertex (then a neighbour is active where its M is not
    IN, one gather a slot); ``slabs``: ``(rows int32 [R], ids int32
    [R*D])`` per slab; ``spill``: ``(rows int32 [H], seg int32 [E], cols
    int32 [E])``.  Returns ``(t, int32 [2], int64 [S])``: the rounds run
    and the last live count, and each slab's live list rows processed
    (both passes, every round), on t's device.

    On the card one cooperative launch runs every round, the spill's
    segment reductions inside it, and reads no value from the host; the
    worklists, their counts and the spill's scratch live in buffers
    allocated here.  It raises (``KernelLaunchError``) where the card has
    no cooperative launch or the launch is refused: there is no per-round
    fallback."""
    _check_hybrid(t, m, active, slabs, spill, b, priority, max_iters)
    if t.device.type == "cpu":
        return ref.hybrid_fixed_point_ref(t, m, active, slabs, spill,
                                          priority=priority, b=b,
                                          max_iters=max_iters)
    return _hybrid_on_card(t, m, active, slabs, spill, priority, b,
                           max_iters, card_sms(t.device))


def _hybrid_on_card(t, m, active, slabs, spill, priority: str, b: int,
                    max_iters: int, sms: int):
    dev = t.device
    ns = len(slabs)
    table = _slab_table(slabs, dev)
    lists = torch.empty(4 * sum(rows.shape[0] for rows, _ in slabs),
                        dtype=torch.int32, device=dev)
    h, e = spill[0].shape[0], spill[2].shape[0]
    scratch = torch.empty(3 * max(h, 1), dtype=torch.int32, device=dev)
    aux = torch.empty(4 + 6 * ns + 2 * ns * MAX_BLOCKS_PER_SM * sms,
                      dtype=torch.int32, device=dev)
    acc = torch.empty(max(ns, 1), dtype=torch.int64, device=dev)
    _launch("hybrid_fixed_point", t, t.data_ptr(), m.data_ptr(),
            None if active is None else active.data_ptr(), table.data_ptr(),
            ns, lists.data_ptr(), *(x.data_ptr() for x in spill), h, e,
            scratch.data_ptr(), aux.data_ptr(), aux.shape[0], acc.data_ptr(),
            t.shape[0], b, PRIORITY_CODES[priority], max_iters)
    return t, aux[:2], acc[:ns]


# ---------------------------------------------------------------------------
# hybrid layout: one slab per call (slab-local worklists, sentinel R), and
# the heavy rows of the COO spill
# ---------------------------------------------------------------------------

def sliced_refresh_columns(t, m, slab_rows, nbrs_flat, wl, count, it, *,
                           priority: str, b: int) -> torch.Tensor:
    """M[slab_rows[wl[i]]] <- min over the slab row's ids of the refreshed
    T, with IN -> OUT, for every live slot ``i < count`` (in place; returns
    ``m``).

    ``t``, ``m``: int32 [V]; ``slab_rows``: int32 [R] global ids;
    ``nbrs_flat``: int32 [R*W] global neighbour ids, self-padded;
    ``wl``: int32 slab-local rows (sentinel R); ``count``, ``it``: int32
    [1] on the same device.
    """
    _, r, d = _check_args(t, nbrs_flat, wl, count, it, {"m": m}, b,
                          priority, slab_rows)
    if t.device.type == "cpu":
        return ref.sliced_refresh_columns_ref(
            t, m, slab_rows, nbrs_flat, wl, count, it, priority=priority, b=b)
    _launch("sliced_refresh_columns", t, t.data_ptr(), m.data_ptr(),
            slab_rows.data_ptr(), nbrs_flat.data_ptr(), wl.data_ptr(),
            count.data_ptr(), it.data_ptr(), r, wl.shape[0], d, b,
            PRIORITY_CODES[priority])
    return m


def sliced_decide(t, m, active, slab_rows, nbrs_flat, wl, count, it, *,
                  priority: str, b: int) -> torch.Tensor:
    """The decide of :func:`fused_decide` for the live slots of one slab:
    the global row ``slab_rows[wl[i]]`` keys the T read, the refresh and
    the write (in place; returns ``t``).  ``active``: bool [V], or None:
    then a neighbour is active where its M is not IN, and the kernel makes
    one gather a slot, not two (the hybrid loop's M never holds IN); the
    rest as :func:`sliced_refresh_columns`."""
    _, r, d = _check_args(t, nbrs_flat, wl, count, it,
                          {"m": m, "active": active}, b, priority, slab_rows)
    if t.device.type == "cpu":
        return ref.sliced_decide_ref(t, m, active, slab_rows, nbrs_flat, wl,
                                     count, it, priority=priority, b=b)
    _launch("sliced_decide", t, t.data_ptr(), m.data_ptr(),
            None if active is None else active.data_ptr(),
            slab_rows.data_ptr(), nbrs_flat.data_ptr(), wl.data_ptr(),
            count.data_ptr(), it.data_ptr(), r, wl.shape[0], d, b,
            PRIORITY_CODES[priority])
    return t


# ---------------------------------------------------------------------------
# the host-driven round (engine cuda_compacted): pre-gathered rows
# ---------------------------------------------------------------------------

def _check_rows(wl_neighbors, count: int, **vectors) -> tuple[int, int]:
    """Validate the unfused kernels' inputs; returns (W, D)."""
    dev = wl_neighbors.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, x in {"wl_neighbors": wl_neighbors, **vectors}.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, wl_neighbors on "
                             f"{dev}")
        want = torch.bool if name == "active" else torch.int32
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dim() != (2 if name == "wl_neighbors" else 1):
            raise ValueError(f"{name} has shape {tuple(x.shape)}")
    w, d = wl_neighbors.shape
    if w == 0 or d == 0:
        raise ValueError(f"wl_neighbors is empty: {tuple(wl_neighbors.shape)}")
    if "t_rows" in vectors and vectors["t_rows"].shape[0] != w:
        raise ValueError(f"t_rows has {vectors['t_rows'].shape[0]} rows, "
                         f"wl_neighbors {w}")
    if "active" in vectors and vectors["active"].shape != vectors["m"].shape:
        raise ValueError("active and m differ in length")
    if count < 0:
        raise ValueError(f"count={count} is negative")
    return w, d


def refresh_columns_rows(t, wl_neighbors, count: int) -> torch.Tensor:
    """M of each pre-gathered worklist row (int32 [W]): the min of T over
    the row's ids with IN -> OUT; OUT at slots ``>= count``.

    ``t``: int32 [V] (uint32 bit patterns); ``wl_neighbors``: int32
    [W, D] ids in ``[0, V)``; ``count``: the live slots, a host int."""
    w, d = _check_rows(wl_neighbors, count, t=t)
    if t.device.type == "cpu":
        return ref.refresh_columns_ref(t, wl_neighbors, count)
    out = torch.empty(w, dtype=torch.int32, device=t.device)
    _launch("refresh_columns", t, t.data_ptr(), wl_neighbors.data_ptr(),
            out.data_ptr(), w, d, count)
    return out


def decide_rows(t_rows, m, active, wl_neighbors, count: int) -> torch.Tensor:
    """New T of each pre-gathered worklist row (int32 [W]): OUT if an
    active neighbour's M is OUT, else IN if every active neighbour's M
    equals the row's tuple, else the tuple; decided rows and slots
    ``>= count`` keep theirs.  ``t_rows``: int32 [W]; ``m``: int32 [V];
    ``active``: bool [V]; the rest as :func:`refresh_columns_rows`."""
    w, d = _check_rows(wl_neighbors, count, t_rows=t_rows, m=m,
                       active=active)
    if m.device.type == "cpu":
        return ref.decide_ref(t_rows, m, active, wl_neighbors, count)
    out = torch.empty(w, dtype=torch.int32, device=m.device)
    _launch("decide", m, t_rows.data_ptr(), m.data_ptr(), active.data_ptr(),
            wl_neighbors.data_ptr(), out.data_ptr(), w, d, count)
    return out


def _clamped(wl, v: int) -> torch.Tensor:
    return wl.to(torch.int64).clamp(0, v - 1)


def refresh_columns(t, m, wl2, neighbors, count: int) -> torch.Tensor:
    """``m.at[wl2].set(M of the wl2 rows, mode="drop")`` (a new tensor):
    the rows gathered from the ELL ``neighbors`` [V, D] in plain torch, the
    min in the kernel.  ``wl2``: int32 [W], sentinel ``V`` past ``count``."""
    rows = neighbors[_clamped(wl2, neighbors.shape[0])]
    return set_drop(m, wl2, refresh_columns_rows(t, rows, count))


def decide(t, m, wl1, neighbors, active, count: int) -> torch.Tensor:
    """``t.at[wl1].set(the decision of the wl1 rows, mode="drop")`` (a new
    tensor): the rows and their tuples gathered in plain torch, the
    decision in the kernel."""
    rows = _clamped(wl1, neighbors.shape[0])
    newt = decide_rows(t[rows], m, active, neighbors[rows], count)
    return set_drop(t, wl1, newt)

