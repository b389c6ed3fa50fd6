"""Wrappers for the Luby coloring kernel: the reference's round loop in one
launch, over the padded ELL (``luby_fixed_point``), over the hybrid layout
(``luby_fixed_point_hybrid``: its slabs and its COO spill) or over a bucket
of graphs laid end to end (``luby_fixed_point_batched``).

A tensor on the CPU goes to the plain-torch twin (``ref``); a tensor on a
CUDA device goes to the hand-written kernel (``csrc/luby.cu``), or the call
raises — there is no fallback from one to the other.  ``LAUNCHES`` counts
kernel launches (twin calls are not counted).
"""
from __future__ import annotations

import ctypes

import torch

from ...core.tuples import id_bits
from .. import _build
from . import ref

LAUNCHES = {"luby_fixed_point": 0, "luby_fixed_point_batched": 0}

_SIGNATURES = {
    "luby_fixed_point": (ctypes.c_void_p, ctypes.c_int) + (
        ctypes.c_void_p,) * 4 + (ctypes.c_int64, ctypes.c_int64) + (
        ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p),
    "luby_fixed_point_batched": (ctypes.c_void_p,) * 4 + (
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p),
    "luby_lanes": (ctypes.c_int, ctypes.c_int64),
}
_MAP_TABLES: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry(name: str):
    return _build.function("luby", name, _SIGNATURES[name])


def _check(named: dict, dev) -> None:
    """Device, dtype (int32, bool for a mask) and contiguity."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        want = torch.bool if name.endswith("mask") else torch.int32
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_rounds(max_rounds: int) -> None:
    if max_rounds < 0:
        raise ValueError(f"max_rounds={max_rounds} is negative")


def luby_fixed_point(neighbors, mask, *, max_rounds: int):
    """The reference's ``_color_fixed_point`` over the padded ELL
    ``neighbors`` (int32 ``[V, D]``) and ``mask`` (bool ``[V, D]``).
    Returns ``(colors int32 [V], rounds int32 [1])`` on their device; a
    vertex left uncolored holds -1 (or -95 where all 64 colors were
    forbidden, as the reference's).

    On the card one cooperative launch runs every round and reads no value
    from the host; it raises (``KernelLaunchError``) where the launch is
    refused: there is no per-round fallback."""
    dev = neighbors.device
    _check({"neighbors": neighbors, "mask": mask}, dev)
    if neighbors.dim() != 2 or mask.shape != neighbors.shape:
        raise ValueError(f"neighbors {tuple(neighbors.shape)} and mask "
                         f"{tuple(mask.shape)} must be one [V, D] shape")
    _check_rounds(max_rounds)
    if dev.type == "cpu":
        return ref.luby_fixed_point_ref(neighbors, mask,
                                        max_rounds=max_rounds)
    v = neighbors.shape[0]
    maps = [(None, neighbors.reshape(-1), mask.reshape(-1), v,
             neighbors.shape[1])]
    return _luby_on_card(maps, _empty_spill(dev), v, max_rounds)


def luby_fixed_point_hybrid(slabs, spill, v: int, *, max_rounds: int):
    """The reference's ``_color_fixed_point_hybrid`` over the hybrid layout
    of ``v`` vertices: ``slabs`` ``(rows int32 [R], neighbors int32 [R, W],
    mask bool [R, W])`` each, ``spill`` ``(rows int32 [H], seg int32 [E],
    cols int32 [E])``.  Returns as :func:`luby_fixed_point`; on the card
    one cooperative launch, the spill's segment reductions inside it."""
    dev = spill[0].device
    named = {f"spill {k}": x for k, x in zip(("rows", "seg", "cols"), spill)}
    for i, (rows, nbrs, mask) in enumerate(slabs):
        named.update({f"slab {i} rows": rows, f"slab {i} neighbors": nbrs,
                      f"slab {i} mask": mask})
        if nbrs.dim() != 2 or mask.shape != nbrs.shape \
                or rows.shape[0] != nbrs.shape[0]:
            raise ValueError(f"slab {i}: rows {tuple(rows.shape)}, neighbors "
                             f"{tuple(nbrs.shape)} and mask "
                             f"{tuple(mask.shape)} disagree")
    _check(named, dev)
    if spill[1].shape != spill[2].shape:
        raise ValueError("spill seg and cols differ in length")
    _check_rounds(max_rounds)
    if dev.type == "cpu":
        return ref.luby_fixed_point_hybrid_ref(slabs, spill, v,
                                               max_rounds=max_rounds)
    maps = [(rows, nbrs.reshape(-1), mask.reshape(-1), rows.shape[0],
             nbrs.shape[1]) for rows, nbrs, mask in slabs]
    return _luby_on_card(maps, spill, v, max_rounds)


def luby_fixed_point_batched(neighbors, mask, row_valid, bits, rows: int,
                             *, max_rounds: int):
    """The reference's batched coloring loop (``_color_batch_impl``'s
    rounds of the vmapped ``_color_round_masked``, the round shared) over a
    bucket of ``B`` graphs laid end to end, ``rows`` (a power of two) each:
    ``neighbors`` (int32 ``[B * rows, W]``) the block-diagonal ELL,
    ``mask`` (bool, the same shape), ``row_valid`` (bool ``[B * rows]``)
    the real rows, ``bits`` (int32 ``[B]``) the members' id bits (not read
    back here).  Padded rows enter colored 0.  Returns ``(colors int32 [B *
    rows], done_round int32 [B], rounds int32 [1])``: ``done_round[j]`` the
    round after which member ``j`` had every real row colored, -1 if it
    never had; the loop runs round 0, then on while a real row is
    uncolored and fewer than ``max_rounds`` rounds ran.

    On the card one cooperative launch, as :func:`luby_fixed_point`."""
    dev = neighbors.device
    _check({"neighbors": neighbors, "mask": mask, "row_valid mask": row_valid,
            "bits": bits}, dev)
    n = neighbors.shape[0]
    if neighbors.dim() != 2 or mask.shape != neighbors.shape \
            or row_valid.shape != (n,):
        raise ValueError(f"neighbors {tuple(neighbors.shape)}, mask "
                         f"{tuple(mask.shape)} and row_valid "
                         f"{tuple(row_valid.shape)} disagree")
    if rows < 1 or rows & (rows - 1) or bits.dim() != 1 \
            or n != bits.shape[0] * rows:
        raise ValueError(f"{n} rows are not {tuple(bits.shape)} members of "
                         f"{rows} rows (a power of two)")
    _check_rounds(max_rounds)
    if dev.type == "cpu":
        return ref.luby_fixed_point_batched_ref(
            neighbors, mask, row_valid, bits, rows, max_rounds=max_rounds)
    return _luby_batched_on_card(neighbors, mask, row_valid, bits, rows,
                                 max_rounds)


def _luby_batched_on_card(neighbors, mask, row_valid, bits, rows: int,
                          max_rounds: int):
    """One launch over a bucket's one row map, no spill."""
    dev = neighbors.device
    n = neighbors.shape[0]
    table = _map_table([(None, neighbors.reshape(-1), mask.reshape(-1), n,
                         neighbors.shape[1])], dev)
    lists = torch.empty(2 * n, dtype=torch.int32, device=dev)
    colors = torch.empty(2 * n, dtype=torch.int32, device=dev)
    done = torch.empty(bits.shape[0], dtype=torch.int32, device=dev)
    aux = torch.empty(7, dtype=torch.int32, device=dev)
    _launch(dev, "luby_fixed_point_batched", table.data_ptr(),
            lists.data_ptr(), colors.data_ptr(), aux.data_ptr(), aux.shape[0],
            n, bits.data_ptr(), rows.bit_length() - 1, row_valid.data_ptr(),
            done.data_ptr(), bits.shape[0], max_rounds)
    return colors[:n], done, aux[:1]


def _empty_spill(dev):
    none = torch.empty(0, dtype=torch.int32, device=dev)
    return none, none, none


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _map_table(maps, dev) -> torch.Tensor:
    """The kernel's ``[S, 7]`` int64 table on the card (``LubyMap``): each
    map's rows, ids and mask pointers, R, D, its G lanes a row and the
    offset of its list buffers.  A pure function of the maps' pointers and
    shapes, so it is built and copied once per layout and kept, keyed by
    them."""
    key = (str(dev),) + tuple((_ptr(rows), _ptr(nbrs), _ptr(mask), r, d)
                               for rows, nbrs, mask, r, d in maps)
    table = _MAP_TABLES.get(key)
    if table is None:
        words, offset = [], 0
        for rows, nbrs, mask, r, d in maps:
            words += [_ptr(rows), _ptr(nbrs), _ptr(mask), r, d,
                      _entry("luby_lanes")(d, r), offset]
            offset += 2 * r
        table = torch.tensor(words, dtype=torch.int64).to(dev)
        if len(_MAP_TABLES) >= 64:
            _MAP_TABLES.pop(next(iter(_MAP_TABLES)))
        _MAP_TABLES[key] = table
    return table


def _launch(dev, name: str, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _entry(name)(*args, stream)
    _build.check(status, name)
    LAUNCHES[name] += 1


def _luby_on_card(maps, spill, v: int, max_rounds: int):
    """One launch over the row maps ``(rows or None, ids [R*D], mask
    [R*D], R, D)`` and the spill."""
    dev = spill[0].device
    table = _map_table(maps, dev)
    lists = torch.empty(max(2 * sum(m[3] for m in maps), 1),
                        dtype=torch.int32, device=dev)
    h, e = spill[0].shape[0], spill[2].shape[0]
    colors = torch.empty(2 * max(v, 1), dtype=torch.int32, device=dev)
    heavy = torch.empty(3 * max(h, 1), dtype=torch.int32, device=dev)
    aux = torch.empty(4 + 3 * len(maps), dtype=torch.int32, device=dev)
    _launch(dev, "luby_fixed_point", table.data_ptr(), len(maps),
            lists.data_ptr(),
            *(x.data_ptr() for x in spill), h, e, colors.data_ptr(),
            heavy.data_ptr(), aux.data_ptr(), aux.shape[0], v, id_bits(v),
            max_rounds)
    return colors[:v], aux[:1]
