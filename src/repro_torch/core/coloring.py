"""Deterministic parallel greedy distance-1 coloring, PyTorch port of
``repro.core.coloring`` (the monolithic ``luby`` engine).

Used by cluster multicolor Gauss-Seidel to color the coarse graph, and by
point multicolor GS to color the fine graph.  Luby-style rounds with the
same xorshift* packed priorities as MIS-2: in each round, every uncolored
vertex whose priority is below that of every uncolored real neighbor picks
its smallest color not taken by a colored neighbor (64-color forbidden
mask).  The round's priorities come from the hash-pack kernel
(``kernels.hash_priority.ops.round_priorities``: the ids 0..V-1 hashed,
packed and widened in one launch) with the round number on the device; the
rowwise round is plain torch over the ELL adjacency.  The loop reads one
flag per round on the host to decide whether to go on (``host_syncs``).
``luby_hybrid`` runs the same rounds over the degree-aware hybrid layout
(slab rows as above, the spill's heavy rows by segment reductions).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graphs.handle import as_graph
from ..kernels.hash_priority import ops as hash_ops
from ..kernels.minprop_ell.ops import segment_reduce
from .mis2 import record_loop
from .tuples import U32_MASK, id_bits

MAX_COLORS = 64
MAX_ROUNDS_DEFAULT = 256


@dataclass
class ColoringResult:
    colors: np.ndarray      # int32 [V]; uncolored (unconverged) hold -1
    num_colors: int
    rounds: int
    converged: bool = True  # every vertex colored within the round limit
    host_syncs: int = 0


def _lowest_set_bit(x: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of widened uint32 words (int64), through
    the reference's float32 exponent: -127 where ``x == 0``."""
    isolated = (x & -x).to(torch.float32)        # an exact power of two
    return (isolated.view(torch.int32) >> 23).to(torch.int64) - 127


def _smallest_free_color(forb_lo: torch.Tensor,
                         forb_hi: torch.Tensor) -> torch.Tensor:
    """Smallest color whose bit is clear in the 64-bit forbidden mask."""
    free_lo = ~forb_lo & U32_MASK
    free_hi = ~forb_hi & U32_MASK
    low_idx = _lowest_set_bit(free_lo)
    high_idx = _lowest_set_bit(free_hi) + 32
    return torch.where(free_lo != 0, low_idx, high_idx).to(torch.int32)


def _round_priorities(v: int, rnd: torch.Tensor, b: int) -> torch.Tensor:
    """Round ``rnd``'s packed priority of each of the ``v`` vertices,
    widened: one launch of the hash-pack kernel, no ids read."""
    return hash_ops.round_priorities(v, rnd, b)


def _color_round_rows(neighbors, mask, row_ids, colors, prio):
    """One Luby round over the rows ``row_ids`` of a ``[V]`` coloring:
    ``colors`` int32 and ``prio`` widened int64, both ``[V]``."""
    nb = neighbors.to(torch.int64)
    own = colors[row_ids]
    real = mask & (neighbors != row_ids[:, None])
    pn = prio[nb]
    contender = real & (colors[nb] < 0)
    is_min = torch.where(contender, prio[row_ids][:, None] < pn,
                         True).all(dim=1)
    # forbidden colors bitmask (two 32-bit words -> up to 64 colors)
    cn = colors[nb].to(torch.int64)
    has = real & (cn >= 0)
    lo_bits = torch.where(has & (cn < 32), 1 << cn.clamp(0, 31), 0)
    hi_bits = torch.where(has & (cn >= 32), 1 << (cn - 32).clamp(0, 31), 0)
    forb_lo = torch.zeros_like(own, dtype=torch.int64)   # ELL width may be 0
    forb_hi = torch.zeros_like(forb_lo)
    for j in range(nb.shape[1]):           # torch has no OR reduction
        forb_lo = forb_lo | lo_bits[:, j]
        forb_hi = forb_hi | hi_bits[:, j]
    chosen = _smallest_free_color(forb_lo, forb_hi)
    return torch.where((own < 0) & is_min, chosen, own)


def _luby_loop(v: int, dev, max_rounds: int, round_fn):
    """The Luby round loop with the reference's do-while shape (at least
    one round); ``round_fn(colors, prio)`` is one round over every row.
    Returns ``(colors int32 [V], rounds, host_syncs)``."""
    b = id_bits(v)
    colors = torch.full((v,), -1, dtype=torch.int32, device=dev)
    rnd_dev = torch.zeros(1, dtype=torch.int32, device=dev)
    rnd = syncs = 0
    while True:
        if rnd > 0:
            if rnd >= max_rounds:
                break
            syncs += 1
            if not bool((colors < 0).any()):    # the one host read a round
                break
        colors = round_fn(colors, _round_priorities(v, rnd_dev, b))
        rnd_dev += 1
        rnd += 1
    record_loop(syncs)
    return colors, rnd, syncs


def color_fixed_point(neighbors: torch.Tensor, mask: torch.Tensor,
                      max_rounds: int):
    """The Luby round loop over the padded ELL.  Returns ``(colors int32
    [V], rounds, host_syncs)``."""
    v = neighbors.shape[0]
    vids = torch.arange(v, dtype=torch.int32, device=neighbors.device)
    return _luby_loop(v, neighbors.device, max_rounds,
                      lambda colors, prio: _color_round_rows(
                          neighbors, mask, vids, colors, prio))


def color_batched_fixed_point(neighbors: torch.Tensor, mask: torch.Tensor,
                              row_valid: torch.Tensor, bits: torch.Tensor,
                              rows: int, max_rounds: int):
    """The Luby round loop over a bucket of ``B`` graphs at once: the
    reference's ``_color_round_masked`` vmapped over a ``[B, rows, width]``
    stack with the round number shared (``in_axes=(0, 0, 0, None, 0)``).

    ``neighbors`` (int64 ``[B * rows, width]``) is the bucket as one
    block-diagonal graph, as :func:`~repro_torch.core.mis2.
    mis2_dense_batched_fixed_point` takes it, so each round is
    :func:`_color_round_rows` over every row, with the priorities of one
    launch of the batched hash-pack kernel (each member's local ids and its
    own ``bits``, int32 ``[B]`` on the device).  Padded rows
    (``row_valid`` False) enter pre-colored 0: never contenders, nobody's
    neighbor.  One ``[B]`` finished flag comes to the host a round, not the
    colors.  Returns ``(colors int32 [B * rows], done_round [B] (the round
    after which each member had every vertex colored, -1 if none), rounds,
    host_syncs)``.
    """
    n, dev = neighbors.shape[0], neighbors.device
    vids = torch.arange(n, device=dev)
    colors = torch.where(row_valid, -1, 0).to(torch.int32)
    done_round = np.full(n // rows, -1, dtype=np.int64)
    rnd_dev = torch.zeros(1, dtype=torch.int32, device=dev)
    rnd = syncs = 0
    while True:
        prio = hash_ops.round_priorities_batched(rows, rnd_dev, bits)
        colors = _color_round_rows(neighbors, mask, vids, colors, prio)
        rnd_dev += 1
        rnd += 1
        finished = ((colors >= 0) | ~row_valid).view(-1, rows).all(dim=1)
        finished = finished.cpu().numpy()     # the one host read a round
        syncs += 1
        done_round[(done_round < 0) & finished] = rnd
        if finished.all() or rnd >= max_rounds:
            break
    record_loop(syncs)
    return colors, done_round, rnd, syncs


def _spill_color_round(spill_rows, spill_seg, spill_cols, colors, prio):
    """One Luby round over the heavy rows of the COO spill, equal to
    :func:`_color_round_rows` on the same rows: ``all(own < pn)`` over the
    contenders is ``own < segment min(pn)``, the segment holding 2**32 - 1
    where there is no contender (a packed priority never equals it: its
    low ``b`` bits are ``id + 1 <= V < 2**b - 1``), and the forbidden-color
    OR is a ``[H*64]`` one-hot ``amax`` scatter summed against distinct
    powers of two (sum == OR for distinct bits)."""
    h = spill_rows.shape[0]
    rows = spill_rows.to(torch.int64)
    cols = spill_cols.to(torch.int64)
    seg = spill_seg.to(torch.int64)
    own = colors[rows]
    cn = colors[cols].to(torch.int64)
    pn = prio[cols]
    real = cols != rows[seg]
    contender = real & (cn < 0)
    min_pn = segment_reduce(torch.where(contender, pn, U32_MASK), seg, h,
                            "amin", U32_MASK)
    is_min = prio[rows] < min_pn
    has = real & (cn >= 0)
    onehot = segment_reduce(has.to(torch.int64),
                            seg * MAX_COLORS + cn.clamp(0, MAX_COLORS - 1),
                            h * MAX_COLORS, "amax", 0).view(h, MAX_COLORS)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=colors.device)
    forb_lo = (onehot[:, :32] * weights).sum(dim=1)
    forb_hi = (onehot[:, 32:] * weights).sum(dim=1)
    chosen = _smallest_free_color(forb_lo, forb_hi)
    return torch.where((own < 0) & is_min, chosen, own)


def color_fixed_point_hybrid(hyb, max_rounds: int):
    """The Luby round loop over the hybrid layout: each round runs
    :func:`_color_round_rows` on every slab and :func:`_spill_color_round`
    on the spill, all reading the round-start colors and writing a fresh
    buffer (the slabs and the spill partition the rows), so every round is
    the monolithic round evaluated piecewise.  Returns ``(colors int32
    [V], rounds, host_syncs)``."""
    slabs = [(sl.neighbors, sl.mask, sl.rows, sl.rows.to(torch.int64))
             for sl in hyb.slices]
    spill_rows = hyb.spill_rows.to(torch.int64)

    def round_fn(colors, prio):
        new = colors.clone()
        for nbrs, mask, rows, rows64 in slabs:
            new[rows64] = _color_round_rows(nbrs, mask, rows, colors, prio)
        if hyb.num_spill_rows:
            new[spill_rows] = _spill_color_round(
                hyb.spill_rows, hyb.spill_seg, hyb.spill_cols, colors, prio)
        return new

    return _luby_loop(hyb.num_vertices, hyb.spill_rows.device, max_rounds,
                      round_fn)


def _coloring_result(c: np.ndarray, rounds: int,
                     syncs: int) -> ColoringResult:
    num = int(c.max()) + 1 if (c >= 0).any() else 0
    if num > MAX_COLORS:
        raise RuntimeError(f"{num} colors exceed MAX_COLORS={MAX_COLORS}")
    # hitting max_rounds is reported, not raised: callers get the partial
    # coloring (uncolored vertices = -1) with converged=False
    return ColoringResult(c, num, rounds, not (c < 0).any(), syncs)


def _color_graph_impl(graph,
                      max_rounds: int = MAX_ROUNDS_DEFAULT) -> ColoringResult:
    ell = as_graph(graph).ell
    colors, rounds, syncs = color_fixed_point(ell.neighbors, ell.mask,
                                              max_rounds)
    return _coloring_result(colors.cpu().numpy(), rounds, syncs)


def _color_hybrid_impl(graph,
                       max_rounds: int = MAX_ROUNDS_DEFAULT) -> ColoringResult:
    """Luby coloring over the hybrid layout (the ``luby_hybrid`` engine):
    never builds ``graph.ell``; colors equal the ``luby`` engine's."""
    colors, rounds, syncs = color_fixed_point_hybrid(as_graph(graph).hybrid(),
                                                     max_rounds)
    return _coloring_result(colors.cpu().numpy(), rounds, syncs)


def check_coloring(graph, colors: np.ndarray) -> bool:
    """Validity: no two adjacent distinct vertices share a color."""
    csr = as_graph(graph).csr
    rows = np.repeat(np.arange(csr.num_vertices), np.diff(csr.indptr))
    colors = np.asarray(colors)
    real = rows != csr.indices
    return not (real & (colors[rows] == colors[csr.indices])).any()
