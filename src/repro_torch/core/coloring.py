"""Deterministic parallel greedy distance-1 coloring, PyTorch port of
``repro.core.coloring`` (the monolithic ``luby`` engine).

Used by cluster multicolor Gauss-Seidel to color the coarse graph, and by
point multicolor GS to color the fine graph.  Luby-style rounds with the
same xorshift* packed priorities as MIS-2: in each round, every uncolored
vertex whose priority is below that of every uncolored real neighbor picks
its smallest color not taken by a colored neighbor (64-color forbidden
mask).  The reference's jitted round loop is one call of
``kernels.luby.ops.luby_fixed_point``: on the card one cooperative launch
of a persistent kernel that hashes the round's priorities itself and reads
nothing from the host until the loop ends (``host_syncs`` 0); on the CPU
its plain-torch twin, which reads one flag a round.  ``luby_hybrid`` runs
the same rounds over the degree-aware hybrid layout
(``luby_fixed_point_hybrid``: slab rows as above, the spill's heavy rows
by segment reductions), and the batched coloring over a bucket of graphs
(``luby_fixed_point_batched``), each one launch on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graphs.handle import as_graph
from ..kernels.luby import ops as luby_ops
from .mis2 import record_loop

MAX_COLORS = 64
MAX_ROUNDS_DEFAULT = 256


@dataclass
class ColoringResult:
    colors: np.ndarray      # int32 [V]; uncolored (unconverged) hold -1
    num_colors: int
    rounds: int
    converged: bool = True  # every vertex colored within the round limit
    host_syncs: int = 0


def _loop_result(colors, stats, max_rounds: int):
    """``(colors, rounds, host_syncs)`` of one Luby loop call: the rounds
    read once, after the loop; the host syncs inside it 0 on the card and,
    on the CPU, the twin's reads (one a round past the first, none where the
    round cap stopped it)."""
    rounds = int(stats.item())
    if colors.device.type == "cuda":
        syncs = 0
    else:
        syncs = rounds if rounds < max_rounds else rounds - 1
    record_loop(syncs)
    return colors, rounds, syncs


def color_fixed_point(neighbors: torch.Tensor, mask: torch.Tensor,
                      max_rounds: int):
    """The Luby round loop over the padded ELL, one call of
    ``luby_ops.luby_fixed_point``.  Returns ``(colors int32 [V], rounds,
    host_syncs)``."""
    colors, stats = luby_ops.luby_fixed_point(neighbors, mask,
                                              max_rounds=max_rounds)
    return _loop_result(colors, stats, max_rounds)


def color_batched_fixed_point(neighbors: torch.Tensor, mask: torch.Tensor,
                              row_valid: torch.Tensor, bits: torch.Tensor,
                              rows: int, max_rounds: int):
    """The Luby round loop over a bucket of ``B`` graphs at once: the
    reference's ``_color_round_masked`` vmapped over a ``[B, rows, width]``
    stack with the round number shared (``in_axes=(0, 0, 0, None, 0)``),
    one call of ``luby_ops.luby_fixed_point_batched``.

    ``neighbors`` (int32 ``[B * rows, width]``) is the bucket as one
    block-diagonal graph (:attr:`~repro_torch.batch.GraphBucket.
    flat_neighbors32`); each row hashes its local id with its member's own
    ``bits`` (int32 ``[B]`` on the device).  Padded rows (``row_valid``
    False) enter pre-colored 0: never contenders, nobody's neighbor.  On
    the card nothing comes to the host until the loop ends; on the CPU the
    twin reads one finished flag a round.  Returns ``(colors int32 [B *
    rows], done_round int64 [B] (the round after which each member had
    every vertex colored, -1 if none), rounds, host_syncs)``.
    """
    colors, done, stats = luby_ops.luby_fixed_point_batched(
        neighbors, mask, row_valid, bits, rows, max_rounds=max_rounds)
    colors, rounds, syncs = _loop_result(colors, stats, max_rounds)
    return colors, done.cpu().numpy().astype(np.int64), rounds, syncs


def color_fixed_point_hybrid(hyb, max_rounds: int):
    """The Luby round loop over the hybrid layout, one call of
    ``luby_ops.luby_fixed_point_hybrid``: every round over every slab and
    the spill, all reading the round-start colors (the slabs and the spill
    partition the rows), so every round is the monolithic round evaluated
    piecewise.  Returns ``(colors int32 [V], rounds, host_syncs)``."""
    slabs = [(sl.rows, sl.neighbors, sl.mask) for sl in hyb.slices]
    colors, stats = luby_ops.luby_fixed_point_hybrid(
        slabs, (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols),
        hyb.num_vertices, max_rounds=max_rounds)
    return _loop_result(colors, stats, max_rounds)


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
