"""Batched drivers over :class:`~repro_torch.batch.GraphBatch` buckets (port
of ``repro.batch.pipeline``).

The reference vmaps its dense fixed points over each ``[B, rows, width]``
bucket.  Here each bucket runs as **one block-diagonal graph** of ``B *
rows`` rows (:attr:`GraphBucket.flat_neighbors`): member ``j``'s neighbor
ids are offset by ``j * rows``, padded slots and rows keep their own id, so
no row of one member reaches a row of another, and every neighbor-local
step is the single-graph row unchanged (the MIS-2 round, the Luby round,
the coarsening's label joins).  Only what is per graph is per member:

* each graph keeps its own packing bit width ``b = id_bits(V_real)`` and
  hashes its local ids (the batched forms of the resident MIS-2 and Luby
  kernels, ``ops.resident_fixed_point_batched`` and
  ``luby_ops.luby_fixed_point_batched``, take the members' bits);
* padded rows are inactive: MIS-2 pins them to OUT, the coloring
  pre-colors them, the joins never see them;
* a member's iteration counter advances only while that graph is live, so
  the §V-A priority stream matches the single-graph run even when bucket
  mates need more rounds;
* host-side label bookkeeping (singleton cleanup) runs per graph on the
  unpadded slice, exactly as the single-graph aggregation does.

Each fixed point of a bucket is one launch on the card with no host read
inside it (``host_syncs`` 0), as the reference runs it as one dispatch; on
the CPU the kernels' twins read one flag a round.  The coarsening's
cleanup and phase-3 loops are one launch each of the join kernels
(``kernels.joins``) over the bucket's block-diagonal ELL; its phase-1 and
phase-2 label joins are plain torch.  Every
per-graph result is bit-identical to the single-graph call's and to the
reference's batched call's.  The drivers return *core* result dataclasses
in batch input order; the facade (``repro_torch.api.facade``) wraps them
into Results and a ``BatchResult``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.aggregation import (
    AggregationResult,
    _aggregate_serial_greedy_impl,
    _finalize_singletons,
)
from ..core.coloring import (
    MAX_ROUNDS_DEFAULT,
    ColoringResult,
    _coloring_result,
    color_batched_fixed_point,
)
from ..core.mis2 import Mis2Options, Mis2Result, _active_mask, record_loop
from ..core.tuples import IN, is_undecided
from ..kernels.joins import ops as join_ops
from ..kernels.minprop_ell import ops
from ..kernels.joins.ref import INT32_MAX, count_unagg, join_rows
from .container import GraphBatch, GraphBucket


def _fixed_point(bucket: GraphBucket, active: torch.Tensor,
                 options: Mis2Options):
    """The bucket's batched MIS-2 fixed point, the reference's
    ``mis2_dense_fixed_point`` vmapped over the stack, as one call of
    ``ops.resident_fixed_point_batched`` over the block-diagonal ELL: on
    the card one launch that reads nothing from the host (``host_syncs``
    0), on the CPU its twin (a read a round).  A member's iterations count
    only the rounds it had an undecided active vertex, so its §V-A
    priority stream is the single-graph one.  Returns ``(T stored int32
    [B, rows], iterations int32 [B], host_syncs)``."""
    n = bucket.size * bucket.rows
    dev = bucket.neighbors.device
    t = torch.empty(n, dtype=torch.int32, device=dev)
    m = torch.empty(n, dtype=torch.int32, device=dev)
    t, stats, its = ops.resident_fixed_point_batched(
        t, m, active, bucket.flat_neighbors32.view(-1),
        priority=options.priority, bits=bucket.id_bits, rows=bucket.rows,
        max_iters=options.max_iters)
    syncs = 0 if dev.type == "cuda" else min(int(stats[0]) + 1,
                                             options.max_iters)
    record_loop(syncs)
    return t.view(bucket.size, bucket.rows), its, syncs


# ---------------------------------------------------------------------------
# MIS-2
# ---------------------------------------------------------------------------

def _bucket_actives(bucket: GraphBucket, actives) -> torch.Tensor:
    """The members' active masks as bool ``[B * rows]`` (False on
    padding); a member's None means all its vertices."""
    if actives is None:
        return bucket.row_valid.view(-1)
    dev = bucket.neighbors.device
    stacked = torch.zeros((bucket.size, bucket.rows), dtype=torch.bool,
                          device=dev)
    for j, gi in enumerate(bucket.indices):
        v = int(bucket.num_vertices[j])
        stacked[j, :v] = _active_mask(actives[gi], v, dev)
    return stacked.view(-1)


def _mis2_batch_impl(batch: GraphBatch, options: Mis2Options | None = None,
                     actives: Sequence | None = None) -> list[Mis2Result]:
    """Batched dense MIS-2; core Mis2Results in batch input order.  Each
    member's ``host_syncs`` is its bucket's: the reads its rounds shared."""
    options = Mis2Options() if options is None else options
    out: list = [None] * len(batch)
    for bucket in batch.buckets:
        act = _bucket_actives(bucket, actives)
        t, its, syncs = _fixed_point(bucket, act, options)
        in_set = (t == IN).cpu().numpy()
        undecided = (is_undecided(t) & act.view_as(t)).any(dim=1)
        undecided, its = undecided.cpu().numpy(), its.cpu().numpy()
        for j, gi in enumerate(bucket.indices):
            v = int(bucket.num_vertices[j])
            out[gi] = Mis2Result(in_set[j, :v], int(its[j]),
                                 not undecided[j], syncs)
    return out


# ---------------------------------------------------------------------------
# coloring
# ---------------------------------------------------------------------------

def _color_batch_impl(batch: GraphBatch,
                      max_rounds: int = MAX_ROUNDS_DEFAULT
                      ) -> list[ColoringResult]:
    """Batched Luby coloring; per-graph results equal ``_color_graph_impl``'s
    (a member's ``rounds`` is the round it finished in, or the bucket's
    round count if it did not)."""
    out: list = [None] * len(batch)
    for bucket in batch.buckets:
        colors, done_round, rounds, syncs = color_batched_fixed_point(
            bucket.flat_neighbors32, bucket.mask.view(-1, bucket.width),
            bucket.row_valid.view(-1), bucket.id_bits, bucket.rows,
            max_rounds)
        c = colors.view(bucket.size, bucket.rows).cpu().numpy()
        for j, gi in enumerate(bucket.indices):
            # a member that never finished reports the bucket's rounds and
            # its stragglers at -1, as the single-graph engine reports a
            # round-limit hit
            out[gi] = _coloring_result(
                c[j, :int(bucket.num_vertices[j])],
                int(done_round[j]) if done_round[j] >= 0 else rounds, syncs)
    return out


# ---------------------------------------------------------------------------
# MIS-2 aggregation (coarsening)
# ---------------------------------------------------------------------------

def _member_root_labels(roots: torch.Tensor,
                        first: torch.Tensor) -> torch.Tensor:
    """Member-local aggregate ids of the roots (bool ``[B, rows]``),
    ``first[j]`` onward in row order within member ``j``; INT32_MAX on the
    other rows.  Flat int32 ``[B * rows]``."""
    ids = first[:, None] + torch.cumsum(roots, dim=1, dtype=torch.int32) - 1
    return torch.where(roots, ids, INT32_MAX).to(torch.int32).view(-1)


def _coarsen_batch_impl(batch: GraphBatch, method: str = "two_phase",
                        options: Mis2Options | None = None,
                        min_secondary_neighbors: int = 2
                        ) -> list[AggregationResult]:
    """Batched MIS-2 coarsening (paper Alg. 2 / Alg. 3) over the batched
    dense MIS-2.  ``serial`` runs the host-sequential reference per graph
    (it has no data-parallel fixed point to batch)."""
    options = Mis2Options() if options is None else options
    if method == "serial":
        return [_aggregate_serial_greedy_impl(g) for g in batch.graphs]
    if method not in ("basic", "two_phase"):
        raise ValueError(f"unknown batch aggregation method {method!r} "
                         "(basic | two_phase | serial)")
    out: list = [None] * len(batch)
    for bucket in batch.buckets:
        results = _coarsen_bucket(bucket, method, options,
                                  min_secondary_neighbors)
        for gi, r in zip(bucket.indices, results):
            out[gi] = r
    return out


def _coarsen_bucket(bucket: GraphBucket, method: str, options: Mis2Options,
                    min_secondary_neighbors: int) -> list[AggregationResult]:
    bsz, rows = bucket.size, bucket.rows
    n = bsz * rows
    nbrs = bucket.flat_neighbors
    mask = bucket.mask.view(n, bucket.width)
    valid = bucket.row_valid.view(-1)
    dev = nbrs.device

    # Phase 1: MIS-2 roots + direct neighbors
    t1, iters, _ = _fixed_point(bucket, valid, options)
    in1 = (t1 == IN) & bucket.row_valid
    undecided = is_undecided(t1).any(dim=1)        # padded rows are OUT
    nagg = in1.sum(dim=1, dtype=torch.int32)
    labels = join_rows(nbrs, _member_root_labels(
        in1, torch.zeros(bsz, dtype=torch.int32, device=dev)))
    phase = (labels >= 0).to(torch.uint8)
    roots = in1.view(-1)

    # the padded rows' label: n - 1 is no real row's (a member with padding
    # has fewer aggregates than rows), so the join loops below see every
    # real row unlabeled exactly when the single-graph loops would, and
    # padded rows are nobody's neighbor
    if method == "two_phase":
        # Phase 2: MIS-2 on the induced unaggregated subgraph (a member with
        # nothing left runs no round)
        unagg = (labels < 0) & valid
        t2, it2, _ = _fixed_point(bucket, unagg, options)
        iters = iters + it2
        undecided |= (is_undecided(t2) & unagg.view_as(t2)).any(dim=1)
        in2 = ((t2 == IN) & bucket.row_valid).view(-1)
        n_unagg = count_unagg(nbrs, mask, torch.arange(n, device=dev),
                              labels)
        roots2 = in2 & (n_unagg >= min_secondary_neighbors)
        roots = roots | roots2
        adj2 = join_rows(nbrs, _member_root_labels(roots2.view(bsz, rows),
                                                    nagg))
        newly = (labels < 0) & (adj2 >= 0)
        labels = torch.where(newly, adj2, labels)
        phase = torch.where(newly, 2, phase).to(torch.uint8)
        nagg = nagg + roots2.view(bsz, rows).sum(dim=1, dtype=torch.int32)

        # Phase 3 over one label space: each member's labels offset by the
        # aggregates of the members before it, which keeps the (coupling,
        # size, label) order within a member and gives every (member,
        # label) its own size
        base = (torch.cumsum(nagg, dim=0, dtype=torch.int32)
                - nagg).repeat_interleave(rows)
        labels = torch.where(labels >= 0, labels + base, labels)
        labels = torch.where(valid, labels, n - 1).to(torch.int32)
        labels, phase = join_ops.phase3_fixed_point(
            join_ops.ell_layout(bucket.flat_neighbors32, mask), labels, phase)
        labels = torch.where(labels >= 0, labels - base, labels)
    else:
        # basic: leftovers join the min adjacent aggregate
        labels = torch.where(valid, labels, n - 1).to(torch.int32)
        labels, phase = join_ops.cleanup_join(
            join_ops.ell_layout(bucket.flat_neighbors32, mask), labels, phase)

    labels = labels.view(bsz, rows).cpu().numpy()
    phase = phase.view(bsz, rows).cpu().numpy()
    roots = roots.view(bsz, rows).cpu().numpy()
    nagg, iters = nagg.cpu().numpy(), iters.cpu().numpy()
    converged = ~undecided.cpu().numpy()
    results = []
    for j in range(bsz):
        v = int(bucket.num_vertices[j])
        lab_j, nagg_j = _finalize_singletons(labels[j, :v].copy(),
                                             int(nagg[j]), phase[j, :v])
        results.append(AggregationResult(
            lab_j.astype(np.int32), nagg_j, roots[j, :v], phase[j, :v],
            int(iters[j]), bool(converged[j])))
    return results


# ---------------------------------------------------------------------------
# AMG setup
# ---------------------------------------------------------------------------

def _amg_setup_batch_impl(batch: GraphBatch, aggregation: str = "two_phase",
                          options: Mis2Options | None = None,
                          min_secondary_neighbors: int = 2,
                          engine: str = "host", **hier_kwargs) -> list:
    """Batched AMG setup: the finest-level aggregation of every member
    above ``coarse_size`` runs through the batched coarsening, and each
    hierarchy is finished per graph by the multilevel ``engine`` with that
    aggregation injected (``first_agg``).  Per-graph hierarchies equal
    ``amg_setup(g, ...)``'s (equal level digests): the batched labels are
    the single-graph ones, and everything after them is the same code."""
    from ..multilevel.hierarchy import _build_hierarchy_impl

    coarse_size = hier_kwargs.get("coarse_size", 200)
    aggs: list = [None] * len(batch)
    if aggregation in ("basic", "two_phase"):
        sub = [i for i, g in enumerate(batch.graphs)
               if g.num_vertices > coarse_size]
        if sub:
            res = _coarsen_batch_impl(
                GraphBatch([batch.graphs[i] for i in sub]), aggregation,
                options, min_secondary_neighbors)
            for i, r in zip(sub, res):
                aggs[i] = r
    return [_build_hierarchy_impl(g, aggregation=aggregation, engine=engine,
                                  options=options, first_agg=agg,
                                  **hier_kwargs)
            for g, agg in zip(batch.graphs, aggs)]
