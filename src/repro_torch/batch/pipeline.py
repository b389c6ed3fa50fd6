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
  pre-colors them, and the coarsening's root join takes each as a root of
  its own (a padded row is nobody's neighbour, so no real row sees it);
* a member's iteration counter advances only while that graph is live, so
  the §V-A priority stream matches the single-graph run even when bucket
  mates need more rounds;
* host-side label bookkeeping (singleton cleanup) runs per graph on the
  unpadded slice, exactly as the single-graph aggregation does.

Each fixed point of a bucket is one launch on the card with no host read
inside it (``host_syncs`` 0), as the reference runs it as one dispatch; on
the CPU the kernels' twins read one flag a round.  Each label join of the
coarsening (the root join with Alg. 2's cleanup, phase 2, phase 3) is one
launch of a join kernel (``kernels.joins``) over the bucket's
block-diagonal ELL, as the single-graph coarsening runs them.  Every
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
from ..kernels.joins.ref import JOIN_ROUNDS
from ..kernels.minprop_ell import ops
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
    """One bucket's coarsening: the batched MIS-2 solves and one launch of
    each join over the block-diagonal ELL (``two_phase``: two solves, the
    root join, phase 2 and phase 3; ``basic``: one solve and the root join
    with the cleanup), nothing read on the host between them.

    The joins number aggregates over the whole bucket, in row order, and
    the members are contiguous row blocks, so member ``j``'s phase-1 ids
    are ``b1[j] + local`` (``b1`` the exclusive scan of the members' root
    counts) and its phase-2 ids ``total1 + b2[j] + local2`` (phase 2
    numbers from the bucket's phase-1 total).  Both maps are monotone
    within a member and put every phase-2 id above every phase-1 id, so
    the min joins and phase 3's (coupling, size, label) order pick as the
    single-graph joins do; the ids are mapped back once, after the last
    join, on the device."""
    bsz, rows = bucket.size, bucket.rows
    n = bsz * rows
    valid = bucket.row_valid.view(-1)
    layout = join_ops.ell_layout(bucket.flat_neighbors32,
                                 bucket.mask.view(n, bucket.width))

    # Phase 1: MIS-2 roots + direct neighbors.  Each padded row is a root
    # of its own: it labels only itself, follows its member's real rows in
    # row order (the real roots keep their ids), and leaves the loops of
    # the cleanup and phase 3 nothing of its own to wait for.
    t1, iters, _ = _fixed_point(bucket, valid, options)
    in1 = ((t1 == IN) & bucket.row_valid).view(-1)
    undecided = is_undecided(t1).any(dim=1)        # padded rows are OUT
    roots1 = in1 | ~valid
    labels, phase, aux = join_ops.root_join(
        layout, roots1,
        cleanup_rounds=JOIN_ROUNDS if method == "basic" else 0)
    roots2 = None
    if method == "two_phase":
        # Phase 2: MIS-2 on the induced unaggregated subgraph (a member
        # with nothing left runs no round), its roots numbered from the
        # bucket's phase-1 total; Phase 3: the max-coupling join
        unagg = labels < 0
        t2, it2, _ = _fixed_point(bucket, unagg, options)
        iters = iters + it2
        undecided |= (is_undecided(t2) & unagg.view_as(t2)).any(dim=1)
        in2 = ((t2 == IN) & bucket.row_valid).view(-1)
        labels, phase, roots2, _ = join_ops.phase2_join(
            layout, labels, phase, in2, aux[:1],
            min_secondary=min_secondary_neighbors)
        labels, phase = join_ops.phase3_fixed_point(layout, labels, phase)

    # member-local ids, on the device (a few elementwise launches; the same
    # map on the host costs tens of ms a 2M-row bucket): phase-1 ids less
    # b1[j], phase-2 ids less total1 + b2[j] - n1[j] (aux[0] is total1)
    lab = labels.view(bsz, rows)
    c1 = roots1.view(bsz, rows).sum(dim=1, dtype=torch.int32)
    n1 = in1.view(bsz, rows).sum(dim=1, dtype=torch.int32)
    n2 = torch.zeros_like(n1) if roots2 is None \
        else roots2.view(bsz, rows).sum(dim=1, dtype=torch.int32)
    b1 = torch.cumsum(c1, dim=0, dtype=torch.int32) - c1
    off2 = aux[:1] + torch.cumsum(n2, dim=0, dtype=torch.int32) - n2 - n1
    off = torch.where(lab >= aux[:1], off2[:, None], b1[:, None])
    lab = torch.where(lab >= 0, lab - off, lab)
    roots = in1 if roots2 is None else in1 | roots2

    labels = lab.cpu().numpy()
    phase = phase.view(bsz, rows).cpu().numpy()
    roots = roots.view(bsz, rows).cpu().numpy()
    nagg = (n1 + n2).cpu().numpy()
    iters = iters.cpu().numpy()
    converged = ~undecided.cpu().numpy()
    results = []
    for j in range(bsz):
        v = int(bucket.num_vertices[j])
        lab_j, nagg_j = _finalize_singletons(labels[j, :v], int(nagg[j]),
                                             phase[j, :v])
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
