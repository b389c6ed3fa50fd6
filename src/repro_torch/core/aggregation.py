"""MIS-2 based graph coarsening (paper Algorithms 2 and 3), PyTorch port of
``repro.core.aggregation``.

* ``basic``     — Algorithm 2: MIS-2 roots + direct neighbors; leftovers
  join the minimum adjacent aggregate label.
* ``two_phase`` — Algorithm 3: phase 1 = MIS-2 roots + neighbors; phase 2 =
  a second MIS-2 on the unaggregated subgraph, roots with at least
  ``min_secondary_neighbors`` unaggregated neighbors form secondary
  aggregates; phase 3 = leftovers join the max-coupling adjacent aggregate
  (ties -> smaller aggregate -> smaller label) against frozen labels.
* ``serial``    — the host-sequential greedy reference.

The MIS-2 fixed points go through ``core.mis2.run_mis2``; each label join
(the root join with Alg. 2's cleanup, phase 2, phase 3) is one launch of a
kernel of ``kernels.joins`` on the card (its plain-torch twin on the CPU),
over the whole-graph ELL or, with the inner engine ``cuda_hybrid``, over
the hybrid layout (slab rows plus the spill's heavy rows), with equal
labels.  Between the joins the host reads one word (whether phase 1 left a
row unlabeled), as the reference's driver pulls its labels between its
dispatches, then the final labels, marks and secondary roots.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graphs.handle import as_graph
from ..kernels.joins import ops as join_ops
from ..kernels.joins.ref import INT32_MAX, JOIN_ROUNDS
from .mis2 import Mis2Options, run_mis2


@dataclass
class AggregationResult:
    labels: np.ndarray       # int32 [V] aggregate id
    num_aggregates: int
    roots: np.ndarray        # bool [V] (phase-1 + phase-2 roots)
    phase: np.ndarray        # uint8 [V]: phase that aggregated each vertex
    mis2_iterations: int     # total MIS-2 iterations spent
    converged: bool = True   # every underlying MIS-2 reached its fixed point


def _finalize_singletons(labels: np.ndarray, nagg: int, phase: np.ndarray):
    """Isolated leftovers (no aggregated neighbor at all) become singletons."""
    left = np.flatnonzero(labels < 0)
    if len(left):
        labels = labels.copy()
        labels[left] = nagg + np.arange(len(left))
        phase[left] = 3
        nagg += len(left)
    return labels, nagg


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _layout(gh, engine: str) -> join_ops.Layout:
    """The hybrid layout for ``cuda_hybrid`` (never builds ``gh.ell``), the
    whole-graph ELL for every other engine."""
    if engine == "cuda_hybrid":
        return join_ops.hybrid_layout(gh.hybrid())
    nbrs, mask = gh.ell
    return join_ops.ell_layout(nbrs, mask)


# ---------------------------------------------------------------------------
# Algorithm 2
# ---------------------------------------------------------------------------

def _aggregate_basic_impl(graph, options: Mis2Options | None = None,
                          engine: str = "cuda_resident",
                          backend=None) -> AggregationResult:
    gh = as_graph(graph)
    layout = _layout(gh, engine)
    r = run_mis2(gh, None, options, engine, backend)
    # the root join and the cleanup rounds: one launch on the card
    labels, phase, _ = join_ops.root_join(
        layout, torch.from_numpy(r.in_set).to(gh.device),
        cleanup_rounds=JOIN_ROUNDS)
    phase = _host(phase)
    labels, nagg = _finalize_singletons(_host(labels), int(r.in_set.sum()),
                                        phase)
    return AggregationResult(labels.astype(np.int32), nagg, r.in_set, phase,
                             r.iterations, r.converged)


# ---------------------------------------------------------------------------
# Algorithm 3
# ---------------------------------------------------------------------------

def _aggregate_two_phase_impl(graph, options: Mis2Options | None = None,
                              engine: str = "cuda_resident",
                              min_secondary_neighbors: int = 2,
                              backend=None) -> AggregationResult:
    gh = as_graph(graph)
    layout = _layout(gh, engine)
    dev = gh.device

    # Phase 1: MIS-2 roots + direct neighbors
    r1 = run_mis2(gh, None, options, engine, backend)
    labels, phase, aux = join_ops.root_join(
        layout, torch.from_numpy(r1.in_set).to(dev))
    nagg = int(r1.in_set.sum())
    total_iters = r1.iterations
    converged = r1.converged

    # Phase 2: MIS-2 on the induced unaggregated subgraph (one read: the
    # rows phase 1 left unlabeled)
    roots2_d = None
    if int(aux[1]) > 0:
        r2 = run_mis2(gh, labels < 0, options, engine, backend)
        total_iters += r2.iterations
        converged = converged and r2.converged
        labels, phase, roots2_d, _ = join_ops.phase2_join(
            layout, labels, phase, torch.from_numpy(r2.in_set).to(dev),
            aux[:1], min_secondary=min_secondary_neighbors)

    # Phase 3: max-coupling join against frozen tentative labels
    labels, phase = join_ops.phase3_fixed_point(layout, labels, phase)
    roots2 = (np.zeros(gh.num_vertices, dtype=bool) if roots2_d is None
              else _host(roots2_d))
    nagg += int(roots2.sum())
    phase = _host(phase)
    labels, nagg = _finalize_singletons(_host(labels), nagg, phase)
    return AggregationResult(labels.astype(np.int32), nagg,
                             r1.in_set | roots2, phase, total_iters,
                             converged)


# ---------------------------------------------------------------------------
# Algorithm 3, sharded (the label rounds over a process group; core.dist)
# ---------------------------------------------------------------------------

def _aggregate_two_phase_distributed_impl(
        graph, options: Mis2Options | None = None,
        min_secondary_neighbors: int = 2, *, backend=None,
        single_gather: bool = False) -> AggregationResult:
    """Distributed ML-style coarsening: both MIS-2 phases run the sharded
    fixed point, and every label-propagation round (root join, unaggregated
    count, max-coupling phase 3) is one label all-gather and the local
    rowwise join, with the bookkeeping on the host.  Labels are
    bit-identical to the single-device ``two_phase`` engine's: the sharded
    rounds run the same rowwise helpers."""
    from .dist import (
        _mis2_distributed_impl,
        count_unagg_neighbors_distributed,
        join_adjacent_root_distributed,
        phase3_join_distributed,
        prepare_padded,
    )

    gh = as_graph(graph)
    v = gh.num_vertices
    # pad and place this rank's row block once for the whole pipeline (2
    # MIS-2 fixed points and up to ~6 label rounds reuse it)
    padded = prepare_padded(gh, backend)
    dist_kw = {"padded": padded}
    mis2_kw = dict(dist_kw, single_gather=single_gather)

    # Phase 1: sharded MIS-2 roots + direct neighbors (sharded root join)
    r1 = _mis2_distributed_impl(gh, options=options, **mis2_kw)
    agg_ids = np.cumsum(r1.in_set) - 1
    root_label = np.where(r1.in_set, agg_ids, INT32_MAX).astype(np.int32)
    labels = join_adjacent_root_distributed(gh, root_label, **dist_kw)
    nagg = int(r1.in_set.sum())
    phase = np.where(labels >= 0, 1, 0).astype(np.uint8)
    total_iters = r1.iterations
    converged = r1.converged

    # Phase 2: sharded MIS-2 on the induced unaggregated subgraph
    unagg = labels < 0
    roots2 = np.zeros(v, dtype=bool)
    if unagg.any():
        r2 = _mis2_distributed_impl(gh, active=unagg, options=options,
                                    **mis2_kw)
        total_iters += r2.iterations
        converged = converged and r2.converged
        n_unagg_nbrs = count_unagg_neighbors_distributed(gh, labels,
                                                         **dist_kw)
        roots2 = r2.in_set & (n_unagg_nbrs >= min_secondary_neighbors)
        if roots2.any():
            agg_ids2 = nagg + np.cumsum(roots2) - 1
            rl2 = np.where(roots2, agg_ids2, INT32_MAX).astype(np.int32)
            adj2 = join_adjacent_root_distributed(gh, rl2, **dist_kw)
            newly = (labels < 0) & (adj2 >= 0)
            labels = np.where(newly, adj2, labels)
            phase[newly] = 2
            nagg += int(roots2.sum())

    # Phase 3: sharded max-coupling join against frozen tentative labels
    rounds = 0
    while (labels < 0).any() and rounds < JOIN_ROUNDS:
        aggsize = np.bincount(labels[labels >= 0], minlength=max(nagg, 1))
        new_labels = phase3_join_distributed(
            gh, labels.astype(np.int32), aggsize.astype(np.int32), **dist_kw)
        newly = (labels < 0) & (new_labels >= 0)
        phase[newly] = 3
        labels = new_labels
        rounds += 1

    labels, nagg = _finalize_singletons(labels, nagg, phase)
    return AggregationResult(labels.astype(np.int32), nagg,
                             r1.in_set | roots2, phase, total_iters,
                             converged)


# ---------------------------------------------------------------------------
# host-sequential reference
# ---------------------------------------------------------------------------

def _aggregate_serial_greedy_impl(graph) -> AggregationResult:
    csr = as_graph(graph).csr
    indptr, indices = csr.indptr, csr.indices
    v = csr.num_vertices
    labels = np.full(v, -1, dtype=np.int32)
    roots = np.zeros(v, dtype=bool)
    nagg = 0
    for u in range(v):
        if labels[u] >= 0:
            continue
        nbrs = indices[indptr[u]:indptr[u + 1]]
        nbrs = nbrs[nbrs != u]
        free = nbrs[labels[nbrs] < 0]
        if len(free) >= 2:
            labels[u] = nagg
            labels[free] = nagg
            roots[u] = True
            nagg += 1
    for u in range(v):   # cleanup: join first aggregated neighbor
        if labels[u] < 0:
            nbrs = indices[indptr[u]:indptr[u + 1]]
            agg = nbrs[labels[nbrs] >= 0]
            if len(agg):
                labels[u] = labels[agg[0]]
            else:
                labels[u] = nagg
                nagg += 1
    phase = np.ones(v, dtype=np.uint8)
    return AggregationResult(labels, nagg, roots, phase, 0)
