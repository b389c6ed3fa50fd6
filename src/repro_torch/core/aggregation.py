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

The label joins are plain torch over the ELL adjacency on the graph's
device, as the JAX package computes them outside Pallas; the MIS-2 fixed
points go through ``core.mis2.run_mis2``.  With the inner engine
``cuda_hybrid`` the joins run over the hybrid layout instead (slab rows
plus segment reductions over the spill), with equal labels.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..graphs.handle import as_graph
from .mis2 import Mis2Options, run_mis2
from .segments import segment_reduce

INT32_MAX = 2**31 - 1
_JOIN_ROUNDS = 4


@dataclass
class AggregationResult:
    labels: np.ndarray       # int32 [V] aggregate id
    num_aggregates: int
    roots: np.ndarray        # bool [V] (phase-1 + phase-2 roots)
    phase: np.ndarray        # uint8 [V]: phase that aggregated each vertex
    mis2_iterations: int     # total MIS-2 iterations spent
    converged: bool = True   # every underlying MIS-2 reached its fixed point


def _join_rows(neighbors: torch.Tensor, root_label: torch.Tensor):
    """label[v] = min root label over the closed neighborhood, else -1.

    A vertex adjacent to two distinct roots would contradict distance-2
    independence, so min() is exact, not a tie-break."""
    lab = root_label[neighbors].amin(dim=1)
    return torch.where(lab == INT32_MAX, -1, lab).to(torch.int32)


def _row_ids(neighbors: torch.Tensor) -> torch.Tensor:
    return torch.arange(neighbors.shape[0], dtype=neighbors.dtype,
                        device=neighbors.device)


def _labels_from_roots(neighbors: torch.Tensor, roots: torch.Tensor):
    """Phase-1 style aggregate formation: roots + direct neighbors."""
    agg_ids = torch.cumsum(roots, dim=0, dtype=torch.int32) - 1
    root_label = torch.where(roots, agg_ids, INT32_MAX).to(torch.int32)
    return _join_rows(neighbors, root_label), int(roots.sum())


def _cleanup_loop(labels, phase, join_fn):
    """Alg. 2 leftover cleanup: up to 4 min-adjacent-label join rounds,
    stopping once every vertex is labeled; ``join_fn(root_label)`` is the
    layout's closed-neighborhood min join."""
    for _ in range(_JOIN_ROUNDS):
        if not bool((labels < 0).any()):
            break
        lab_j = torch.where(labels >= 0, labels, INT32_MAX).to(torch.int32)
        adj = join_fn(lab_j)
        newly = (labels < 0) & (adj >= 0)
        labels = torch.where(newly, adj, labels)
        phase = torch.where(newly, 3, phase).to(torch.uint8)
    return labels, phase


def _cleanup_join_resident(neighbors, labels, phase):
    """Alg. 2 leftover cleanup over the whole-graph ELL."""
    return _cleanup_loop(labels, phase,
                         lambda lab: _join_rows(neighbors, lab))


def _count_unagg(neighbors, mask, row_ids, labels):
    """# real neighbors (excluding self) that are unaggregated, for the rows
    ``row_ids`` whose adjacency is ``neighbors``; ``labels`` is ``[V]``."""
    real = mask & (neighbors != row_ids[:, None])
    return (real & (labels[neighbors] < 0)).sum(dim=1, dtype=torch.int32)


def _secondary_roots(in_set2, n_unagg, nagg: int, min_secondary: int):
    """Alg. 3 phase 2: secondary roots and their root labels (cumsum
    aggregate ids offset by ``nagg``; INT32_MAX elsewhere)."""
    roots2 = in_set2 & (n_unagg >= min_secondary)
    agg_ids2 = nagg + torch.cumsum(roots2, dim=0, dtype=torch.int32) - 1
    return roots2, torch.where(roots2, agg_ids2, INT32_MAX).to(torch.int32)


def _phase2_join_resident(neighbors, mask, labels, in_set2, nagg: int,
                          min_secondary: int):
    """Alg. 3 phase 2: unaggregated-neighbor counts, secondary roots, their
    cumsum aggregate ids (offset by ``nagg``) and the root join."""
    n_unagg = _count_unagg(neighbors, mask, _row_ids(neighbors), labels)
    roots2, rl2 = _secondary_roots(in_set2, n_unagg, nagg, min_secondary)
    adj2 = _join_rows(neighbors, rl2)
    newly = (labels < 0) & (adj2 >= 0)
    return torch.where(newly, adj2, labels), roots2, newly


def _phase3_rows(neighbors, mask, row_ids, labels, labels_rows, aggsize):
    """One max-coupling join round against frozen ``labels`` ``[V]`` for the
    rows ``row_ids`` (adjacency ``neighbors``, own labels ``labels_rows``)."""
    labels_n = labels[neighbors]                     # tentative labels
    valid = mask & (neighbors != row_ids[:, None]) & (labels_n >= 0)
    d = neighbors.shape[1]
    # coupling[v, j] = # valid slots of row v sharing slot j's label
    coupling = torch.zeros(labels_n.shape, dtype=torch.int32,
                           device=labels.device)
    for k in range(d):
        same = (labels_n == labels_n[:, k:k + 1]) & valid[:, k:k + 1]
        coupling += same & valid
    size_n = aggsize[labels_n.clamp(0, aggsize.shape[0] - 1)]

    # lexicographic argmin over slots of (-coupling, size, label)
    best_c = torch.where(valid[:, 0], coupling[:, 0], -1)
    best_s = size_n[:, 0]
    best_l = torch.where(valid[:, 0], labels_n[:, 0], INT32_MAX)
    for j in range(1, d):
        cj = torch.where(valid[:, j], coupling[:, j], -1)
        sj = size_n[:, j]
        lj = torch.where(valid[:, j], labels_n[:, j], INT32_MAX)
        better = (cj > best_c) | ((cj == best_c) & ((sj < best_s) |
                                                    ((sj == best_s) & (lj < best_l))))
        best_c = torch.where(better, cj, best_c)
        best_s = torch.where(better, sj, best_s)
        best_l = torch.where(better, lj, best_l)
    joined = (best_c > 0) & (best_l != INT32_MAX)
    return torch.where((labels_rows < 0) & joined, best_l,
                       labels_rows).to(torch.int32)


def _aggsize(labels):
    """Aggregate sizes (slot ``V`` is the dump for unlabeled vertices, so
    entries ``0..nagg-1`` match ``np.bincount``)."""
    v = labels.shape[0]
    return torch.bincount(torch.where(labels >= 0, labels, v),
                          minlength=v + 1).to(torch.int32)


def _phase3_loop(labels, phase, round_fn):
    """Alg. 3 phase 3: up to 4 max-coupling join rounds against frozen
    tentative labels, aggregate sizes recounted each round;
    ``round_fn(labels, aggsize)`` gives the round's new labels."""
    for _ in range(_JOIN_ROUNDS):
        if not bool((labels < 0).any()):
            break
        new_labels = round_fn(labels, _aggsize(labels))
        newly = (labels < 0) & (new_labels >= 0)
        phase = torch.where(newly, 3, phase).to(torch.uint8)
        labels = new_labels
    return labels, phase


def _phase3_resident(neighbors, mask, labels, phase):
    """Alg. 3 phase 3 over the whole-graph ELL."""
    rows = _row_ids(neighbors)
    return _phase3_loop(labels, phase, lambda lab, size: _phase3_rows(
        neighbors, mask, rows, lab, lab, size))


# ---------------------------------------------------------------------------
# the joins over the hybrid layout (sliced ELL + COO spill): the same
# rowwise bodies per slab (``row_ids = slice.rows``) plus segment
# reductions over the spill.  Within a round every read comes from the
# round-start labels and the writes go to a fresh buffer; the slabs and
# the spill partition the rows, so each round is the whole-graph round
# evaluated piecewise and the labels equal the ELL engines'.
# ---------------------------------------------------------------------------

def _spill_parts(hyb):
    """(rows, seg, cols) of the spill as int64 index tensors."""
    return tuple(x.to(torch.int64)
                 for x in (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols))


def _hybrid_join_labels(hyb, root_label):
    """Hybrid twin of :func:`_join_rows` over every row (min label over the
    closed neighborhood; INT32_MAX -> -1).  The spill's explicit self term
    stands in for the ELL padding slots, which hold the row's own id."""
    adj = torch.full_like(root_label, -1)
    for sl in hyb.slices:
        adj[sl.rows.to(torch.int64)] = _join_rows(sl.neighbors, root_label)
    if hyb.num_spill_rows:
        rows, seg, cols = _spill_parts(hyb)
        mn = segment_reduce(root_label[cols].to(torch.int64), seg,
                            rows.shape[0], "amin", INT32_MAX)
        mn = torch.minimum(mn, root_label[rows].to(torch.int64))
        adj[rows] = torch.where(mn == INT32_MAX, -1, mn).to(torch.int32)
    return adj


def _labels_from_roots_hybrid(hyb, roots: torch.Tensor):
    """Hybrid twin of :func:`_labels_from_roots`."""
    agg_ids = torch.cumsum(roots, dim=0, dtype=torch.int32) - 1
    root_label = torch.where(roots, agg_ids, INT32_MAX).to(torch.int32)
    return _hybrid_join_labels(hyb, root_label), int(roots.sum())


def _cleanup_join_resident_hybrid(hyb, labels, phase):
    """Hybrid twin of :func:`_cleanup_join_resident`."""
    return _cleanup_loop(labels, phase,
                         lambda lab: _hybrid_join_labels(hyb, lab))


def _phase2_join_resident_hybrid(hyb, labels, in_set2, nagg: int,
                                 min_secondary: int):
    """Hybrid twin of :func:`_phase2_join_resident`: the unaggregated-
    neighbor count runs rowwise per slab and as a segment sum over the
    spill; root selection, ids and the join work on ``[V]`` vectors."""
    n_unagg = torch.zeros_like(labels)
    for sl in hyb.slices:
        n_unagg[sl.rows.to(torch.int64)] = _count_unagg(
            sl.neighbors, sl.mask, sl.rows, labels)
    if hyb.num_spill_rows:
        rows, seg, cols = _spill_parts(hyb)
        hit = (cols != rows[seg]) & (labels[cols] < 0)
        n_sp = torch.zeros(rows.shape[0], dtype=torch.int64,
                           device=labels.device)
        n_sp.index_add_(0, seg, hit.to(torch.int64))
        n_unagg[rows] = n_sp.to(torch.int32)
    roots2, rl2 = _secondary_roots(in_set2, n_unagg, nagg, min_secondary)
    adj2 = _hybrid_join_labels(hyb, rl2)
    newly = (labels < 0) & (adj2 >= 0)
    return torch.where(newly, adj2, labels), roots2, newly


def _phase3_spill(hyb, labels, aggsize):
    """Phase-3 body over the spill: the max-coupling adjacent aggregate
    (ties -> smaller size -> smaller label).  Entries are sorted by the
    int64 key ``(segment << 32) | label``, so equal labels of a row form
    runs whose length is the coupling; the lexicographic choice is then a
    cascade of segment reductions (max coupling, min size among those, min
    label among those).  Valid slots are distinct real neighbors in both
    layouts, so the choice equals :func:`_phase3_rows`'."""
    rows, seg, cols = _spill_parts(hyb)
    h, s = rows.shape[0], cols.shape[0]
    lab_n = labels[cols].to(torch.int64)
    valid = (cols != rows[seg]) & (lab_n >= 0)
    key = (seg << 32) | torch.where(valid, lab_n, INT32_MAX)
    key = torch.sort(key).values
    seg_s, lab_s = key >> 32, key & 0xFFFFFFFF
    start = torch.ones(s, dtype=torch.bool, device=labels.device)
    start[1:] = (seg_s[1:] != seg_s[:-1]) | (lab_s[1:] != lab_s[:-1])
    run_id = torch.cumsum(start, dim=0) - 1
    run_len = torch.bincount(run_id, minlength=s)
    c_e = torch.where(lab_s < INT32_MAX, run_len[run_id], -1)
    size_e = aggsize[lab_s.clamp(0, aggsize.shape[0] - 1)].to(torch.int64)
    best_c = segment_reduce(c_e, seg_s, h, "amax", -2**31)
    on_c = c_e == best_c[seg_s]
    best_s = segment_reduce(torch.where(on_c, size_e, INT32_MAX), seg_s, h,
                            "amin", INT32_MAX)
    on_s = on_c & (size_e == best_s[seg_s])
    best_l = segment_reduce(torch.where(on_s, lab_s, INT32_MAX), seg_s, h,
                            "amin", INT32_MAX)
    joined = (best_c > 0) & (best_l < INT32_MAX)
    own = labels[rows]
    return torch.where((own < 0) & joined, best_l, own).to(torch.int32)


def _phase3_resident_hybrid(hyb, labels, phase):
    """Hybrid twin of :func:`_phase3_resident`."""
    slabs = [(sl.neighbors, sl.mask, sl.rows, sl.rows.to(torch.int64))
             for sl in hyb.slices]
    spill_rows = hyb.spill_rows.to(torch.int64)

    def round_fn(lab, size):
        new = lab.clone()
        for nbrs, mask, rows, rows64 in slabs:
            new[rows64] = _phase3_rows(nbrs, mask, rows, lab, lab[rows64],
                                       size)
        if hyb.num_spill_rows:
            new[spill_rows] = _phase3_spill(hyb, lab, size)
        return new

    return _phase3_loop(labels, phase, round_fn)


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


class _Joins(NamedTuple):
    """The label joins of one layout, as the drivers below call them."""

    roots: Callable        # roots [V] bool -> (labels, nagg)
    cleanup: Callable      # (labels, phase) -> (labels, phase)
    phase2: Callable       # (labels, in_set2, nagg, min_secondary)
    #                        -> (labels, roots2, newly)
    phase3: Callable       # (labels, phase) -> (labels, phase)


def _layout_joins(gh, engine: str) -> _Joins:
    """The hybrid layout's joins for ``cuda_hybrid`` (never builds
    ``gh.ell``), the whole-graph ELL's for every other engine."""
    if engine == "cuda_hybrid":
        hyb = gh.hybrid()
        return _Joins(partial(_labels_from_roots_hybrid, hyb),
                      partial(_cleanup_join_resident_hybrid, hyb),
                      partial(_phase2_join_resident_hybrid, hyb),
                      partial(_phase3_resident_hybrid, hyb))
    nbrs, mask = gh.ell
    return _Joins(partial(_labels_from_roots, nbrs),
                  partial(_cleanup_join_resident, nbrs),
                  partial(_phase2_join_resident, nbrs, mask),
                  partial(_phase3_resident, nbrs, mask))


# ---------------------------------------------------------------------------
# Algorithm 2
# ---------------------------------------------------------------------------

def _aggregate_basic_impl(graph, options: Mis2Options | None = None,
                          engine: str = "cuda_resident",
                          backend=None) -> AggregationResult:
    gh = as_graph(graph)
    joins = _layout_joins(gh, engine)
    r = run_mis2(gh, None, options, engine, backend)
    labels, nagg = joins.roots(torch.from_numpy(r.in_set).to(gh.device))
    phase = (labels >= 0).to(torch.uint8)
    labels, phase = joins.cleanup(labels, phase)
    phase = _host(phase)
    labels, nagg = _finalize_singletons(_host(labels), nagg, phase)
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
    joins = _layout_joins(gh, engine)
    dev = gh.device

    # Phase 1: MIS-2 roots + direct neighbors
    r1 = run_mis2(gh, None, options, engine, backend)
    labels, nagg = joins.roots(torch.from_numpy(r1.in_set).to(dev))
    phase = (labels >= 0).to(torch.uint8)
    total_iters = r1.iterations
    converged = r1.converged

    # Phase 2: MIS-2 on the induced unaggregated subgraph
    unagg = labels < 0
    roots2 = np.zeros(gh.num_vertices, dtype=bool)
    if bool(unagg.any()):
        r2 = run_mis2(gh, unagg, options, engine, backend)
        total_iters += r2.iterations
        converged = converged and r2.converged
        labels, roots2_d, newly = joins.phase2(
            labels, torch.from_numpy(r2.in_set).to(dev), nagg,
            min_secondary_neighbors)
        phase = torch.where(newly, 2, phase).to(torch.uint8)
        roots2 = _host(roots2_d)
        nagg += int(roots2.sum())

    # Phase 3: max-coupling join against frozen tentative labels
    labels, phase = joins.phase3(labels, phase)
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
    while (labels < 0).any() and rounds < _JOIN_ROUNDS:
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
