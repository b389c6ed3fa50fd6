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
points go through ``core.mis2.run_mis2``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graphs.handle import as_graph
from .mis2 import Mis2Options, run_mis2

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


def _cleanup_join_resident(neighbors, labels, phase):
    """Alg. 2 leftover cleanup: up to 4 min-adjacent-label join rounds,
    stopping once every vertex is labeled."""
    for _ in range(_JOIN_ROUNDS):
        if not bool((labels < 0).any()):
            break
        lab_j = torch.where(labels >= 0, labels, INT32_MAX).to(torch.int32)
        adj = _join_rows(neighbors, lab_j)
        newly = (labels < 0) & (adj >= 0)
        labels = torch.where(newly, adj, labels)
        phase = torch.where(newly, 3, phase).to(torch.uint8)
    return labels, phase


def _count_unagg(neighbors, mask, labels):
    """# real neighbors (excluding self) that are unaggregated."""
    real = mask & (neighbors != _row_ids(neighbors)[:, None])
    return (real & (labels[neighbors] < 0)).sum(dim=1, dtype=torch.int32)


def _phase2_join_resident(neighbors, mask, labels, in_set2, nagg: int,
                          min_secondary: int):
    """Alg. 3 phase 2: unaggregated-neighbor counts, secondary roots, their
    cumsum aggregate ids (offset by ``nagg``) and the root join."""
    n_unagg = _count_unagg(neighbors, mask, labels)
    roots2 = in_set2 & (n_unagg >= min_secondary)
    agg_ids2 = nagg + torch.cumsum(roots2, dim=0, dtype=torch.int32) - 1
    rl2 = torch.where(roots2, agg_ids2, INT32_MAX).to(torch.int32)
    adj2 = _join_rows(neighbors, rl2)
    newly = (labels < 0) & (adj2 >= 0)
    return torch.where(newly, adj2, labels), roots2, newly


def _phase3_rows(neighbors, mask, labels, aggsize):
    """One max-coupling join round against frozen ``labels``."""
    labels_n = labels[neighbors]                     # tentative labels
    valid = mask & (neighbors != _row_ids(neighbors)[:, None]) \
        & (labels_n >= 0)
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
    return torch.where((labels < 0) & joined, best_l, labels).to(torch.int32)


def _phase3_resident(neighbors, mask, labels, phase):
    """Alg. 3 phase 3: up to 4 max-coupling join rounds, aggregate sizes
    recounted each round (slot ``V`` is the dump for unlabeled vertices, so
    entries ``0..nagg-1`` match ``np.bincount``)."""
    v = neighbors.shape[0]
    for _ in range(_JOIN_ROUNDS):
        if not bool((labels < 0).any()):
            break
        aggsize = torch.bincount(torch.where(labels >= 0, labels, v),
                                 minlength=v + 1).to(torch.int32)
        new_labels = _phase3_rows(neighbors, mask, labels, aggsize)
        newly = (labels < 0) & (new_labels >= 0)
        phase = torch.where(newly, 3, phase).to(torch.uint8)
        labels = new_labels
    return labels, phase


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


# ---------------------------------------------------------------------------
# Algorithm 2
# ---------------------------------------------------------------------------

def _aggregate_basic_impl(graph, options: Mis2Options | None = None,
                          engine: str = "cuda_resident") -> AggregationResult:
    ell = as_graph(graph).ell
    dev = ell.neighbors.device
    r = run_mis2(graph, None, options, engine)
    labels, nagg = _labels_from_roots(ell.neighbors,
                                      torch.from_numpy(r.in_set).to(dev))
    phase = (labels >= 0).to(torch.uint8)
    labels, phase = _cleanup_join_resident(ell.neighbors, labels, phase)
    phase = _host(phase)
    labels, nagg = _finalize_singletons(_host(labels), nagg, phase)
    return AggregationResult(labels.astype(np.int32), nagg, r.in_set, phase,
                             r.iterations, r.converged)


# ---------------------------------------------------------------------------
# Algorithm 3
# ---------------------------------------------------------------------------

def _aggregate_two_phase_impl(graph, options: Mis2Options | None = None,
                              engine: str = "cuda_resident",
                              min_secondary_neighbors: int = 2
                              ) -> AggregationResult:
    ell = as_graph(graph).ell
    dev = ell.neighbors.device

    # Phase 1: MIS-2 roots + direct neighbors
    r1 = run_mis2(graph, None, options, engine)
    labels, nagg = _labels_from_roots(ell.neighbors,
                                      torch.from_numpy(r1.in_set).to(dev))
    phase = (labels >= 0).to(torch.uint8)
    total_iters = r1.iterations
    converged = r1.converged

    # Phase 2: MIS-2 on the induced unaggregated subgraph
    unagg = labels < 0
    roots2 = np.zeros(ell.num_vertices, dtype=bool)
    if bool(unagg.any()):
        r2 = run_mis2(graph, unagg, options, engine)
        total_iters += r2.iterations
        converged = converged and r2.converged
        labels, roots2_d, newly = _phase2_join_resident(
            ell.neighbors, ell.mask, labels,
            torch.from_numpy(r2.in_set).to(dev), nagg,
            min_secondary_neighbors)
        phase = torch.where(newly, 2, phase).to(torch.uint8)
        roots2 = _host(roots2_d)
        nagg += int(roots2.sum())

    # Phase 3: max-coupling join against frozen tentative labels
    labels, phase = _phase3_resident(ell.neighbors, ell.mask, labels, phase)
    phase = _host(phase)
    labels, nagg = _finalize_singletons(_host(labels), nagg, phase)
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
