"""Multilevel graph partitioning via MIS-2 aggregation (paper §VII), PyTorch
port of ``repro.core.partition``.

Coarsen with Algorithm 3 until at most ``coarse_target`` vertices remain,
split the coarsest graph greedily into balanced parts, project the parts
back up, and run a boundary refinement at every level (vertices move only
to a strictly better part, in index order, within 10% of balance).

Where each step runs:

* the aggregation of each level is ``core.aggregation``'s two-phase one on
  the graph's device (the inner MIS-2 from ``default_mis2_engine``:
  ``cuda_resident``, one persistent kernel a solve, on the card);
* each coarse graph is built on the device from the level's ELL and labels
  (``multilevel.galerkin._coarse_graph_keys_device``): sorted unique keys,
  so its host CSR is ``coarse_graph_from_labels``' entry for entry;
* the greedy split of the coarsest graph is host numpy (an order-dependent
  BFS over at most ``coarse_target`` vertices);
* the refinement's neighbour-part counts, best part and gain are computed
  on the device from the level's ELL; the moves, each of which changes the
  loads the next one checks, run on the host in index order.

Every level's padded ELL is built, so a graph past ``ELL_BYTE_LIMIT``
raises ``LayoutOverflowError`` as the reference's ``Graph.ell`` does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..graphs.csr import CSRGraph
from ..graphs.handle import Graph, as_graph
from ..multilevel.galerkin import (
    _coarse_graph_ell_device,
    _coarse_graph_keys_device,
)
from .aggregation import _aggregate_two_phase_impl
from .mis2 import Mis2Options


@dataclass
class PartitionResult:
    parts: np.ndarray          # int32 [V] part id
    num_parts: int
    edge_cut: int
    levels: int
    history: list = field(default_factory=list)   # (V, E) per coarse level
    converged: bool = True   # every per-level MIS-2 reached its fixed point


def _edge_list(gh: Graph):
    """The off-diagonal entries ``(rows, cols)`` (int64, on the device) of
    the level's ELL, in CSR order."""
    nb, mask = gh.ell
    nb = nb.to(torch.int64)
    rows = torch.arange(nb.shape[0], device=nb.device)[:, None].expand_as(nb)
    keep = mask & (nb != rows)
    return rows[keep], nb[keep]


def edge_cut(g, parts: np.ndarray) -> int:
    """Undirected edges whose ends lie in different parts."""
    gh = as_graph(g)
    r, c = _edge_list(gh)
    p = torch.from_numpy(np.asarray(parts, dtype=np.int64)).to(gh.device)
    return int((p[r] != p[c]).sum()) // 2


def _greedy_coarse_partition(g: CSRGraph, k: int, w: np.ndarray) -> np.ndarray:
    """BFS-ish weight-balanced greedy partition of a small graph (host)."""
    v = g.num_vertices
    indptr = np.asarray(g.indptr)
    indices = np.asarray(g.indices)
    total = int(w.sum())
    parts = np.full(v, -1, dtype=np.int32)
    order = np.argsort(-np.diff(indptr))          # high degree first seeds
    loads = np.zeros(k, dtype=np.int64)
    cur = 0
    remaining = total
    for seed in order:
        if parts[seed] >= 0:
            continue
        if cur >= k:
            cur = int(loads.argmin())
        frontier = [int(seed)]
        while frontier:
            tgt = (remaining + loads[cur]) / max(1, k - cur) if cur < k \
                else total / k
            if loads[cur] >= tgt:
                break
            u = frontier.pop(0)
            if parts[u] >= 0:
                continue
            # avoid chunky overshoot: push to next part instead
            if cur < k - 1 and loads[cur] > 0.7 * tgt \
                    and loads[cur] + int(w[u]) > 1.1 * tgt:
                break
            parts[u] = cur
            loads[cur] += int(w[u])
            remaining -= int(w[u])
            for nb in indices[indptr[u]:indptr[u + 1]]:
                if parts[nb] < 0:
                    frontier.append(int(nb))
        tgt = (remaining + loads[cur]) / max(1, k - cur) if cur < k else 0
        if cur < k and loads[cur] >= 0.9 * tgt:
            cur += 1
    for u in np.flatnonzero(parts < 0):            # stragglers -> lightest
        p = int(loads.argmin())
        parts[u] = p
        loads[p] += int(w[u])
    return parts


def _refine(gh: Graph, parts: np.ndarray, k: int, w: np.ndarray,
            rounds: int = 2) -> np.ndarray:
    """Boundary refinement: move to the majority neighbour part if it
    strictly reduces the cut and keeps the weighted balance within 10%.

    The counts of each vertex's neighbours per part, the best part (the
    first maximum, as numpy's ``argmax``) and the gain come from the
    device; only the vertices with a positive gain come to the host, where
    the moves run in index order."""
    v = gh.num_vertices
    r, c = _edge_list(gh)
    cap = int(np.ceil(w.sum() / k * 1.10))
    for _ in range(rounds):
        p = torch.from_numpy(parts.astype(np.int64)).to(gh.device)
        counts = torch.bincount(r * k + p[c], minlength=v * k).view(v, k)
        best = counts.argmax(dim=1)
        gain = (counts.gather(1, best[:, None])
                - counts.gather(1, p[:, None])).squeeze(1)
        cand = torch.nonzero(gain > 0).squeeze(1)
        cand_best = best[cand].cpu().numpy()
        cand = cand.cpu().numpy()
        loads = np.bincount(parts, weights=w, minlength=k).astype(
            np.int64).tolist()
        moved_u, moved_b = [], []
        for u, b, pu, wu in zip(cand.tolist(), cand_best.tolist(),
                                parts[cand].tolist(), w[cand].tolist()):
            if b != pu and loads[b] + wu <= cap and loads[pu] > wu:
                loads[pu] -= wu
                loads[b] += wu
                moved_u.append(u)
                moved_b.append(b)
        if not moved_u:
            break
        parts[moved_u] = moved_b
    return parts


def _coarse_graph(gh: Graph, labels: np.ndarray, nagg: int) -> Graph:
    """The level's coarse graph on its device, an ELL-seeded handle."""
    nb, mask = gh.ell
    v = gh.num_vertices
    keys = _coarse_graph_keys_device(
        nb, mask, torch.from_numpy(labels.astype(np.int64)).to(gh.device), v)
    return Graph(_coarse_graph_ell_device(keys, v, nagg))


def _partition_impl(graph, num_parts: int, coarse_target: int | None,
                    options: Mis2Options | None,
                    mis2_engine: Callable[[Graph], str]) -> PartitionResult:
    """``mis2_engine(level graph)`` names each level's inner MIS-2 engine."""
    options = Mis2Options() if options is None else options
    gh = as_graph(graph)
    coarse_target = coarse_target or max(16 * num_parts, 256)
    levels = []
    graphs = [gh]
    weights = [np.ones(gh.num_vertices, dtype=np.int64)]
    label_maps = []
    cur = gh
    converged = True
    gh.ell      # level 0's padded ELL first: past the budget it raises
    while cur.num_vertices > coarse_target and len(levels) < 20:
        agg = _aggregate_two_phase_impl(cur, options, mis2_engine(cur))
        converged = converged and agg.converged
        if agg.num_aggregates >= cur.num_vertices:   # no progress
            break
        label_maps.append(agg.labels)
        weights.append(np.bincount(agg.labels, weights=weights[-1],
                                   minlength=agg.num_aggregates).astype(
                                       np.int64))
        cur = _coarse_graph(cur, agg.labels, agg.num_aggregates)
        graphs.append(cur)
        levels.append((cur.num_vertices, cur.num_entries))

    parts = _greedy_coarse_partition(cur.csr, num_parts, weights[-1])
    parts = _refine(cur, parts, num_parts, weights[-1])
    # project back up
    for labels, fine_g, fine_w in zip(reversed(label_maps),
                                      reversed(graphs[:-1]),
                                      reversed(weights[:-1])):
        parts = parts[labels]
        parts = _refine(fine_g, parts, num_parts, fine_w)

    return PartitionResult(parts.astype(np.int32), num_parts,
                           edge_cut(gh, parts), len(label_maps) + 1, levels,
                           converged)
