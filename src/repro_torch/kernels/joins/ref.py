"""Plain-torch twins of the coarsening's join kernels (``csrc/joins.cu``):
the label joins of paper Algorithms 2 and 3 as the reference computes
them, round for round, over the padded ELL or the hybrid layout.

* :func:`root_join_ref` — ``_labels_from_roots`` and ``_join_adjacent_root``
  (``repro/core/aggregation.py:144-158``, ``:64-79``; hybrid ``:246-278``),
  and with ``cleanup_rounds`` the Alg. 2 cleanup ``_cleanup_join_resident``
  (``:161-181``; hybrid ``:281-301``); :func:`cleanup_join_ref` is that
  cleanup alone, from given labels;
* :func:`phase2_join_ref` — ``_phase2_join_resident`` (``:184-200``;
  hybrid ``:304-329``);
* :func:`phase3_fixed_point_ref` — ``_phase3_resident`` (``:203-229``;
  hybrid ``:371-402`` with ``_phase3_spill``, ``:332-368``).

A :class:`Layout` is the adjacency a join runs over: row maps, each ``(rows
int32 [R] or None, neighbors int32 [R, W], mask bool [R, W])`` (the padded
ELL is one map of every row, ``rows`` None; the hybrid layout one a slab),
and the COO spill ``(rows int32 [H], seg int32 [E], cols int32 [E])``,
empty for the ELL.  The slabs and the spill partition the rows, so a
round evaluated piecewise equals the whole-graph round.

The loops read one flag a round on the host, as the port's drivers did
before the kernels; they are the plain version and no yardstick of speed.
The rowwise bodies (:func:`join_rows`, :func:`count_unagg`,
:func:`phase3_rows`) are also the distributed engine's per-rank rounds
(``core.dist``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.segments import segment_reduce

INT32_MAX = 2**31 - 1
#: the rounds of the Alg. 2 cleanup and of phase 3 (the reference's cap)
JOIN_ROUNDS = 4


class Layout(NamedTuple):
    """Row maps and spill of one graph of ``v`` vertices (see the module
    docstring)."""

    maps: tuple
    spill: tuple
    v: int


def ell_layout(neighbors: torch.Tensor, mask: torch.Tensor) -> Layout:
    """The padded ELL ``[V, D]`` as one map of every row, no spill."""
    none = torch.empty(0, dtype=torch.int32, device=neighbors.device)
    return Layout(((None, neighbors, mask),), (none, none, none),
                  neighbors.shape[0])


def hybrid_layout(hyb) -> Layout:
    """A ``graphs.hybrid.HybridEllGraph``: one map a slab, and its spill."""
    return Layout(tuple((sl.rows, sl.neighbors, sl.mask)
                        for sl in hyb.slices),
                  (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols),
                  hyb.num_vertices)


# ---------------------------------------------------------------------------
# rowwise bodies
# ---------------------------------------------------------------------------

def join_rows(neighbors: torch.Tensor, root_label: torch.Tensor):
    """label[v] = min root label over the row's slots (the padding slots
    hold the row's own id: the closed neighborhood), else -1.

    A vertex adjacent to two distinct roots would contradict distance-2
    independence, so min() is exact, not a tie-break."""
    lab = root_label[neighbors].amin(dim=1)
    return torch.where(lab == INT32_MAX, -1, lab).to(torch.int32)


def count_unagg(neighbors, mask, row_ids, labels):
    """# real neighbors (excluding self) that are unaggregated, for the rows
    ``row_ids`` whose adjacency is ``neighbors``; ``labels`` is ``[V]``."""
    real = mask & (neighbors != row_ids[:, None])
    return (real & (labels[neighbors] < 0)).sum(dim=1, dtype=torch.int32)


def root_labels(roots: torch.Tensor, first) -> torch.Tensor:
    """Aggregate ids ``first, first + 1, ...`` of the roots in row order
    (an exclusive scan), INT32_MAX on the other rows."""
    ids = first + torch.cumsum(roots, dim=0, dtype=torch.int32) - 1
    return torch.where(roots, ids, INT32_MAX).to(torch.int32)


def phase3_rows(neighbors, mask, row_ids, labels, labels_rows, aggsize):
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


def aggsize(labels):
    """Aggregate sizes (slot ``V`` is the dump for unlabeled vertices, so
    entries ``0..nagg-1`` match ``np.bincount``)."""
    v = labels.shape[0]
    return torch.bincount(torch.where(labels >= 0, labels, v),
                          minlength=v + 1).to(torch.int32)


def _spill_parts(spill):
    """(rows, seg, cols) of the spill as int64 index tensors."""
    return tuple(x.to(torch.int64) for x in spill)


def phase3_spill(spill, labels, sizes):
    """Phase-3 body over the spill: the max-coupling adjacent aggregate
    (ties -> smaller size -> smaller label).  Entries are sorted by the
    int64 key ``(segment << 32) | label``, so equal labels of a row form
    runs whose length is the coupling; the lexicographic choice is then a
    cascade of segment reductions (max coupling, min size among those, min
    label among those).  Valid slots are distinct real neighbors in both
    layouts, so the choice equals :func:`phase3_rows`'."""
    rows, seg, cols = _spill_parts(spill)
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
    size_e = sizes[lab_s.clamp(0, sizes.shape[0] - 1)].to(torch.int64)
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


# ---------------------------------------------------------------------------
# the joins over a layout: each map's rowwise body plus the spill's segment
# reductions; every read comes from the round-start labels, the writes go
# to a fresh buffer
# ---------------------------------------------------------------------------

def _map_rows(rows, nbrs):
    """A map's row ids: its ``rows``, or 0..R-1 for the whole-graph ELL."""
    if rows is not None:
        return rows
    return torch.arange(nbrs.shape[0], dtype=nbrs.dtype, device=nbrs.device)


def _scatter(out, rows, vals):
    if rows is None:
        return vals
    out[rows.to(torch.int64)] = vals
    return out


def min_join(layout: Layout, root_label):
    """:func:`join_rows` over every row of the layout; a heavy row takes the
    min over its entries and its own root label (the spill's explicit self
    term stands in for the ELL padding slots)."""
    adj = torch.full_like(root_label, -1)
    for rows, nbrs, _ in layout.maps:
        adj = _scatter(adj, rows, join_rows(nbrs, root_label))
    if layout.spill[0].shape[0]:
        rows, seg, cols = _spill_parts(layout.spill)
        mn = segment_reduce(root_label[cols].to(torch.int64), seg,
                            rows.shape[0], "amin", INT32_MAX)
        mn = torch.minimum(mn, root_label[rows].to(torch.int64))
        adj[rows] = torch.where(mn == INT32_MAX, -1, mn).to(torch.int32)
    return adj


def unagg_counts(layout: Layout, labels):
    """:func:`count_unagg` over every row of the layout (a segment sum over
    the spill)."""
    n_unagg = torch.zeros_like(labels)
    for rows, nbrs, mask in layout.maps:
        n_unagg = _scatter(n_unagg, rows, count_unagg(
            nbrs, mask, _map_rows(rows, nbrs), labels))
    if layout.spill[0].shape[0]:
        rows, seg, cols = _spill_parts(layout.spill)
        hit = (cols != rows[seg]) & (labels[cols] < 0)
        n_sp = torch.zeros(rows.shape[0], dtype=torch.int64,
                           device=labels.device)
        n_sp.index_add_(0, seg, hit.to(torch.int64))
        n_unagg[rows] = n_sp.to(torch.int32)
    return n_unagg


def phase3_round(layout: Layout, labels, sizes):
    """One max-coupling round over every row of the layout."""
    new = labels.clone()
    for rows, nbrs, mask in layout.maps:
        own = labels if rows is None else labels[rows.to(torch.int64)]
        new = _scatter(new, rows, phase3_rows(
            nbrs, mask, _map_rows(rows, nbrs), labels, own, sizes))
    if layout.spill[0].shape[0]:
        new[layout.spill[0].to(torch.int64)] = phase3_spill(
            layout.spill, labels, sizes)
    return new


def cleanup_join_ref(layout: Layout, labels, phase, *,
                     rounds: int = JOIN_ROUNDS, trace=None):
    """Alg. 2 leftover cleanup: up to ``rounds`` min-adjacent-label join
    rounds against the round-start labels, stopping once every vertex is
    labeled; each row joined is marked 3.  ``trace`` (a list) gets each
    round's starting labels."""
    for _ in range(rounds):
        if not bool((labels < 0).any()):      # the twin's host read a round
            break
        if trace is not None:
            trace.append(labels)
        lab_j = torch.where(labels >= 0, labels, INT32_MAX).to(torch.int32)
        adj = min_join(layout, lab_j)
        newly = (labels < 0) & (adj >= 0)
        labels = torch.where(newly, adj, labels)
        phase = torch.where(newly, 3, phase).to(torch.uint8)
    return labels, phase


def root_join_ref(layout: Layout, roots, *, cleanup_rounds: int = 0,
                  trace=None):
    """Phase-1 aggregates (roots and their direct neighbors, ids by the
    roots' order), then ``cleanup_rounds`` rounds of the Alg. 2 cleanup.
    Returns ``(labels int32 [V], phase uint8 [V] (1: joined a root, 3: a
    cleanup round, 0: unlabeled), aux int32 [2]: the aggregates and the
    rows left unlabeled)``."""
    labels = min_join(layout, root_labels(roots, 0))
    phase = (labels >= 0).to(torch.uint8)
    labels, phase = cleanup_join_ref(layout, labels, phase,
                                     rounds=cleanup_rounds, trace=trace)
    aux = torch.stack([roots.sum(dtype=torch.int32),
                       (labels < 0).sum(dtype=torch.int32)])
    return labels, phase, aux


def phase2_join_ref(layout: Layout, labels, phase, in_set2, nagg, *,
                    min_secondary: int):
    """Alg. 3 phase 2: unaggregated-neighbor counts, secondary roots
    (``in_set2`` with at least ``min_secondary`` of them), their ids from
    ``nagg`` (int32 ``[1]``) on in row order, and the root join of the
    unlabeled rows, marked 2.  Returns ``(labels, phase, roots2 bool [V],
    nagg int32 [1])``."""
    n_unagg = unagg_counts(layout, labels)
    roots2 = in_set2 & (n_unagg >= min_secondary)
    adj2 = min_join(layout, root_labels(roots2, nagg))
    newly = (labels < 0) & (adj2 >= 0)
    return (torch.where(newly, adj2, labels),
            torch.where(newly, 2, phase).to(torch.uint8), roots2,
            nagg + roots2.sum(dtype=torch.int32))


def phase3_fixed_point_ref(layout: Layout, labels, phase, *, trace=None):
    """Alg. 3 phase 3: up to four max-coupling join rounds against frozen
    tentative labels, aggregate sizes recounted each round; each row joined
    is marked 3.  ``trace`` (a list) gets each round's starting labels."""
    for _ in range(JOIN_ROUNDS):
        if not bool((labels < 0).any()):      # the twin's host read a round
            break
        if trace is not None:
            trace.append(labels)
        new_labels = phase3_round(layout, labels, aggsize(labels))
        newly = (labels < 0) & (new_labels >= 0)
        phase = torch.where(newly, 3, phase).to(torch.uint8)
        labels = new_labels
    return labels, phase
