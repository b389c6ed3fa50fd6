"""Cluster/color row packing for multicolor Gauss-Seidel (paper Alg. 4),
``repro.multilevel.packing``.

The apply-phase layout is a per-color padded int32 matrix
``rows[c][n_clusters_c, max_len_c]`` (sentinel ``V``).  The ``host``
engine builds it with numpy and copies it to the device; the ``resident``
engine builds it on the device (one stable sort by (color, cluster), one
scatter into a ``[clusters, max_len]`` block) and hands out per-color
slices of that block, elementwise the host arrays; only the per-color
cluster counts and row lengths come to the host.
"""
from __future__ import annotations

import numpy as np
import torch


def pack_clusters_host(labels: np.ndarray, cluster_colors: np.ndarray,
                       num_colors: int, v: int,
                       device: torch.device | str) -> tuple:
    """Group rows by (color(cluster), cluster) into padded per-color
    arrays; a cluster's rows in ascending vertex order."""
    order = np.lexsort((np.arange(v), labels))
    sorted_labels = labels[order]
    starts = np.flatnonzero(np.r_[True, sorted_labels[1:]
                                  != sorted_labels[:-1]])
    ends = np.r_[starts[1:], v]
    cluster_ids = sorted_labels[starts]
    color_rows = []
    for c in range(num_colors):
        sel = np.flatnonzero(cluster_colors[cluster_ids] == c)
        if len(sel) == 0:
            continue
        lens = ends[sel] - starts[sel]
        mat = np.full((len(sel), int(lens.max())), v, dtype=np.int32)
        for i, s in enumerate(sel):
            mat[i, : lens[i]] = order[starts[s]:ends[s]]
        color_rows.append(torch.from_numpy(mat).to(device))
    return tuple(color_rows)


def _pack_analyze_device(labels: torch.Tensor, cluster_colors: torch.Tensor,
                         num_colors: int):
    """Vertices sorted by (cluster color, cluster, vertex) and, per color,
    its cluster count and longest cluster, int64 on the device."""
    v = labels.shape[0]
    c = max(1, num_colors)
    key = cluster_colors[labels] * v + labels
    row_order = torch.sort(key, stable=True).indices
    lab_s = labels[row_order]
    sizes = torch.bincount(labels, minlength=v)
    head = torch.ones(v, dtype=torch.bool, device=labels.device)
    head[1:] = lab_s[1:] != lab_s[:-1]
    color = torch.where(head, cluster_colors[lab_s].clamp(0, c), c)
    nclusters = torch.bincount(color, minlength=c + 1)[:c]
    maxlen = torch.zeros(c + 1, dtype=torch.int64, device=labels.device)
    maxlen.scatter_reduce_(0, color, sizes[lab_s], "amax")
    return row_order, nclusters, maxlen[:c]


def _pack_rows_device(row_order: torch.Tensor, labels: torch.Tensor,
                      num_clusters: int, max_len: int) -> torch.Tensor:
    """The sorted vertices in one ``[num_clusters, max_len]`` int32 block
    (sentinel V), cluster rows by (color, cluster id): the per-color host
    matrices stacked."""
    v = labels.shape[0]
    lab_s = labels[row_order]
    head = torch.ones(v, dtype=torch.bool, device=labels.device)
    head[1:] = lab_s[1:] != lab_s[:-1]
    crow = torch.cumsum(head, 0) - 1                  # cluster rank
    pos = torch.arange(v, device=labels.device)
    start = torch.cummax(torch.where(head, pos, 0), 0).values
    block = torch.full((num_clusters, max_len), v, dtype=torch.int32,
                       device=labels.device)
    block[crow, pos - start] = row_order.to(torch.int32)
    return block


def pack_clusters_device(labels: np.ndarray, cluster_colors: np.ndarray,
                         num_colors: int, v: int,
                         device: torch.device | str) -> tuple:
    """:func:`pack_clusters_host`'s tuple, built on ``device``: slices of
    one device block; only the per-color geometry comes to the host."""
    lab = torch.from_numpy(np.asarray(labels, dtype=np.int64)).to(device)
    col = torch.from_numpy(np.asarray(cluster_colors, dtype=np.int64)).to(
        device)
    row_order, nclusters, maxlen = _pack_analyze_device(lab, col, num_colors)
    ncl = nclusters.tolist()
    mll = maxlen.tolist()
    block = _pack_rows_device(row_order, lab, max(1, sum(ncl)),
                              max(mll, default=1))
    color_rows, start = [], 0
    for n, m in zip(ncl, mll):
        if n:
            color_rows.append(block[start:start + n, :m])
            start += n
    return tuple(color_rows)
