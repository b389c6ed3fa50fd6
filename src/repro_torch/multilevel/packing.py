"""Cluster/color row packing for multicolor Gauss-Seidel (paper Alg. 4),
host half of ``repro.multilevel.packing``.

The apply-phase layout is a per-color padded int32 matrix
``rows[c][n_clusters_c, max_len_c]`` (sentinel ``V``), built with numpy
and copied to the device once.
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
