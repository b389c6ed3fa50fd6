"""Point and cluster multicolor Gauss-Seidel (paper Alg. 4 + §III-C),
PyTorch port of ``repro.solvers.multicolor_gs``.

Cluster multicolor GS: coarsen the graph with MIS-2 aggregation, color the
*coarse* graph, then within one coarse color update all clusters in
parallel while rows inside a cluster update sequentially.  Point GS is the
same structure with singleton clusters on a coloring of the fine graph.

Data layout: per color a padded int32 matrix ``rows[c][n_clusters_c,
max_len_c]`` (sentinel ``V``).  One step updates column ``s`` of one color
block: the rows of one step are never adjacent, so they update together.
The iterate lives in a ``[V + 1]`` buffer whose last slot takes the
sentinel rows' writes and is sliced off.  Each step's rows, their ELL
slots and diagonal are gathered once, when the preconditioner is first
applied.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..core.coloring import _color_graph_impl
from ..graphs.csr import ELLMatrix
from ..graphs.handle import as_graph
from ..graphs.ops import extract_diagonal
from ..multilevel.packing import pack_clusters_host


@dataclass
class MulticolorGSPreconditioner:
    ell: ELLMatrix
    diag: torch.Tensor
    color_rows: tuple           # tuple of int32 [n_clusters_c, max_len_c]
    num_colors: int
    num_clusters: int
    setup_seconds: float
    kind: str                   # 'point' | 'cluster'
    timings: dict = field(default_factory=dict)  # setup-phase split
    #                          (aggregate / color / pack seconds)

    @functools.cached_property
    def steps(self) -> list:
        """Per step of a forward sweep: ``(rows, safe rows, their ELL cols,
        vals and diagonal)``, ``rows`` int64 with sentinel ``V``."""
        v = self.ell.cols.shape[0]
        out = []
        for rows_c in self.color_rows:
            for s in range(rows_c.shape[1]):
                rows = rows_c[:, s].to(torch.int64)
                safe = rows.clamp(max=v - 1)
                out.append((rows, safe, self.ell.cols[safe].to(torch.int64),
                            self.ell.vals[safe], self.diag[safe]))
        return out

    @property
    def num_steps(self) -> int:
        """Sequential depth of one forward sweep: sum of ``max_len_c``."""
        return sum(int(r.shape[1]) for r in self.color_rows)

    def apply(self, b: torch.Tensor, sweeps: int = 1,
              symmetric: bool = True) -> torch.Tensor:
        """Approximate A^-1 b by ``sweeps`` (S)GS sweeps from x0 = 0."""
        return _apply_sweeps(self.steps, b, sweeps, symmetric)

    def as_precond(self, sweeps: int = 1, symmetric: bool = True) -> Callable:
        return functools.partial(self.apply, sweeps=sweeps,
                                 symmetric=symmetric)


def _row_update(x, b, rows, safe, a_cols, a_vals, diag_rows) -> None:
    """GS update of ``rows`` in the ``[V + 1]`` iterate ``x``, in place."""
    ax = (a_vals * x[a_cols]).sum(dim=1)         # A_i . x
    x[rows] = x[safe] + (b[safe] - ax) / diag_rows


def _apply_sweeps(steps, b: torch.Tensor, sweeps: int,
                  symmetric: bool) -> torch.Tensor:
    v = b.shape[0]
    x = torch.zeros(v + 1, dtype=b.dtype, device=b.device)
    for _ in range(sweeps):
        for step in steps:                      # forward color sweep
            _row_update(x, b, *step)
        if symmetric:
            for step in reversed(steps):
                _row_update(x, b, *step)
    return x[:v]


def setup_point_gs(a) -> MulticolorGSPreconditioner:
    """Point multicolor GS of matrix ``a`` (a ``Graph`` with values): colors
    the fine graph, singleton clusters."""
    gh = as_graph(a)
    dev = gh.device
    t0 = time.perf_counter()
    v = gh.num_vertices
    t_color = time.perf_counter()
    coloring = _color_graph_impl(gh)           # colors the FINE graph
    t_color = time.perf_counter() - t_color
    if not coloring.converged:     # a partial coloring is unusable for GS
        raise RuntimeError("fine-graph coloring did not converge")
    t_pack = time.perf_counter()
    labels = np.arange(v, dtype=np.int32)      # singleton clusters
    color_rows = pack_clusters_host(labels, coloring.colors,
                                    coloring.num_colors, v, dev)
    t_pack = time.perf_counter() - t_pack
    return MulticolorGSPreconditioner(
        gh.ell_matrix, extract_diagonal(gh.csr_matrix, dev), color_rows,
        coloring.num_colors, v, time.perf_counter() - t0, "point",
        timings={"aggregate": 0.0, "color": t_color, "pack": t_pack})
