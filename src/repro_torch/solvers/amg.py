"""The SA-AMG solve phase (PyTorch port of ``repro.solvers.amg``): the
V-cycle with damped-Jacobi pre- and post-smoothing.

Every ELL SpMV — the smoother's, the residual's, the prolongation's and the
restriction through R — goes through the SpMV kernel
(``kernels.spmv_ell.ops.spmv``); without an explicit R the restriction is
the transposed kernel on P (``spmv_t``).  Per level and V-cycle that is
``2 * sweeps + 3`` launches of ``spmv`` with R, or ``2 * sweeps + 2`` and
one ``spmv_t`` without; the coarsest level is one dense solve.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graphs.csr import ELLMatrix
from ..kernels.spmv_ell import ops as spmv_ops


def _spmv(ell: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    return spmv_ops.spmv(ell.cols, ell.vals, x)


def _jacobi(ell: ELLMatrix, diag, x, b, weight: float, sweeps: int):
    for _ in range(sweeps):
        x = x + weight * (b - _spmv(ell, x)) / diag
    return x


def v_cycle(h, b: torch.Tensor, level: int = 0) -> torch.Tensor:
    """One V-cycle of hierarchy ``h`` (an ``AMGHierarchy``) on ``b``."""
    lvl = h.levels[level]
    if lvl.p_ell is None:
        return h.coarse_solve(b)
    w = float(np.float32(h.jacobi_weight))
    x = _jacobi(lvl.a_ell, lvl.diag, torch.zeros_like(b), b, w,
                h.smoother_sweeps)
    r = b - _spmv(lvl.a_ell, x)
    if lvl.r_ell is not None:
        rc = _spmv(lvl.r_ell, r)
    else:       # matrix-free restriction: R = P^T via the transposed SpMV
        rc = spmv_ops.spmv_t(lvl.p_ell.vals, lvl.p_t, r)
    xc = v_cycle(h, rc, level + 1)
    x = x + _spmv(lvl.p_ell, xc)
    return _jacobi(lvl.a_ell, lvl.diag, x, b, w, h.smoother_sweeps)
