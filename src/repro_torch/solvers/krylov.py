"""Krylov solvers (CG, restarted GMRES) with pluggable preconditioners, on
device tensors (PyTorch port of ``repro.solvers.krylov``).

CG keeps every vector on the device and reads the residual norm on the
host once per iteration, as the reference does, to decide whether to go
on.  GMRES keeps the reference's host Arnoldi basis in float64 and applies
the operator and preconditioner on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

MatVec = Callable[[torch.Tensor], torch.Tensor]
Precond = Callable[[torch.Tensor], torch.Tensor]


@dataclass
class SolveResult:
    x: np.ndarray
    iterations: int
    residual_norm: float
    converged: bool
    residual_history: list


def _identity(x):
    return x


def cg(matvec: MatVec, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       precond: Optional[Precond] = None, tol: float = 1e-12,
       maxiter: int = 1000) -> SolveResult:
    """Preconditioned conjugate gradient. Converges when ||r|| <= tol * ||b||."""
    m = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    b_norm = float(torch.linalg.norm(b))
    if b_norm == 0.0:
        return SolveResult(x.cpu().numpy(), 0, 0.0, True, [])
    r = b - matvec(x)
    z = m(r)
    p = z
    rz = torch.dot(r, z)
    hist = []
    it = 0
    rn = float(torch.linalg.norm(r))
    while rn > tol * b_norm and it < maxiter:
        ap = matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = m(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rn = float(torch.linalg.norm(r))      # the one host read a step
        hist.append(rn)
        it += 1
    return SolveResult(x.cpu().numpy(), it, rn, rn <= tol * b_norm, hist)


def gmres(matvec: MatVec, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
          precond: Optional[Precond] = None, tol: float = 1e-8,
          restart: int = 50, maxiter: int = 800) -> SolveResult:
    """Right-preconditioned restarted GMRES(restart).

    ``maxiter`` counts total inner iterations (the paper's Table VI
    counts).
    """
    m = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    b_norm = float(torch.linalg.norm(b))
    if b_norm == 0.0:
        return SolveResult(x.cpu().numpy(), 0, 0.0, True, [])

    def mv(v: np.ndarray) -> np.ndarray:
        dv = torch.from_numpy(v).to(device=b.device, dtype=b.dtype)
        return matvec(m(dv)).cpu().numpy().astype(np.float64)

    hist = []
    total_it = 0
    rn = None
    prev_beta = None
    best_x, best_beta = x, None
    while total_it < maxiter:
        r = b - matvec(x)
        beta = float(torch.linalg.norm(r))
        if best_beta is None or beta < best_beta:
            best_x, best_beta = x, beta
        if rn is None:
            rn = beta
        if beta <= tol * b_norm:
            return SolveResult(x.cpu().numpy(), total_it, beta, True, hist)
        if prev_beta is not None and beta >= prev_beta * 0.999:
            # fp32 accuracy floor reached: restarts stopped helping
            return SolveResult(best_x.cpu().numpy(), total_it, best_beta,
                               best_beta <= tol * b_norm, hist)
        prev_beta = beta
        n = b.shape[0]
        k_max = min(restart, maxiter - total_it)
        v_basis = np.zeros((k_max + 1, n), dtype=np.float64)
        v_basis[0] = r.cpu().numpy().astype(np.float64) / beta
        h = np.zeros((k_max + 1, k_max), dtype=np.float64)
        cs = np.zeros(k_max)
        sn = np.zeros(k_max)
        g = np.zeros(k_max + 1)
        g[0] = beta
        k_used = 0
        for k in range(k_max):
            w = mv(v_basis[k])
            # modified Gram-Schmidt
            for j in range(k + 1):
                h[j, k] = np.dot(v_basis[j], w)
                w = w - h[j, k] * v_basis[j]
            h[k + 1, k] = np.linalg.norm(w)
            if h[k + 1, k] > 1e-300:
                v_basis[k + 1] = w / h[k + 1, k]
            # apply stored Givens rotations
            for j in range(k):
                t = cs[j] * h[j, k] + sn[j] * h[j + 1, k]
                h[j + 1, k] = -sn[j] * h[j, k] + cs[j] * h[j + 1, k]
                h[j, k] = t
            denom = np.hypot(h[k, k], h[k + 1, k])
            cs[k], sn[k] = h[k, k] / denom, h[k + 1, k] / denom
            h[k, k] = denom
            h[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            k_used = k + 1
            total_it += 1
            rn = abs(g[k + 1])
            hist.append(rn)
            if rn <= tol * b_norm:
                break
        # solve the small triangular system and update x
        y = np.linalg.solve(h[:k_used, :k_used], g[:k_used])
        update = torch.from_numpy(v_basis[:k_used].T @ y).to(
            device=b.device, dtype=b.dtype)
        x = x + m(update)
        if rn <= tol * b_norm:
            return SolveResult(x.cpu().numpy(), total_it, float(rn), True,
                               hist)
    r = b - matvec(x)
    rn = float(torch.linalg.norm(r))
    return SolveResult(x.cpu().numpy(), total_it, rn, rn <= tol * b_norm, hist)
