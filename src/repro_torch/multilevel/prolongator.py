"""Tentative + damped-Jacobi-smoothed prolongator, host half of
``repro.multilevel.prolongator``: ``P0[v, agg(v)] = 1/sqrt(|agg|)``, then
``P = (I - omega D^-1 A) P0`` in f64 COO with scipy, and the rectangular
ELL form of P and R on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graphs.csr import ELLMatrix, ell_matrix_to
from ..graphs.ops import matrix_to_scipy


def smoothed_prolongator_host(a, labels: np.ndarray, nagg: int,
                              omega: float):
    """``P = (I - omega D^-1 A) P0`` in COO (host scipy, f64)."""
    import scipy.sparse as sp

    asp = matrix_to_scipy(a)
    v = a.num_rows
    sizes = np.bincount(labels, minlength=nagg).astype(np.float64)
    p0 = sp.csr_matrix(
        (1.0 / np.sqrt(sizes[labels]), (np.arange(v), labels)),
        shape=(v, nagg))
    d_inv = 1.0 / asp.diagonal()
    p = p0 - omega * sp.diags(d_inv) @ (asp @ p0)
    p = p.tocoo()
    return p.row, p.col, p.data


def rect_ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
             nrows: int, device: torch.device | str) -> ELLMatrix:
    """Rectangular ELL from COO (for P and R; padding col 0, val 0), each
    row's entries in ascending column order, on ``device``."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=nrows)
    d = max(1, int(counts.max()) if len(counts) else 1)
    cmat = np.zeros((nrows, d), dtype=np.int32)
    vmat = np.zeros((nrows, d), dtype=np.float32)
    mmat = np.zeros((nrows, d), dtype=bool)
    slot = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts, counts)
    cmat[rows, slot] = cols
    vmat[rows, slot] = vals
    mmat[rows, slot] = True
    return ell_matrix_to((cmat, vmat, mmat), device)
