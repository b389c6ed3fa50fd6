"""Tentative + damped-Jacobi-smoothed prolongator
(``repro.multilevel.prolongator``): ``P0[v, agg(v)] = 1/sqrt(|agg|)``, then
``P = (I - omega D^-1 A) P0`` in float64, and the rectangular ELL form of P
and R on the device.

The ``host`` engine builds P in COO with scipy; the ``resident`` engine
builds it on the device from the aggregation labels, bit for bit scipy's:
``A P0``'s entries summed by the run-sum kernel in A-slot order (scipy's
SMMP order, a stable sort by ``(row, label)`` keeping it), then the
rounded product ``(omega / D) * (A P0)`` and the rounded subtraction from
P0, each its own elementwise op (so nothing is contracted into an FMA),
and exact zeros dropped as scipy's sparse ops drop them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graphs.csr import ELLMatrix, ell_matrix_to
from ..graphs.ops import ell_diagonal, matrix_to_scipy
from .galerkin import _coo_rows_repack_device, _run_sums_device


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


def _inv_sqrt_sizes(labels: np.ndarray, nagg: int,
                    device: torch.device) -> torch.Tensor:
    """``1 / sqrt(|agg|)`` per aggregate, float64, on ``device``: computed
    from the host labels with numpy, as scipy's P0 holds it (torch's CPU
    ``sqrt`` is not correctly rounded in float64), then copied over."""
    sizes = np.bincount(labels, minlength=nagg).astype(np.float64)
    return torch.from_numpy(1.0 / np.sqrt(sizes)).to(device)


def _prolongator_device(a: ELLMatrix, labels: np.ndarray, nagg: int,
                        omega: float):
    """Smoothed prolongator of the level's float32 ELL ``a`` from the
    aggregation's host ``labels``, on a's device, in padded float64 row form
    ``(cols, vals64, mask)`` ``[V, Dp]`` (each row by ascending column;
    padding col 0, val 0.0), with the level's float32 diagonal.

    Two stages: the run sums of ``A P0`` (scan), then the smoothing, the
    zero drop and the repack (finish)."""
    v = a.num_rows
    dev = a.cols.device
    inv_sqrt = _inv_sqrt_sizes(labels, nagg, dev)
    labels = torch.from_numpy(np.asarray(labels, dtype=np.int64)).to(dev)
    # scan: X = A P0, entry (v, label(w)) summed over A's slots in order;
    # every run, zero sums too: P0's entry (v, label(v)) stays where X's
    # is exactly zero (scipy drops that X entry, not the P0 one)
    lab_w = labels[a.cols.to(torch.int64)]
    keys = (torch.arange(v, device=dev)[:, None] * v + lab_w)[a.mask]
    x_keys, x, _ = _run_sums_device(
        keys, (a.vals.to(torch.float64) * inv_sqrt[lab_w])[a.mask])
    # finish: P = P0 - (omega D^-1) X, both rounded, exact zeros dropped
    diag = ell_diagonal(a)
    scale = torch.ones(v, dtype=torch.float64, device=dev).div_(
        diag.to(torch.float64)).mul_(omega)
    rows, cols = x_keys // v, x_keys % v
    tent = torch.where(cols == labels[rows], inv_sqrt[cols],
                       torch.zeros((), dtype=torch.float64, device=dev))
    smoothed = scale[rows] * x
    vals = tent - smoothed
    keep = vals != 0.0
    return (*_coo_rows_repack_device(x_keys[keep], vals[keep], v, v), diag)


def _prolongator_pack_device(p_cols, p_vals64, p_mask, num_aggregates: int):
    """P and R as float32 ELL in ``rect_ell``'s layout (padding col 0, val
    0, mask off; each row by ascending column) from P's padded row form,
    R's entries through one stable sort by ``col * V + row``."""
    v = p_cols.shape[0]
    rows = torch.arange(v, device=p_cols.device)[:, None].expand_as(
        p_cols)[p_mask]
    keys, order = torch.sort(p_cols[p_mask].to(torch.int64) * v + rows,
                             stable=True)
    r_cols, r_vals, r_mask = _coo_rows_repack_device(
        keys, p_vals64[p_mask][order], v, num_aggregates)
    return (ELLMatrix(p_cols, p_vals64.to(torch.float32), p_mask),
            ELLMatrix(r_cols, r_vals.to(torch.float32), r_mask))
