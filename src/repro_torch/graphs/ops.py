"""Sparse operations of the multilevel setup and the solve (PyTorch port of
``repro.graphs.ops``).

* :func:`spmv_ell` — ``y = A x`` over a device ELL matrix, through the
  hand-written SpMV kernel (``kernels.spmv_ell``);
* :func:`extract_diagonal` — the diagonal of a CSR matrix, on a device;
  :func:`ell_diagonal` — that of a device ELL matrix;
* :func:`matrix_to_scipy`, :func:`coarse_graph_from_labels`,
  :func:`galerkin_coarse_matrix` — host-side setup work on numpy/scipy,
  returning host containers, as in the reference (the scipy Galerkin
  product is the tests' oracle).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.spmv_ell import ops as spmv_ops
from .csr import CSRGraph, CSRMatrix, ELLMatrix, csr_from_coo


def spmv_ell(m: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in ELL form (padding has vals == 0)."""
    return spmv_ops.spmv(m.cols, m.vals, x)


def coarse_graph_from_labels(g: CSRGraph, labels: np.ndarray,
                             num_aggregates: int) -> CSRGraph:
    """Coarse graph: aggregate a ~ aggregate b iff a fine edge links them.

    Includes self loops (diagonal), as the coarse matrix would.
    """
    labels = np.asarray(labels)
    rows = np.repeat(np.arange(g.num_vertices), np.diff(g.indptr))
    cr, cc = labels[rows], labels[g.indices]
    keep = (cr >= 0) & (cc >= 0)
    cr, cc = cr[keep], cc[keep]
    diag = np.arange(num_aggregates, dtype=np.int64)
    cr = np.concatenate([cr.astype(np.int64), diag])
    cc = np.concatenate([cc.astype(np.int64), diag])
    return csr_from_coo(cr, cc, num_aggregates)


def galerkin_coarse_matrix(a: CSRMatrix, p_rows: np.ndarray,
                           p_cols: np.ndarray, p_vals: np.ndarray,
                           num_aggregates: int) -> CSRMatrix:
    """A_c = P^T A P with P given in COO (host, scipy; setup-time)."""
    import scipy.sparse as sp

    p = sp.csr_matrix((np.asarray(p_vals, dtype=np.float64),
                       (p_rows, p_cols)), shape=(a.num_rows, num_aggregates))
    ac = (p.T @ matrix_to_scipy(a) @ p).tocsr()
    ac.sort_indices()
    ac.eliminate_zeros()
    return CSRMatrix(ac.indptr.astype(np.int32), ac.indices.astype(np.int32),
                     ac.data.astype(np.float32))


def matrix_to_scipy(a: CSRMatrix):
    import scipy.sparse as sp

    v = a.num_rows
    return sp.csr_matrix((np.asarray(a.values, dtype=np.float64),
                          np.asarray(a.indices, dtype=np.int64),
                          np.asarray(a.indptr, dtype=np.int64)), shape=(v, v))


def extract_diagonal(a: CSRMatrix,
                     device: torch.device | str) -> torch.Tensor:
    """The diagonal of ``a`` (0 where a row has no diagonal entry), as a
    tensor on ``device``."""
    v = a.num_rows
    rows = np.repeat(np.arange(v), np.diff(a.indptr))
    d = np.zeros(v, dtype=a.values.dtype)
    on_diag = rows == a.indices
    d[rows[on_diag]] = a.values[on_diag]
    return torch.from_numpy(d).to(device)


def ell_diagonal(a: ELLMatrix) -> torch.Tensor:
    """The diagonal of a device ELL matrix (0 where a row has none), on its
    device: each row's one diagonal slot, so the sum is exact."""
    rid = torch.arange(a.num_rows, device=a.cols.device)
    return torch.where((a.cols == rid[:, None]) & a.mask, a.vals,
                       torch.zeros((), dtype=a.vals.dtype,
                                   device=a.vals.device)).sum(dim=1)
