"""Sparse operations of the multilevel setup and the solve (PyTorch port of
``repro.graphs.ops``).

* :func:`spmv_ell` — ``y = A x`` over a device ELL matrix, through the
  hand-written SpMV kernel (``kernels.spmv_ell``); :func:`spmv_csr_segment`
  — the same product as a segment sum over the CSR entries (the
  no-coalescing baseline layout, plain torch, as the reference computes it
  outside any Pallas kernel);
* :func:`neighbor_min`, :func:`neighbor_all_eq`, :func:`neighbor_any_eq`
  — the closed-neighbourhood reductions of the MIS-2 inner loops over a
  device ELL graph;
* :func:`graph_power2` — ``G^2`` with self loops (host, scipy);
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
from .csr import CSRGraph, CSRMatrix, ELLGraph, ELLMatrix, csr_from_coo


def spmv_ell(m: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in ELL form (padding has vals == 0)."""
    return spmv_ops.spmv(m.cols, m.vals, x)


def spmv_csr_segment(m: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x as a segment sum of the CSR entries' products, on ``x``'s
    device (the host CSR is copied there)."""
    dev = x.device
    indptr = torch.from_numpy(np.asarray(m.indptr, dtype=np.int64)).to(dev)
    cols = torch.from_numpy(np.asarray(m.indices, dtype=np.int64)).to(dev)
    vals = torch.from_numpy(np.asarray(m.values)).to(dev)
    rows = torch.repeat_interleave(
        torch.arange(m.num_rows, device=dev), torch.diff(indptr),
        output_size=m.num_entries)
    dtype = torch.promote_types(vals.dtype, x.dtype)
    y = torch.zeros(m.num_rows, dtype=dtype, device=dev)
    return y.index_add_(0, rows, vals * x[cols])


def neighbor_min(ell: ELLGraph, t: torch.Tensor) -> torch.Tensor:
    """min over w in N[v] of t[w] (closed: the self padding counts v)."""
    return t[ell.neighbors].amin(dim=1)


def neighbor_all_eq(ell: ELLGraph, m: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    """For all w in N[v]: m[w] == t[v] (closed; a pad slot gives m[v])."""
    return (m[ell.neighbors] == t[:, None]).all(dim=1)


def neighbor_any_eq(ell: ELLGraph, m: torch.Tensor, value) -> torch.Tensor:
    """Exists w in N[v]: m[w] == value (closed)."""
    return (m[ell.neighbors] == value).any(dim=1)


def graph_power2(g: CSRGraph) -> CSRGraph:
    """G^2 with self loops (host, scipy): Lemma IV.2's graph, MIS-1(G^2) ==
    MIS-2(G)."""
    import scipy.sparse as sp

    v = g.num_vertices
    a = sp.csr_matrix((np.ones(g.num_entries, dtype=np.int8),
                       np.asarray(g.indices, dtype=np.int64),
                       np.asarray(g.indptr, dtype=np.int64)), shape=(v, v))
    a = a + sp.identity(v, dtype=np.int8, format="csr")
    a2 = (a @ a).tocsr()
    a2.sort_indices()
    return CSRGraph(a2.indptr.astype(np.int32), a2.indices.astype(np.int32))


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
