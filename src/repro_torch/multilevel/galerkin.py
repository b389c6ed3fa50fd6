"""Galerkin triple product ``A_c = P^T A P``, host half of
``repro.multilevel.galerkin``: the canonical two-stage padded sorted-COO
SpGEMM on numpy.

* stage 1 — ``Q = A P``: expand every (A slot, P-row slot) candidate
  ``A[v,w] * P[w,b]`` in fixed ``(v, j, l)`` order, stable-sort by the key
  ``v*K + b``, sum each run sequentially in sorted order, drop exact-zero
  sums, repack to a padded ``[V, Dq]`` row form;
* stage 2 — ``A_c = P^T Q``: expand ``P[v,a] * Q[v,b]`` in fixed
  ``(v, i, m)`` order, stable-sort by ``a*K + b``, run-sum, zero-drop.

The code is the reference's, operation for operation, so the coarse
values — and the per-level digests — are bit-identical to it.
"""
from __future__ import annotations

import numpy as np


def _run_sums_host(keys, vals):
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    vals = vals[order]
    head = np.ones(len(keys), dtype=bool)
    if len(keys):
        head[1:] = keys[1:] != keys[:-1]
    rid = np.cumsum(head) - 1
    totals = np.zeros(int(rid[-1]) + 1 if len(rid) else 0, dtype=np.float64)
    np.add.at(totals, rid, vals)
    hkeys = keys[head]
    keep = totals != 0.0
    return hkeys[keep], totals[keep]


def galerkin_coo_host(a_cols: np.ndarray, a_vals: np.ndarray,
                      a_mask: np.ndarray, p_cols: np.ndarray,
                      p_vals64: np.ndarray, num_aggregates: int):
    """Canonical two-stage Galerkin product on the host.

    ``a_*`` is A's padded ELL ``[V, D]`` as numpy; ``p_cols``/``p_vals64``
    the padded P row form (padded slots ``col 0, val 0.0``).  Returns
    ``(rows, cols, vals_f64)`` of the kept (nonzero) coarse entries, sorted
    by (row, col).
    """
    v = a_cols.shape[0]
    key_base = max(1, v, int(num_aggregates))
    a_vals = np.where(a_mask, np.asarray(a_vals, dtype=np.float64), 0.0)
    # stage 1: Q = A P
    w = a_cols
    vals1 = (a_vals[:, :, None] * p_vals64[w]).reshape(-1)
    vids = np.arange(v, dtype=np.int64)
    keys1 = np.broadcast_to(
        vids[:, None, None] * key_base + p_cols.astype(np.int64)[w],
        (v, a_cols.shape[1], p_cols.shape[1])).reshape(-1)
    qkeys, qvals = _run_sums_host(keys1, vals1)
    q_cols, q_vals = _pad_p_rows(qkeys // key_base, qkeys % key_base,
                                 qvals, v)
    # stage 2: A_c = P^T Q
    vals2 = (p_vals64[:, :, None] * q_vals[:, None, :]).reshape(-1)
    keys2 = np.broadcast_to(
        p_cols.astype(np.int64)[:, :, None] * key_base
        + q_cols.astype(np.int64)[:, None, :],
        (v, p_cols.shape[1], q_cols.shape[1])).reshape(-1)
    ckeys, cvals = _run_sums_host(keys2, vals2)
    return (ckeys // key_base).astype(np.int64), \
        (ckeys % key_base).astype(np.int64), cvals


def _pad_p_rows(p_rows: np.ndarray, p_cols: np.ndarray, p_vals: np.ndarray,
                nrows: int, width: int | None = None):
    """COO prolongator -> padded row form (f64 vals; padding col 0/val 0),
    rows sorted by (row, col) like ``scipy.sparse.csr_matrix``."""
    order = np.lexsort((p_cols, p_rows))
    rows, cols = p_rows[order], p_cols[order]
    vals = np.asarray(p_vals, dtype=np.float64)[order]
    counts = np.bincount(rows, minlength=nrows)
    d = int(width) if width is not None else max(1, int(counts.max()) if
                                                 len(counts) else 1)
    cmat = np.zeros((nrows, d), dtype=np.int32)
    vmat = np.zeros((nrows, d), dtype=np.float64)
    slot = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts, counts)
    cmat[rows, slot] = cols
    vmat[rows, slot] = vals
    return cmat, vmat
