"""Galerkin triple product ``A_c = P^T A P``
(``repro.multilevel.galerkin``): the canonical two-stage padded sorted-COO
SpGEMM, on numpy for the ``host`` engine and on the device for the
``resident`` one.

* stage 1 — ``Q = A P``: expand every (A slot, P-row slot) candidate
  ``A[v,w] * P[w,b]`` in fixed ``(v, j, l)`` order, stable-sort by the key
  ``v*K + b``, sum each run sequentially in sorted order, drop exact-zero
  sums, repack to a padded ``[V, Dq]`` row form;
* stage 2 — ``A_c = P^T Q``: expand ``P[v,a] * Q[v,b]`` in fixed
  ``(v, i, m)`` order, stable-sort by ``a*K + b``, run-sum, zero-drop.

The host code is the reference's, operation for operation, so the coarse
values — and the per-level digests — are bit-identical to it.  The device
stages keep that order: ``torch.sort(stable=True)`` on the int64 keys and
each run summed in sorted order by the run-sum kernel
(``kernels/run_sums``; ``index_add_`` and its kin add in no fixed order on
the card), each product its own rounded multiply.  They expand the real
slots only: a padded slot's candidate is ``±0.0``, which changes no
nonzero sum, and a run whose sum is exactly zero is dropped either way.
The reference's dense-accumulator variants are not ported: their bits
rest on a scatter-add in candidate order, which the card's atomics do not
keep.

The coarse graph of cluster Gauss-Seidel (``_coarse_graph_*``) is the
integer counterpart: the sorted unique coarse-edge keys, repacked.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graphs.csr import CSRMatrix, ELLGraph, ELLMatrix
from ..kernels.run_sums import ops as run_ops


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


# ---------------------------------------------------------------------------
# device stages (the resident engine)
# ---------------------------------------------------------------------------

def _sorted_runs(keys: torch.Tensor, vals: torch.Tensor):
    """Stable-sort ``(keys, vals)`` by key: ``(keys, vals, starts)`` with
    ``starts`` the first position of each run of equal keys (the run-sum
    kernel's input)."""
    keys, order = torch.sort(keys, stable=True)
    head = torch.ones_like(keys, dtype=torch.bool)
    head[1:] = keys[1:] != keys[:-1]
    return keys, vals[order], torch.nonzero(head).squeeze(1)


def _run_sums_device(keys: torch.Tensor, vals: torch.Tensor):
    """Stable-sort ``(keys, vals)`` and sum each run of equal keys in
    sorted order.  Returns ``(keys, sums, keep)`` per run, sorted by key,
    with ``keep = sum != 0``."""
    return run_ops.run_sums(*_sorted_runs(keys, vals))


def _kept_run_sums(keys: torch.Tensor, vals: torch.Tensor):
    """:func:`_run_sums_device`'s kept runs: ``(keys, sums)``, exact-zero
    sums dropped."""
    run_keys, sums, keep = _run_sums_device(keys, vals)
    return run_keys[keep], sums[keep]


def _kept_row_slots(rows: torch.Tensor, num_rows: int, min_width: int = 1):
    """Within-row slot of each entry of a row-sorted stream, and the padded
    width (at least ``min_width``): the one shape scalar a repack brings
    back."""
    counts = torch.bincount(rows, minlength=num_rows)
    width = max(min_width, int(counts.max()) if rows.numel() else 0)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(rows.shape[0], device=rows.device) - starts[rows]
    return slot, width


def _spgemm_stage1_device(a_cols, a_vals, a_mask, p_cols, p_vals64, p_mask,
                          key_base: int):
    """``Q = A P``: the real candidates ``A[v,w] * P[w,b]`` in ``(v, j, l)``
    order under the keys ``v*K + b``, run-summed.  ``A`` is the level's
    float32 ELL, ``P`` its padded float64 row form.  Returns the kept
    ``(keys, sums)``, sorted."""
    v = a_cols.shape[0]
    w = a_cols.to(torch.int64)
    real = a_mask[:, :, None] & p_mask[w]
    vals = (a_vals.to(torch.float64)[:, :, None] * p_vals64[w])[real]
    vids = torch.arange(v, dtype=torch.int64, device=a_cols.device)
    keys = (vids[:, None, None] * key_base
            + p_cols[w].to(torch.int64))[real]
    return _kept_run_sums(keys, vals)


def _coo_rows_repack_device(keys, sums, key_base: int, num_rows: int):
    """Kept sorted entries -> padded float64 row form ``(cols[R, W],
    vals64[R, W], mask[R, W])`` (padding col 0, val 0.0): stage 2's Q."""
    rows = keys // key_base
    slot, width = _kept_row_slots(rows, num_rows)
    dev = keys.device
    cols = torch.zeros((num_rows, width), dtype=torch.int32, device=dev)
    vals = torch.zeros((num_rows, width), dtype=torch.float64, device=dev)
    mask = torch.zeros((num_rows, width), dtype=torch.bool, device=dev)
    cols[rows, slot] = (keys % key_base).to(torch.int32)
    vals[rows, slot] = sums
    mask[rows, slot] = True
    return cols, vals, mask


def _stage2_candidates(p_cols, p_vals64, p_mask, q_cols, q_vals64, q_mask,
                       key_base: int):
    """``A_c = P^T Q``'s real candidates ``P[v,a] * Q[v,b]`` in ``(v, i,
    m)`` order and their keys ``a*K + b``: ``(keys, vals)``."""
    real = p_mask[:, :, None] & q_mask[:, None, :]
    vals = (p_vals64[:, :, None] * q_vals64[:, None, :])[real]
    keys = (p_cols.to(torch.int64)[:, :, None] * key_base
            + q_cols.to(torch.int64)[:, None, :])[real]
    return keys, vals


def _spgemm_stage2_device(p_cols, p_vals64, p_mask, q_cols, q_vals64, q_mask,
                          key_base: int):
    """``A_c = P^T Q``: :func:`_stage2_candidates` run-summed.  Returns the
    kept ``(keys, sums)``, sorted by (coarse row, col)."""
    return _kept_run_sums(*_stage2_candidates(
        p_cols, p_vals64, p_mask, q_cols, q_vals64, q_mask, key_base))


def _self_padded_ell(rows, cols, num_rows: int, width: int, slot):
    """``(cols[R, W] int32, mask[R, W])`` with padding ``col = row``."""
    dev = rows.device
    out = torch.arange(num_rows, dtype=torch.int32, device=dev)[:, None] \
        .repeat(1, width)
    mask = torch.zeros((num_rows, width), dtype=torch.bool, device=dev)
    out[rows, slot] = cols.to(torch.int32)
    mask[rows, slot] = True
    return out, mask


def _coo_to_ell_device(keys, sums, key_base: int,
                       num_rows: int) -> ELLMatrix:
    """Kept sorted coarse entries -> square float32 ELL in
    ``csr_to_ell_matrix``'s convention (padding ``col = row``, val 0, mask
    off; width the longest row, 0 for an empty matrix), so its digest is
    the host engine's."""
    rows = keys // key_base
    slot, width = _kept_row_slots(rows, num_rows, min_width=0)
    cols, mask = _self_padded_ell(rows, keys % key_base, num_rows, width,
                                  slot)
    vals = torch.zeros((num_rows, width), dtype=torch.float32,
                       device=keys.device)
    vals[rows, slot] = sums.to(torch.float32)
    return ELLMatrix(cols, vals, mask)


def galerkin(a: CSRMatrix, p_rows: np.ndarray, p_cols: np.ndarray,
             p_vals: np.ndarray, num_aggregates: int,
             device: torch.device | str = "cuda") -> CSRMatrix:
    """``A_c = P^T A P`` with P in COO (rectangular ok), computed on
    ``device`` by the device stages; the host CSR result equals
    :func:`galerkin_coo_host`'s entries and, to float32 rounding,
    ``graphs.ops.galerkin_coarse_matrix``'s (scipy)."""
    from ..graphs.csr import csr_to_ell_matrix

    nagg = max(1, int(num_aggregates))
    v = a.num_rows
    key_base = max(1, v, nagg)
    indptr = np.zeros(nagg + 1, dtype=np.int64)
    if a.num_entries == 0 or v == 0:       # empty matrix -> empty product
        return CSRMatrix(indptr.astype(np.int32), np.zeros(0, np.int32),
                         np.zeros(0, np.float32))
    a_ell = csr_to_ell_matrix(a, device=device)
    pc, pv = _pad_p_rows(np.asarray(p_rows), np.asarray(p_cols),
                         np.asarray(p_vals), v)
    counts = np.bincount(np.asarray(p_rows), minlength=v)
    pm = np.arange(pc.shape[1])[None, :] < counts[:, None]
    pc_t, pv_t, pm_t = (torch.from_numpy(x).to(device) for x in (pc, pv, pm))
    q = _coo_rows_repack_device(
        *_spgemm_stage1_device(*a_ell, pc_t, pv_t, pm_t, key_base),
        key_base, v)
    keys, sums = _spgemm_stage2_device(pc_t, pv_t, pm_t, *q, key_base)
    keys, sums = keys.cpu().numpy(), sums.cpu().numpy()
    np.add.at(indptr, keys // key_base + 1, 1)
    return CSRMatrix(np.cumsum(indptr).astype(np.int32),
                     (keys % key_base).astype(np.int32),
                     sums.astype(np.float32))


# ---------------------------------------------------------------------------
# coarse graph structure (labels -> coarse adjacency) on the device
# ---------------------------------------------------------------------------

def _coarse_graph_keys_device(neighbors, mask, labels, key_base: int):
    """Unique sorted coarse-edge keys ``la * K + lb`` (with the diagonal),
    the device counterpart of ``graphs.ops.coarse_graph_from_labels``."""
    la = labels.to(torch.int64)
    lb = la[neighbors.to(torch.int64)]
    keys = torch.cat([(la[:, None] * key_base + lb)[mask],
                      la * key_base + la])
    return torch.unique(keys, sorted=True)


def _coarse_graph_ell_device(keys, key_base: int, num_rows: int) -> ELLGraph:
    """Sorted unique coarse-edge keys -> ELL graph (padding = self)."""
    rows = keys // key_base
    slot, width = _kept_row_slots(rows, num_rows)
    return ELLGraph(*_self_padded_ell(rows, keys % key_base, num_rows,
                                      width, slot))
