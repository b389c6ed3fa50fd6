"""Plain-torch twins of the ELL SpMV kernels (``csrc/spmv_ell.cu``).

Each twin sums in the kernel's order — slot by slot, a separate multiply
then a separate add, each rounded to float32 — so on equal inputs it
returns the kernel's bits.  Neither reads a value on the host, so both can
be timed beside their kernels on the card.
"""
from __future__ import annotations

import torch


def spmv_ref(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, A in ELL ``[rows, D]`` (padding: val 0)."""
    acc = torch.zeros(cols.shape[0], dtype=torch.float32, device=x.device)
    for j in range(cols.shape[1]):
        acc = acc + vals[:, j] * x.index_select(0, cols[:, j])
    return acc


def spmv_t_ref(vals: torch.Tensor, perm: torch.Tensor, offsets: torch.Tensor,
               x: torch.Tensor, max_len: int) -> torch.Tensor:
    """y = P^T @ x for ELL P ``[rows, D]``: output row ``c`` sums
    ``vals[s] * x[s // D]`` over the flat slots ``s = perm[offsets[c]:
    offsets[c + 1]]`` in that order (``max_len`` = the longest segment)."""
    d = vals.shape[1]
    flat = vals.reshape(-1)
    starts = offsets[:-1].to(torch.int64)
    lens = offsets[1:].to(torch.int64) - starts
    acc = torch.zeros(starts.shape[0], dtype=torch.float32, device=x.device)
    last = max(perm.shape[0] - 1, 0)
    for k in range(max_len):
        s = perm[(starts + k).clamp(max=last)].to(torch.int64)
        acc = torch.where(k < lens, acc + flat[s] * x[s // d], acc)
    return acc
