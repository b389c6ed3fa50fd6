"""Wrappers for the ELL SpMV kernels of the AMG solve.

``spmv`` computes ``y = A x``; ``spmv_t`` computes ``y = P^T x`` for a
rectangular ELL ``P`` through an :class:`EllTranspose` built once per
matrix (:func:`ell_transpose`): the matrix-free restriction of the
V-cycle, deterministic and bitwise equal to ``spmv`` on the explicit
``R = P^T`` whose rows list their entries by ascending fine row.

A tensor on the CPU goes to the plain-torch twin (``ref``); a tensor on a
CUDA device goes to the hand-written kernel (``csrc/spmv_ell.cu``), or the
call raises — there is no fallback from one to the other.  ``LAUNCHES``
counts kernel launches (twin calls are not counted).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from . import ref

LAUNCHES = {"spmv": 0, "spmv_t": 0}

_P = ctypes.c_void_p
_SIGNATURES = {
    "spmv_ell": (_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P),
    "spmv_ell_t": (_P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P),
}


class EllTranspose(NamedTuple):
    """The transpose of an ELL matrix ``[rows, D]`` as a gather plan."""

    perm: torch.Tensor      # int32 [nnz]: real flat slots, stably by column
    offsets: torch.Tensor   # int32 [num_out + 1]: each column's segment
    max_len: int            # the longest segment

    @property
    def num_out(self) -> int:
        return int(self.offsets.shape[0]) - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ell_transpose(cols: torch.Tensor, mask: torch.Tensor,
                  num_out: int) -> EllTranspose:
    """Setup-time transpose plan of ELL ``(cols, mask)`` with ``num_out``
    columns, on the tensors' device: a stable sort of the real slots by
    column keeps each column's slots in ascending row order."""
    rows, d = cols.shape
    if rows * d >= 2**31:
        raise ValueError(f"ELL [{rows}, {d}] has too many slots for int32 "
                         "slot ids")
    slots = torch.nonzero(mask.reshape(-1)).squeeze(1)
    c = cols.reshape(-1)[slots].to(torch.int64)
    perm = slots[torch.sort(c, stable=True).indices].to(torch.int32)
    counts = torch.bincount(c, minlength=num_out)
    if counts.shape[0] > num_out:
        raise ValueError(f"a column index >= num_out={num_out}")
    offsets = torch.zeros(num_out + 1, dtype=torch.int32, device=cols.device)
    offsets[1:] = torch.cumsum(counts, 0)
    max_len = int(counts.max()) if num_out else 0
    return EllTranspose(perm.contiguous(), offsets, max_len)


def _check(named: dict, dtypes: dict, dims: dict) -> torch.device:
    dev = next(iter(named.values())).device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if t.dim() != dims[name]:
            raise ValueError(f"{name} must be {dims[name]}-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def spmv(cols: torch.Tensor, vals: torch.Tensor,
         x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: ``cols`` int32 and ``vals`` float32 ``[rows, D]`` (padded
    slots: val 0, any column in range), ``x`` float32 ``[N]`` with every
    column index below ``N``.  Returns float32 ``[rows]``."""
    dev = _check({"cols": cols, "vals": vals, "x": x},
                 {"cols": torch.int32, "vals": torch.float32,
                  "x": torch.float32}, {"cols": 2, "vals": 2, "x": 1})
    if cols.shape != vals.shape:
        raise ValueError(f"cols {tuple(cols.shape)} != vals "
                         f"{tuple(vals.shape)}")
    if dev.type == "cpu":
        return ref.spmv_ref(cols, vals, x)
    rows, d = cols.shape
    y = torch.empty(rows, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _build.function("spmv_ell", "spmv_ell",
                                 _SIGNATURES["spmv_ell"])(
            cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
            rows, d, stream)
    _build.check(status, "spmv_ell")
    LAUNCHES["spmv"] += 1
    return y


def spmv_t(vals: torch.Tensor, t: EllTranspose,
           x: torch.Tensor) -> torch.Tensor:
    """y = P^T @ x: ``vals`` float32 ``[rows, D]`` of P, ``t`` its
    :func:`ell_transpose`, ``x`` float32 ``[rows]``.  Returns float32
    ``[t.num_out]``, summed per output row in ascending row order."""
    dev = _check({"vals": vals, "perm": t.perm, "offsets": t.offsets,
                  "x": x},
                 {"vals": torch.float32, "perm": torch.int32,
                  "offsets": torch.int32, "x": torch.float32},
                 {"vals": 2, "perm": 1, "offsets": 1, "x": 1})
    if x.shape[0] != vals.shape[0]:
        raise ValueError(f"x has {x.shape[0]} rows, P has {vals.shape[0]}")
    if dev.type == "cpu":
        return ref.spmv_t_ref(vals, t.perm, t.offsets, x, t.max_len)
    y = torch.empty(t.num_out, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _build.function("spmv_ell", "spmv_ell_t",
                                 _SIGNATURES["spmv_ell_t"])(
            vals.data_ptr(), t.perm.data_ptr(), t.offsets.data_ptr(),
            x.data_ptr(), y.data_ptr(), t.num_out, vals.shape[1], stream)
    _build.check(status, "spmv_ell_t")
    LAUNCHES["spmv_t"] += 1
    return y
