"""Wrapper for the run-sum kernel: the ordered accumulation of the
multilevel setup's sorted-COO products.

``run_sums(keys, vals, starts)`` sums each run of equal keys of a sorted
stream in stream order, in float64.  A tensor on the CPU goes to the
plain-torch twin (``ref``); a tensor on a CUDA device goes to the
hand-written kernel (``csrc/run_sums.cu``), or the call raises — there is
no fallback from one to the other.  ``LAUNCHES`` counts kernel launches
(twin calls are not counted).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

LAUNCHES = {"run_sums": 0}

_SIGNATURE = (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int64) \
    + (ctypes.c_void_p,) * 4


def reset_launches() -> None:
    LAUNCHES["run_sums"] = 0


def run_sums(keys: torch.Tensor, vals: torch.Tensor, starts: torch.Tensor):
    """``keys`` int64 ``[n]`` sorted, ``vals`` float64 ``[n]`` in the same
    order, ``starts`` int64 ``[runs]``: the first position of each run of
    equal keys, ascending from 0.  Returns ``(run keys int64, sums float64,
    keep bool)``, each ``[runs]``, with ``keep = sum != 0``."""
    dev = keys.device
    for name, t, dtype in (("keys", keys, torch.int64),
                           ("vals", vals, torch.float64),
                           ("starts", starts, torch.int64)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, keys on {dev}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-D {dtype} "
                            f"tensor")
    if vals.shape != keys.shape:
        raise ValueError(f"vals {tuple(vals.shape)} != keys "
                         f"{tuple(keys.shape)}")
    if dev.type == "cpu":
        return ref.run_sums_ref(keys, vals, starts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    runs = starts.shape[0]
    out_keys = torch.empty(runs, dtype=torch.int64, device=dev)
    sums = torch.empty(runs, dtype=torch.float64, device=dev)
    keep = torch.empty(runs, dtype=torch.bool, device=dev)
    if runs:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = _build.function("run_sums", "run_sums", _SIGNATURE)(
                keys.data_ptr(), vals.data_ptr(), starts.data_ptr(), runs,
                keys.shape[0], out_keys.data_ptr(), sums.data_ptr(),
                keep.data_ptr(), stream)
        _build.check(status, "run_sums")
        LAUNCHES["run_sums"] += 1
    return out_keys, sums, keep
