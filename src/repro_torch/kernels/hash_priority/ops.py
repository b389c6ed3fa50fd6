"""Wrapper for the hash-pack kernel: the Luby coloring's round priorities.

``hash_pack(ids, it, b)`` returns ``pack(xorshift64*(it, id), id, b)`` per
id as int32 bit patterns of the uint32 words.  A tensor on the CPU goes to
the plain-torch twin (``ref``); a tensor on a CUDA device goes to the
hand-written kernel (``csrc/hash_pack.cu``), or the call raises.
``LAUNCHES`` counts kernel launches (twin calls are not counted).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

LAUNCHES = {"hash_pack": 0}

_SIGNATURE = (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_void_p)


def reset_launches() -> None:
    LAUNCHES["hash_pack"] = 0


def hash_pack(ids: torch.Tensor, it: torch.Tensor, b: int) -> torch.Tensor:
    """``ids``: int32 ``[n]`` (uint32 ids); ``it``: int32 ``[1]``, the round,
    on the same device; ``b``: the id bits, ``0 < b < 32``."""
    for name, t in (("ids", ids), ("it", it)):
        if t.device != ids.device:
            raise ValueError(f"{name} is on {t.device}, ids on {ids.device}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-D int32 tensor")
    if it.shape[0] != 1:
        raise ValueError("it must hold one element")
    if not 0 < b < 32:
        raise ValueError(f"id bits b={b} out of range")
    if ids.device.type == "cpu":
        return ref.hash_pack_ref(ids, it, b)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    out = torch.empty_like(ids)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        status = _build.function("hash_pack", "hash_pack", _SIGNATURE)(
            ids.data_ptr(), it.data_ptr(), out.data_ptr(), ids.shape[0], b,
            stream)
    _build.check(status, "hash_pack")
    LAUNCHES["hash_pack"] += 1
    return out
