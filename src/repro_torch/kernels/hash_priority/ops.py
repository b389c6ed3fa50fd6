"""Wrappers for the hash-pack kernel: the Luby coloring's round priorities.

``hash_pack(ids, it, b)`` returns ``pack(xorshift64*(it, id), id, b)`` per
id as int32 bit patterns of the uint32 words (the TPU kernel's signature);
``round_priorities(n, it, b)`` returns the same words of the ids
``0..n-1``, widened to int64, with no ids read: the form the coloring's
round takes, in one launch.  A tensor on the CPU goes to the plain-torch
twins (``ref``); a tensor on a CUDA device goes to the hand-written kernel
(``csrc/hash_pack.cu``), or the call raises.  ``LAUNCHES`` counts kernel
launches of both forms (twin calls are not counted).
"""
from __future__ import annotations

import ctypes
import operator

import torch

from .. import _build
from . import ref

LAUNCHES = {"hash_pack": 0}

_HASH_PACK = (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_void_p)
_ROUND_PRIORITIES = (ctypes.c_void_p,) * 2 + (ctypes.c_int64, ctypes.c_int,
                                              ctypes.c_void_p)


def reset_launches() -> None:
    LAUNCHES["hash_pack"] = 0


def _check_it_b(it: torch.Tensor, b: int) -> None:
    if it.dtype != torch.int32 or it.dim() != 1 or not it.is_contiguous():
        raise TypeError("it must be a contiguous 1-D int32 tensor")
    if it.shape[0] != 1:
        raise ValueError("it must hold one element")
    if not 0 < b < 32:
        raise ValueError(f"id bits b={b} out of range")


def _launch(entry: str, signature: tuple, ins: tuple, out: torch.Tensor,
            it: torch.Tensor, b: int) -> torch.Tensor:
    """One launch of the C entry ``entry`` on ``(*ins, it, out)``."""
    n = out.shape[0]
    if n == 0:
        return out
    with torch.cuda.device(it.device):
        stream = torch.cuda.current_stream(it.device).cuda_stream
        status = _build.function("hash_pack", entry, signature)(
            *(t.data_ptr() for t in ins), it.data_ptr(), out.data_ptr(), n,
            b, stream)
    _build.check(status, "hash_pack")
    LAUNCHES["hash_pack"] += 1
    return out


def hash_pack(ids: torch.Tensor, it: torch.Tensor, b: int) -> torch.Tensor:
    """``ids``: int32 ``[n]`` (uint32 ids); ``it``: int32 ``[1]``, the round,
    on the same device; ``b``: the id bits, ``0 < b < 32``.  int32 words."""
    if it.device != ids.device:
        raise ValueError(f"it is on {it.device}, ids on {ids.device}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise TypeError("ids must be a contiguous 1-D int32 tensor")
    _check_it_b(it, b)
    if ids.device.type == "cpu":
        return ref.hash_pack_ref(ids, it, b)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    return _launch("hash_pack", _HASH_PACK, (ids,),
                   torch.empty_like(ids), it, b)


def round_priorities(n: int, it: torch.Tensor, b: int) -> torch.Tensor:
    """``hash_pack(arange(n), it, b)`` widened to int64 ``[n]`` on
    ``it.device``; ``0 <= n < 2**31``."""
    n = operator.index(n)
    if not 0 <= n < 2**31:
        raise ValueError(f"n={n} out of range [0, 2**31)")
    _check_it_b(it, b)
    if it.device.type == "cpu":
        return ref.round_priorities_ref(n, it, b)
    if it.device.type != "cuda":
        raise ValueError(f"unsupported device {it.device}")
    return _launch("round_priorities", _ROUND_PRIORITIES, (),
                   torch.empty(n, dtype=torch.int64, device=it.device), it, b)
