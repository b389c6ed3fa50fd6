"""Wrappers for the hash-pack kernel: the Luby coloring's round priorities.

``hash_pack(ids, it, b)`` returns ``pack(xorshift64*(it, id), id, b)`` per
id as int32 bit patterns of the uint32 words (the TPU kernel's signature);
``round_priorities(n, it, b)`` returns the same words of the ids
``0..n-1``, widened to int64, with no ids read: the form the coloring's
round takes, in one launch; ``round_priorities_batched(rows, it, bits)``
that form of each member of a bucket (``bits`` per member), end to end:
the batched coloring's round priorities (its twin's; the batched Luby
kernel hashes them inline).  A tensor on the CPU
goes to the plain-torch twins (``ref``); a tensor on a CUDA device goes to
the hand-written kernel (``csrc/hash_pack.cu``), or the call raises.
``LAUNCHES`` counts kernel launches, the two single-graph forms under
``hash_pack`` and the batched one under its own name (twin calls are not
counted).
"""
from __future__ import annotations

import ctypes
import operator

import torch

from .. import _build
from . import ref

LAUNCHES = {"hash_pack": 0, "round_priorities_batched": 0}

_HASH_PACK = (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_void_p)
_ROUND_PRIORITIES = (ctypes.c_void_p,) * 2 + (ctypes.c_int64, ctypes.c_int,
                                              ctypes.c_void_p)
_ROUND_PRIORITIES_BATCHED = (ctypes.c_void_p,) * 3 + (
    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_it(it: torch.Tensor) -> None:
    if it.dtype != torch.int32 or it.dim() != 1 or not it.is_contiguous():
        raise TypeError("it must be a contiguous 1-D int32 tensor")
    if it.shape[0] != 1:
        raise ValueError("it must hold one element")


def _check_it_b(it: torch.Tensor, b: int) -> None:
    _check_it(it)
    if not 0 < b < 32:
        raise ValueError(f"id bits b={b} out of range")


def _launch(entry: str, signature: tuple, ins: tuple, out: torch.Tensor,
            it: torch.Tensor, b: int, counter: str = "hash_pack"
            ) -> torch.Tensor:
    """One launch of the C entry ``entry`` on ``(*ins, it, out)``, counted
    under ``LAUNCHES[counter]``."""
    n = out.shape[0]
    if n == 0:
        return out
    with torch.cuda.device(it.device):
        stream = torch.cuda.current_stream(it.device).cuda_stream
        status = _build.function("hash_pack", entry, signature)(
            *(t.data_ptr() for t in ins), it.data_ptr(), out.data_ptr(), n,
            b, stream)
    _build.check(status, "hash_pack")
    LAUNCHES[counter] += 1
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


def round_priorities_batched(rows: int, it: torch.Tensor,
                             bits: torch.Tensor) -> torch.Tensor:
    """``round_priorities(rows, it, bits[j])`` of each member ``j`` of a
    bucket, laid end to end: int64 ``[B * rows]`` on ``it.device``, index
    ``i`` packing the local id ``i % rows`` with ``bits[i // rows]``.
    ``rows``: a power of two; ``bits``: int32 ``[B]`` on ``it``'s device,
    each ``0 < b < 32`` (the members' ``id_bits``, not read back here: that
    would cost a host sync); ``B * rows < 2**31``."""
    rows = operator.index(rows)
    if rows < 1 or rows & (rows - 1):
        raise ValueError(f"rows={rows} is not a power of two")
    _check_it(it)
    if bits.dtype != torch.int32 or bits.dim() != 1 \
            or not bits.is_contiguous():
        raise TypeError("bits must be a contiguous 1-D int32 tensor")
    if bits.device != it.device:
        raise ValueError(f"bits is on {bits.device}, it on {it.device}")
    n = rows * bits.shape[0]
    if n >= 2**31:
        raise ValueError(f"B * rows = {n} out of range [0, 2**31)")
    if it.device.type == "cpu":
        return ref.round_priorities_batched_ref(rows, it, bits)
    if it.device.type != "cuda":
        raise ValueError(f"unsupported device {it.device}")
    return _launch("round_priorities_batched", _ROUND_PRIORITIES_BATCHED,
                   (bits,), torch.empty(n, dtype=torch.int64,
                                        device=it.device),
                   it, rows.bit_length() - 1, "round_priorities_batched")
