"""Wrapper for the distance-k MIS kernel: the reference's round loop in
one launch over the self-padded ELL (``misk_fixed_point``), for both
``misk`` engines.

A tensor on the CPU goes to a plain-torch twin (``ref``: the ``dense`` or
the ``resident`` engine's loop); a tensor on a CUDA device goes to the
hand-written kernel (``csrc/misk.cu``), or the call raises — there is no
fallback from one to the other.  ``LAUNCHES`` counts kernel launches (twin
calls are not counted).
"""
from __future__ import annotations

import ctypes

import torch

from ...core.hashing import PRIORITY_CODES
from ...core.tuples import id_bits
from .. import _build
from ..minprop_ell.ops import MAX_BLOCKS_PER_SM, card_sms
from . import ref

LAUNCHES = {"misk_fixed_point": 0}

_SIGNATURES = {
    "misk_fixed_point": (ctypes.c_void_p,) * 6 + (
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
}


def reset_launches() -> None:
    LAUNCHES["misk_fixed_point"] = 0


def misk_fixed_point(neighbors, *, k: int, priority: str, max_iters: int,
                     dense: bool = False):
    """The distance-k fixed point over the self-padded ELL ``neighbors``
    (int32 ``[V, D]``, ``D >= 1``): T = 1 everywhere, then rounds while a
    row is undecided and fewer than ``max_iters`` ran.  Returns ``(T int32
    [V], int32 [2])``, the rounds run and the undecided rows left, on the
    ELL's device.

    On the card one cooperative launch runs every round and reads no value
    from the host, for either engine; it raises (``KernelLaunchError``)
    where the launch is refused: there is no per-round fallback.  On the
    CPU ``dense`` picks the ``dense`` engine's twin, else the
    ``resident`` one's (bit-identical)."""
    dev = neighbors.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if neighbors.dtype != torch.int32:
        raise TypeError(f"neighbors must be torch.int32, got "
                        f"{neighbors.dtype}")
    if neighbors.dim() != 2 or neighbors.shape[0] == 0 \
            or neighbors.shape[1] == 0:
        raise ValueError(f"neighbors must be a non-empty [V, D] ELL, got "
                         f"{tuple(neighbors.shape)}")
    if not neighbors.is_contiguous():
        raise ValueError("neighbors must be contiguous")
    if k < 1:
        raise ValueError(f"k={k}: k >= 1")
    if max_iters < 0:
        raise ValueError(f"max_iters={max_iters} is negative")
    if priority not in PRIORITY_CODES:
        raise ValueError(f"unknown priority {priority!r}")
    kw = dict(k=k, priority=priority, max_iters=max_iters)
    if dev.type == "cpu":
        twin = (ref.misk_dense_fixed_point_ref if dense
                else ref.misk_resident_fixed_point_ref)
        return twin(neighbors, **kw)
    return _misk_on_card(neighbors, **kw)


def _misk_on_card(neighbors, *, k: int, priority: str, max_iters: int):
    """One launch over the ELL; the scratch allocated here."""
    dev = neighbors.device
    v, d = neighbors.shape
    t = torch.empty(v, dtype=torch.int32, device=dev)
    hops = torch.empty(2 * v, dtype=torch.int32, device=dev)
    near = torch.empty(2 * v, dtype=torch.uint8, device=dev)
    wl = torch.empty(2 * v, dtype=torch.int32, device=dev)
    aux = torch.empty(4 + MAX_BLOCKS_PER_SM * card_sms(dev),
                      dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _build.function("misk", "misk_fixed_point",
                                 _SIGNATURES["misk_fixed_point"])(
            t.data_ptr(), neighbors.data_ptr(), hops.data_ptr(),
            near.data_ptr(), wl.data_ptr(), aux.data_ptr(), aux.shape[0], v,
            d, id_bits(v), PRIORITY_CODES[priority], k, max_iters, stream)
    _build.check(status, "misk_fixed_point")
    LAUNCHES["misk_fixed_point"] += 1
    return t, aux[2:4]
