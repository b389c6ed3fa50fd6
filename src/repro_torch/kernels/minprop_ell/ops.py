"""Wrappers for the fused MIS-2 round passes.

``fused_refresh_columns`` and ``fused_decide`` take the resident driver's
state as it lies on the device and update it in place.  A tensor on the
CPU goes to the plain-torch twin (``ref``); a tensor on a CUDA device goes
to the hand-written kernel (``csrc/minprop_ell.cu``), or the call raises —
there is no fallback from one to the other.

``LAUNCHES`` counts kernel launches per wrapper (twin calls are not
counted), so a run can show that its hot loop went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.hashing import PRIORITY_CODES
from .. import _build
from . import ref

LAUNCHES = {"fused_refresh_columns": 0, "fused_decide": 0}

_SIGNATURES = {
    "fused_refresh_columns": (ctypes.c_void_p,) * 6
    + (ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
       ctypes.c_int, ctypes.c_void_p),
    "fused_decide": (ctypes.c_void_p,) * 7
    + (ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
       ctypes.c_int, ctypes.c_void_p),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry(name: str):
    return _build.function("minprop_ell", name, _SIGNATURES[name])


def _check_args(t, nbrs_flat, wl, count, it, state, b: int,
                priority: str) -> tuple[int, int]:
    """Validate device, dtype, shape and contiguity; returns (V, D)."""
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    named = {"t": t, "nbrs_flat": nbrs_flat, "wl": wl, "count": count,
             "it": it, **state}
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, t on {dev}")
        want = torch.bool if name == "active" else torch.int32
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(x.shape)}")
    v = t.shape[0]
    for name, x in state.items():
        if x.shape[0] != v:
            raise ValueError(f"{name} has {x.shape[0]} rows, t has {v}")
    if v == 0 or nbrs_flat.shape[0] % v:
        raise ValueError(f"nbrs_flat length {nbrs_flat.shape[0]} is not a "
                         f"multiple of V={v}")
    if count.shape[0] != 1 or it.shape[0] != 1:
        raise ValueError("count and it must hold one element each")
    if not 0 < b < 32:
        raise ValueError(f"id bits b={b} out of range")
    if priority not in PRIORITY_CODES:
        raise ValueError(f"unknown priority {priority!r}")
    return v, nbrs_flat.shape[0] // v


def fused_refresh_columns(t, m, nbrs_flat, wl, count, it, *, priority: str,
                          b: int) -> torch.Tensor:
    """M[wl[i]] <- min over the closed neighborhood of the refreshed T, with
    IN -> OUT, for every live slot ``i < count`` (in place; returns ``m``).

    ``t``, ``m``: int32 [V] (uint32 bit patterns); ``nbrs_flat``: int32
    [V*D] self-padded ELL; ``wl``: int32 [W] (sentinel V); ``count``,
    ``it``: int32 [1] on the same device.
    """
    v, d = _check_args(t, nbrs_flat, wl, count, it, {"m": m}, b, priority)
    if t.device.type == "cpu":
        return ref.fused_refresh_columns_ref(t, m, nbrs_flat, wl, count, it,
                                             priority=priority, b=b)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        status = _entry("fused_refresh_columns")(
            t.data_ptr(), m.data_ptr(), nbrs_flat.data_ptr(), wl.data_ptr(),
            count.data_ptr(), it.data_ptr(), v, wl.shape[0], d, b,
            PRIORITY_CODES[priority], stream)
    _build.check(status, "fused_refresh_columns")
    LAUNCHES["fused_refresh_columns"] += 1
    return m


def fused_decide(t, m, active, nbrs_flat, wl, count, it, *, priority: str,
                 b: int) -> torch.Tensor:
    """T[wl[i]] <- OUT if an active neighbor's M is OUT, else IN if every
    active neighbor's M equals the row's refreshed tuple, else that tuple,
    for every live slot ``i < count`` whose row is undecided (in place;
    returns ``t``).  ``active``: bool [V]; the rest as
    :func:`fused_refresh_columns`.
    """
    v, d = _check_args(t, nbrs_flat, wl, count, it,
                       {"m": m, "active": active}, b, priority)
    if t.device.type == "cpu":
        return ref.fused_decide_ref(t, m, active, nbrs_flat, wl, count, it,
                                    priority=priority, b=b)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        status = _entry("fused_decide")(
            t.data_ptr(), m.data_ptr(), active.data_ptr(),
            nbrs_flat.data_ptr(), wl.data_ptr(), count.data_ptr(),
            it.data_ptr(), v, wl.shape[0], d, b, PRIORITY_CODES[priority],
            stream)
    _build.check(status, "fused_decide")
    LAUNCHES["fused_decide"] += 1
    return t
