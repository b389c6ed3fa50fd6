"""Plain-torch twins of the fused MIS-2 kernels (``csrc/minprop_ell.cu``).

Each twin computes what its kernel computes, in place: the function of
``repro.kernels.minprop_ell.ref.fused_*_ref`` followed by the drop-scatter
``x.at[wl].set(out, mode="drop")`` of the JAX ops wrapper.  Slots at or past
``count`` and sentinel slots (``wl[i] == V``) write nothing.

The words are stored as int32 bit patterns and widened to int64 for every
compare (see ``core.tuples``).  ``count`` and ``it`` are one-element int32
tensors, read on the device: a twin issues no host sync, so it can be
timed beside its kernel on the card.  They do the work of every slot and
mask the dead ones, which is the plain version and no yardstick of speed.
"""
from __future__ import annotations

import torch

from ...core.hashing import PRIORITY_FNS
from ...core.tuples import OUT, is_undecided, narrow, pack, widen


def _refresh(t_u: torch.Tensor, ids: torch.Tensor, it: torch.Tensor,
             priority: str, b: int) -> torch.Tensor:
    """§V-A refresh of widened tuples ``t_u`` of vertices ``ids``."""
    fresh = pack(PRIORITY_FNS[priority](it, ids), ids, b)
    return torch.where(is_undecided(t_u), fresh, t_u)


def _live_rows(wl: torch.Tensor, count: torch.Tensor, v: int):
    """(rows clamped into [0, V), scatter targets with dead slots -> V)."""
    slot = torch.arange(wl.shape[0], device=wl.device)
    live = (slot < count.to(torch.int64)) & (wl >= 0) & (wl < v)
    rows = wl.to(torch.int64).clamp(0, v - 1)
    return rows, torch.where(live, rows, v)


def _scatter_drop(x: torch.Tensor, target: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """x[target] = vals in place, dropping target == V (a [V+1] buffer)."""
    v = x.shape[0]
    buf = torch.empty(v + 1, dtype=x.dtype, device=x.device)
    buf[:v] = x
    buf.scatter_(0, target, vals)
    x.copy_(buf[:v])


def fused_refresh_columns_ref(t, m, nbrs_flat, wl, count, it, *,
                              priority: str, b: int) -> torch.Tensor:
    """M[wl] <- closed-neighborhood min of the refreshed T, IN -> OUT."""
    v = t.shape[0]
    d = nbrs_flat.shape[0] // v
    rows, target = _live_rows(wl, count, v)
    vids = torch.arange(v, device=t.device)
    t_ref = _refresh(widen(t), vids, it, priority, b)
    nb = nbrs_flat.view(v, d)[rows].to(torch.int64)
    mv = t_ref[nb].amin(dim=1)
    mv = torch.where(mv == 0, OUT, mv)
    _scatter_drop(m, target, narrow(mv))
    return m


def fused_decide_ref(t, m, active, nbrs_flat, wl, count, it, *,
                     priority: str, b: int) -> torch.Tensor:
    """T[wl] <- IN / OUT / refreshed tuple for the still-undecided rows."""
    v = t.shape[0]
    d = nbrs_flat.shape[0] // v
    rows, target = _live_rows(wl, count, v)
    tv_old = widen(t)[rows]
    tv = _refresh(tv_old, rows, it, priority, b)
    nb = nbrs_flat.view(v, d)[rows].to(torch.int64)
    mn = widen(m)[nb]
    an = active[nb]
    any_out = (an & (mn == OUT)).any(dim=1)
    all_eq = (~an | (mn == tv[:, None])).all(dim=1)
    newt = torch.where(any_out, OUT, torch.where(all_eq, 0, tv))
    newt = torch.where(is_undecided(tv_old), newt, tv_old)
    _scatter_drop(t, target, narrow(newt))
    return t
