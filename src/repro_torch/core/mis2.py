"""Parallel, deterministic distance-2 maximal independent set (paper Alg. 1),
PyTorch port of ``repro.core.mis2``.

Three engines, bit-identical results:

* ``dense`` — the plain referent: every round refreshes, min-propagates and
  decides over all ``V`` rows with masks (``mis2_dense_fixed_point``).
* ``cuda_resident`` — the production hot loop (the counterpart of the JAX
  package's ``pallas_resident``).  Fixed ``[V]``-shaped state lives on the
  device; worklists are compacted there (cumsum stream compaction, sentinel
  ``V``); each round is the two fused passes of
  ``kernels.minprop_ell.ops`` (a CUDA kernel each on the card, their
  plain-torch twins on the CPU), with the live counts and the round number
  read by the kernels on the device.
* ``cuda_hybrid`` — the same loop over the degree-aware hybrid layout
  (``core.mis2_hybrid``), for graphs whose padded ELL is too large.

The loop's only host involvement is one read of the live count per round,
to decide whether to go on: ``Mis2Result.host_syncs`` reports it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graphs.handle import as_graph
from ..kernels.minprop_ell import ops
from .hashing import PRIORITY_FNS
from .tuples import IN, OUT, OUT_I32, id_bits, is_undecided, pack

MAX_ITERS_DEFAULT = 128


@dataclass(frozen=True)
class Mis2Options:
    priority: str = "xorshift_star"     # fixed | xorshift | xorshift_star
    max_iters: int = MAX_ITERS_DEFAULT

    def __post_init__(self):
        if self.priority not in PRIORITY_FNS:
            raise ValueError(f"unknown priority {self.priority!r} "
                             f"({' | '.join(PRIORITY_FNS)})")


@dataclass
class Mis2Result:
    in_set: np.ndarray        # bool [V], host
    iterations: int
    converged: bool
    host_syncs: int = 0       # device->host reads inside the fixed point
    collectives: dict | None = None   # cuda_hybrid: the traffic accounting

    @property
    def size(self) -> int:
        return int(self.in_set.sum())


def _active_mask(active, v: int, device: torch.device) -> torch.Tensor:
    if active is None:
        return torch.ones(v, dtype=torch.bool, device=device)
    mask = torch.as_tensor(active, device=device)
    if mask.dtype != torch.bool or mask.shape != (v,):
        raise ValueError(f"active must be a bool [{v}] mask, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    return mask.contiguous()


# ===========================================================================
# dense engine — the plain referent
# ===========================================================================

def mis2_dense_fixed_point(neighbors: torch.Tensor, active: torch.Tensor,
                           b: int, priority: str = "xorshift_star",
                           max_iters: int = MAX_ITERS_DEFAULT):
    """Masked MIS-2 fixed point over a self-padded ELL graph.

    Returns ``(T widened int64 [V], iterations, host_syncs)``.  Inactive
    vertices are invisible: T pinned to OUT, never refreshed.
    """
    v = neighbors.shape[0]
    nb = neighbors.to(torch.int64)
    vids = torch.arange(v, device=neighbors.device)
    prio_fn = PRIORITY_FNS[priority]
    t = torch.where(active, 1, OUT).to(torch.int64)
    it = syncs = 0
    while it < max_iters:
        und = is_undecided(t) & active
        syncs += 1
        if not bool(und.any()):
            break
        t = torch.where(und, pack(prio_fn(it, vids), vids, b), t)   # §V-A
        m = t[nb].amin(dim=1)                                        # §V-D
        m = torch.where(m == IN, OUT, m)            # IN-adjacent poison
        mn = m[nb]
        an = active[nb]
        any_out = (an & (mn == OUT)).any(dim=1)
        all_eq = (~an | (mn == t[:, None])).all(dim=1)
        t = torch.where(und & any_out, OUT, t)
        t = torch.where(und & ~any_out & all_eq, IN, t)
        it += 1
    return t, it, syncs


def _mis2_dense_impl(graph, active=None,
                     options: Mis2Options | None = None) -> Mis2Result:
    options = Mis2Options() if options is None else options
    ell = as_graph(graph).ell
    v = ell.num_vertices
    act = _active_mask(active, v, ell.neighbors.device)
    t, iters, syncs = mis2_dense_fixed_point(
        ell.neighbors, act, id_bits(v), options.priority, options.max_iters)
    undecided = bool((is_undecided(t) & act).any())
    return Mis2Result((t == IN).cpu().numpy(), iters, not undecided, syncs)


# ===========================================================================
# device-resident engine on the fused kernels
# ===========================================================================

def compact_worklist(mask: torch.Tensor):
    """Cumsum stream compaction of an ``[n]`` live mask, on the device.

    Returns ``(indices int32 [n], count int32 [1])``: the first ``count``
    slots hold the set indices in ascending order (``np.flatnonzero``
    order), the rest the sentinel ``n`` (``V`` for the whole graph, ``R``
    for a hybrid slab).  torch has no drop-mode scatter, so the dead slots
    scatter into a dump slot ``n`` that is sliced off.
    """
    v = mask.shape[0]
    pos = torch.cumsum(mask, dim=0, dtype=torch.int64) - 1
    buf = torch.full((v + 1,), v, dtype=torch.int32, device=mask.device)
    buf.scatter_(0, torch.where(mask, pos, v),
                 torch.arange(v, dtype=torch.int32, device=mask.device))
    return buf[:v], mask.sum(dtype=torch.int32).reshape(1)


def resident_ell_fixed_point(neighbors: torch.Tensor, active: torch.Tensor,
                             *, priority: str, max_iters: int, b: int):
    """The §V-B compacted fixed point over ``[V]`` device state.

    Each round: ``fused_refresh_columns`` over the M worklist, then
    ``fused_decide`` over the undecided worklist, then both worklists are
    recompacted on the device.  The round counter is both the loop bound
    and the §V-A priority round.  Returns ``(T stored int32 [V],
    iterations, live count int32 [1], host_syncs)``.
    """
    v = neighbors.shape[0]
    dev = neighbors.device
    nbrs_flat = neighbors.contiguous().view(-1)
    t = torch.where(active, 1, OUT_I32).to(torch.int32)
    m = torch.full((v,), OUT_I32, dtype=torch.int32, device=dev)
    wl1, n1 = compact_worklist(active)
    wl2 = torch.arange(v, dtype=torch.int32, device=dev)  # round 0: every M
    n2 = torch.full((1,), v, dtype=torch.int32, device=dev)
    it_dev = torch.zeros(1, dtype=torch.int32, device=dev)
    it = syncs = 0
    while it < max_iters:
        syncs += 1
        if int(n1.item()) == 0:       # the one host read per round
            break
        ops.fused_refresh_columns(t, m, nbrs_flat, wl2, n2, it_dev,
                                  priority=priority, b=b)
        ops.fused_decide(t, m, active, nbrs_flat, wl1, n1, it_dev,
                         priority=priority, b=b)
        wl1, n1 = compact_worklist(is_undecided(t))
        wl2, n2 = compact_worklist(m != OUT_I32)
        it_dev += 1
        it += 1
    return t, it, n1, syncs


def _mis2_resident_impl(graph, active=None,
                        options: Mis2Options | None = None) -> Mis2Result:
    options = Mis2Options() if options is None else options
    ell = as_graph(graph).ell
    v = ell.num_vertices
    act = _active_mask(active, v, ell.neighbors.device)
    t, iters, n1, syncs = resident_ell_fixed_point(
        ell.neighbors, act, priority=options.priority,
        max_iters=options.max_iters, b=id_bits(v))
    return Mis2Result((t == IN).cpu().numpy(), iters, int(n1.item()) == 0,
                      syncs)


def run_mis2(graph, active=None, options: Mis2Options | None = None,
             engine: str = "cuda_resident") -> Mis2Result:
    """Engine dispatch used by the facade and the coarsening drivers;
    ``dense``, ``cuda_resident`` and ``cuda_hybrid`` give bit-identical
    sets."""
    if engine == "dense":
        return _mis2_dense_impl(graph, active, options)
    if engine == "cuda_resident":
        return _mis2_resident_impl(graph, active, options)
    if engine == "cuda_hybrid":
        from .mis2_hybrid import _mis2_hybrid_impl

        return _mis2_hybrid_impl(graph, active, options)
    raise ValueError(f"unknown mis2 engine {engine!r} "
                     "(dense | cuda_resident | cuda_hybrid)")
