"""Distance-k maximal independent set (k-fold min-propagation), PyTorch
port of ``repro.core.misk``.

Each round, with fresh §V-A priorities as in Alg. 1:

* ``M^0 = T``, ``M^j_v = min over w in N[v] of M^(j-1)_w`` for j = 1..k;
* ``v`` goes IN if ``T_v == M^k_v`` (the minimum of its distance-k
  neighbourhood);
* OUT-ness is then propagated k hops from the IN vertices, so every
  undecided vertex within distance k of an IN one goes OUT.

There is no IN-poisoning of M, so k = 2 is not Alg. 1's set.  Two engines,
bit-identical sets, both plain torch on the graph's device (the reference
computes this outside any Pallas kernel):

* ``dense`` — every round refreshes all undecided rows;
* ``resident`` — the row refresh runs over a worklist compacted on the
  device (``core.mis2.compact_worklist``), its dead slots scattered into a
  dump slot (``set_drop``) where the reference drops them.

Both read one live flag a round on the host to decide whether to go on
(``host_syncs`` = rounds + 1 when the set converges); the reference runs
the fixed point as one dispatch with no host read.
"""
from __future__ import annotations

import torch

from ..graphs.handle import as_ell_graph
from ..kernels.minprop_ell.ref import set_drop
from .hashing import PRIORITY_FNS
from .mis2 import Mis2Result, compact_worklist, record_loop
from .tuples import IN, OUT, id_bits, is_undecided, pack

MAX_ITERS_DEFAULT = 256


def _decide(t: torch.Tensor, nb: torch.Tensor, k: int) -> torch.Tensor:
    """One round's decisions over refreshed T (widened int64): the k-fold
    closed-neighbourhood min picks IN, then OUT spreads k hops from IN."""
    m = t
    for _ in range(k):
        m = m[nb].amin(dim=1)
    t = torch.where(is_undecided(t) & (m == t), IN, t)
    near_in = t == IN
    for _ in range(k):
        near_in = near_in[nb].any(dim=1) | near_in
    return torch.where(is_undecided(t) & near_in, OUT, t)


def _neighbors(graph, k: int) -> torch.Tensor:
    if k < 1:
        raise ValueError("k >= 1")
    ell = as_ell_graph(graph)
    if ell.width == 0:
        raise ValueError("misk needs closed neighbourhoods: the graph has "
                         "no entries")
    return ell.neighbors.to(torch.int64)


def misk_dense_fixed_point(neighbors: torch.Tensor, k: int,
                           priority: str = "xorshift_star",
                           max_iters: int = MAX_ITERS_DEFAULT):
    """The ``dense`` distance-k fixed point over self-padded ELL rows
    (int64).  Returns ``(T widened int64 [V], iterations, host_syncs)``."""
    v = neighbors.shape[0]
    b = id_bits(v)
    vids = torch.arange(v, device=neighbors.device)
    prio_fn = PRIORITY_FNS[priority]
    t = torch.ones(v, dtype=torch.int64, device=neighbors.device)
    it = syncs = 0
    while it < max_iters:
        und = is_undecided(t)
        syncs += 1
        if not bool(und.any()):     # the one host read a round
            break
        t = torch.where(und, pack(prio_fn(it, vids), vids, b), t)
        t = _decide(t, neighbors, k)
        it += 1
    record_loop(syncs)
    return t, it, syncs


def misk_resident_fixed_point(neighbors: torch.Tensor, k: int,
                              priority: str = "xorshift_star",
                              max_iters: int = MAX_ITERS_DEFAULT):
    """The ``resident`` distance-k fixed point: the refresh over the
    compacted undecided worklist.  Returns ``(T widened int64 [V],
    iterations, live count int32 [1], host_syncs)``."""
    v = neighbors.shape[0]
    b = id_bits(v)
    prio_fn = PRIORITY_FNS[priority]
    t = torch.ones(v, dtype=torch.int64, device=neighbors.device)
    wl, n = compact_worklist(is_undecided(t))
    it = syncs = 0
    while it < max_iters:
        syncs += 1
        if int(n.item()) == 0:      # the one host read a round
            break
        rows = wl.to(torch.int64).clamp(0, v - 1)
        told = t[rows]
        newt = torch.where(is_undecided(told),
                           pack(prio_fn(it, rows), rows, b), told)
        t = _decide(set_drop(t, wl, newt), neighbors, k)
        wl, n = compact_worklist(is_undecided(t))
        it += 1
    record_loop(syncs, resident=True)
    return t, it, n, syncs


def _mis_k_impl(graph, k: int = 2, priority: str = "xorshift_star",
                max_iters: int = MAX_ITERS_DEFAULT) -> Mis2Result:
    t, iters, syncs = misk_dense_fixed_point(_neighbors(graph, k), k,
                                             priority, max_iters)
    converged = not bool(is_undecided(t).any())
    return Mis2Result((t == IN).cpu().numpy(), iters, converged, syncs)


def _misk_resident_impl(graph, k: int = 2, priority: str = "xorshift_star",
                        max_iters: int = MAX_ITERS_DEFAULT) -> Mis2Result:
    t, iters, n, syncs = misk_resident_fixed_point(
        _neighbors(graph, k), k, priority, max_iters)
    return Mis2Result((t == IN).cpu().numpy(), iters, int(n.item()) == 0,
                      syncs, num_compiles=1)
