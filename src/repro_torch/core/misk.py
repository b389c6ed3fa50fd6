"""Distance-k maximal independent set (k-fold min-propagation), PyTorch
port of ``repro.core.misk``.

Each round, with fresh §V-A priorities as in Alg. 1:

* ``M^0 = T``, ``M^j_v = min over w in N[v] of M^(j-1)_w`` for j = 1..k;
* ``v`` goes IN if ``T_v == M^k_v`` (the minimum of its distance-k
  neighbourhood);
* OUT-ness is then propagated k hops from the IN vertices, so every
  undecided vertex within distance k of an IN one goes OUT.

There is no IN-poisoning of M, so k = 2 is not Alg. 1's set.  Two engines,
bit-identical sets, both one call of ``kernels.misk.ops.misk_fixed_point``
(the reference runs each as one jitted dispatch): on the card one
cooperative launch that reads nothing from the host until the loop ends
(``host_syncs`` 0); on the CPU the engine's plain-torch twin, which reads
one live count a round (``host_syncs`` = rounds + 1 when the set
converges):

* ``dense`` — every round refreshes all undecided rows;
* ``resident`` — the row refresh runs over a worklist compacted on the
  device; a solve counts one ``mis2.resident_dispatches``.
"""
from __future__ import annotations

import torch

from ..graphs.handle import as_ell_graph
from ..kernels.misk import ops
from .mis2 import Mis2Result, record_loop
from .tuples import IN

MAX_ITERS_DEFAULT = 256


def _neighbors(graph, k: int) -> torch.Tensor:
    if k < 1:
        raise ValueError("k >= 1")
    ell = as_ell_graph(graph)
    if ell.width == 0:
        raise ValueError("misk needs closed neighbourhoods: the graph has "
                         "no entries")
    return ell.neighbors.contiguous()


def misk_fixed_point(graph, k: int, priority: str, max_iters: int,
                     resident: bool) -> Mis2Result:
    """One distance-k solve of the engine ``resident`` names (``dense``
    otherwise): the fixed point in one call, then one pull of the rounds
    run and the live count (the reference's final result pull)."""
    t, stats = ops.misk_fixed_point(_neighbors(graph, k), k=k,
                                    priority=priority, max_iters=max_iters,
                                    dense=not resident)
    iters, n = stats.tolist()
    syncs = 0 if t.device.type == "cuda" else min(iters + 1, max_iters)
    record_loop(syncs, resident=resident)
    return Mis2Result((t == IN).cpu().numpy(), iters, n == 0, syncs,
                      num_compiles=1 if resident else None)


def _mis_k_impl(graph, k: int = 2, priority: str = "xorshift_star",
                max_iters: int = MAX_ITERS_DEFAULT) -> Mis2Result:
    return misk_fixed_point(graph, k, priority, max_iters, resident=False)


def _misk_resident_impl(graph, k: int = 2, priority: str = "xorshift_star",
                        max_iters: int = MAX_ITERS_DEFAULT) -> Mis2Result:
    return misk_fixed_point(graph, k, priority, max_iters, resident=True)
