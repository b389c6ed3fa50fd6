"""Plain-torch twins of the distance-k MIS kernel (``csrc/misk.cu``): the
reference's round loops ``repro.core.misk._misk_fixpoint`` (engine
``dense``: every undecided row refreshed by mask) and
``_misk_resident_fixpoint`` (engine ``resident``: the refresh over an
undecided worklist compacted on the device, its dead slots scattered into
a dump slot where the reference drops them), round for round; the two give
the same T, bit for bit.

Each round, with fresh §V-A priorities as in Alg. 1:

* ``M^0 = T``, ``M^j_v = min over w in N[v] of M^(j-1)_w`` for j = 1..k;
* ``v`` goes IN if ``T_v == M^k_v`` (the minimum of its distance-k
  neighbourhood);
* OUT-ness is then propagated k hops from the IN vertices, so every
  undecided vertex within distance k of an IN one goes OUT.

Both read the live count on the host each round, which is the plain
version and no yardstick of speed.  The words are widened to int64 for
every compare (see ``core.tuples``).
"""
from __future__ import annotations

import torch

from ...core.hashing import PRIORITY_FNS
from ...core.mis2 import compact_worklist
from ...core.tuples import IN, OUT, id_bits, is_undecided, narrow, pack
from ..minprop_ell.ref import set_drop


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


def _result(t: torch.Tensor, it: int):
    """``(T int32 [V], int32 [2])``: the rounds run and the undecided rows
    left, built on the device."""
    n = is_undecided(t).sum(dtype=torch.int32).reshape(1)
    return narrow(t), torch.cat([n.new_full((1,), it), n])


def misk_dense_fixed_point_ref(neighbors, *, k: int, priority: str,
                               max_iters: int, trace=None):
    """The ``dense`` loop over the self-padded ELL ``neighbors`` (int32
    ``[V, D]``).  Returns ``(T int32 [V], int32 [2])``: the rounds run and
    the undecided rows left.  ``trace`` (a list) gets each round's
    undecided count."""
    nb = neighbors.to(torch.int64)
    v = nb.shape[0]
    b = id_bits(v)
    vids = torch.arange(v, device=nb.device)
    prio_fn = PRIORITY_FNS[priority]
    t = torch.ones(v, dtype=torch.int64, device=nb.device)
    it = 0
    while it < max_iters:
        und = is_undecided(t)
        n = int(und.sum())              # the twin's host read a round
        if n == 0:
            break
        if trace is not None:
            trace.append(n)
        t = torch.where(und, pack(prio_fn(it, vids), vids, b), t)
        t = _decide(t, nb, k)
        it += 1
    return _result(t, it)


def misk_resident_fixed_point_ref(neighbors, *, k: int, priority: str,
                                  max_iters: int, trace=None):
    """The ``resident`` loop: the refresh over the compacted undecided
    worklist.  Arguments and result as :func:`misk_dense_fixed_point_ref`."""
    nb = neighbors.to(torch.int64)
    v = nb.shape[0]
    b = id_bits(v)
    prio_fn = PRIORITY_FNS[priority]
    t = torch.ones(v, dtype=torch.int64, device=nb.device)
    wl, n = compact_worklist(is_undecided(t))
    it = 0
    while it < max_iters:
        live = int(n.item())            # the twin's host read a round
        if live == 0:
            break
        if trace is not None:
            trace.append(live)
        rows = wl.to(torch.int64).clamp(0, v - 1)
        told = t[rows]
        newt = torch.where(is_undecided(told),
                           pack(prio_fn(it, rows), rows, b), told)
        t = _decide(set_drop(t, wl, newt), nb, k)
        wl, n = compact_worklist(is_undecided(t))
        it += 1
    return _result(t, it)
