"""Parallel, deterministic distance-2 maximal independent set (paper Alg. 1),
PyTorch port of ``repro.core.mis2``.

Engines, bit-identical results for equal options:

* ``dense`` — the plain referent: every round refreshes, min-propagates and
  decides over all ``V`` rows with masks (``mis2_dense_fixed_point``).
* ``cuda_resident`` — the production hot loop (the counterpart of the JAX
  package's ``pallas_resident``).  Fixed ``[V]``-shaped state lives on the
  device; each round is the two fused passes, then both worklists are
  compacted over themselves (sentinel ``V``).  On the card the whole fixed
  point is one cooperative launch (``kernels.minprop_ell.ops.
  resident_fixed_point``: two grid syncs a round, each pass appending the
  rows that stay live to its next list) that reads nothing from the host
  until it ends, as the reference's one jitted ``while_loop``; on the CPU
  its plain-torch twin runs the rounds.
* ``cuda_hybrid`` — the same loop over the degree-aware hybrid layout
  (``core.mis2_hybrid``), for graphs whose padded ELL is too large.
* ``compacted`` / ``cuda_compacted`` — the host-driven §V-B driver: each
  round pulls T and M to the host, rebuilds both worklists with
  ``np.flatnonzero`` and pads them to power-of-two buckets.  ``compacted``
  runs the plain-torch steps, ``cuda_compacted`` (the counterpart of
  ``pallas``) the unfused kernels ``refresh_columns`` / ``decide`` over
  pre-gathered worklist rows.  This is the engine of the Fig. 2 ablation.
* ``compacted_resident`` — the plain steps in the resident loop (worklists
  compacted on the device), for the unpacked and ``csr_segment`` variants
  the kernels do not take.

The Fig. 2 chain of optimizations is ``Mis2Options`` (see
:data:`ABLATION_CHAIN`):

=============  =============================================================
``priority``   §V-A fresh pseudo-random priorities (fixed | xorshift |
               xorshift_star)
``worklists``  §V-B worklist compaction
``packed``     §V-C one 32-bit status word (False: the 3-field tuple, status
               uint8 / rand uint32 / id uint32, whose lexicographic min costs
               three reductions)
``layout``     §V-D ``ell`` = padded rows gathered whole | ``csr_segment`` =
               segment reductions over the COO entries
=============  =============================================================

``cuda_resident`` on the card reads nothing on the host inside the fixed
point; its twin on the CPU and the other resident loops (``cuda_hybrid``,
``compacted_resident``) read one live flag per round, to decide whether
to go on; the host-driven driver pulls two ``[V]`` arrays a round.
``Mis2Result.host_syncs`` reports these reads, and every loop adds them to
the ``repro_torch.obs`` counter ``mis2.host_syncs`` (and a resident solve
one ``mis2.resident_dispatches``), the reference's names.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graphs.handle import as_graph
from ..kernels.minprop_ell import ops, ref
from ..obs import metrics as _obs
from ..obs import span as _obs_span
from .hashing import PRIORITY_FNS
from .segments import segment_reduce
from .tuples import (
    IN,
    OUT,
    OUT_I32,
    S_IN,
    S_OUT,
    S_UND,
    U32MAX,
    effective_priority,
    id_bits,
    is_undecided,
    narrow,
    pack,
    widen,
)

MAX_ITERS_DEFAULT = 128

#: the ``obs`` counters of the MIS-2 loops (the reference's names)
HOST_SYNCS = "mis2.host_syncs"
RESIDENT_DISPATCHES = "mis2.resident_dispatches"


def record_loop(syncs: int, resident: bool = False) -> None:
    """Add one fixed point's host reads to ``mis2.host_syncs`` and, for a
    resident solve (the reference's one dispatch), one to
    ``mis2.resident_dispatches``."""
    _obs.counter(HOST_SYNCS).inc(syncs)
    if resident:
        _obs.counter(RESIDENT_DISPATCHES).inc()


LAYOUTS = ("ell", "csr_segment")


@dataclass(frozen=True)
class Mis2Options:
    priority: str = "xorshift_star"     # fixed | xorshift | xorshift_star
    worklists: bool = True              # §V-B
    packed: bool = True                 # §V-C
    layout: str = "ell"                 # ell | csr_segment  (§V-D)
    max_iters: int = MAX_ITERS_DEFAULT

    def __post_init__(self):
        if self.priority not in PRIORITY_FNS:
            raise ValueError(f"unknown priority {self.priority!r} "
                             f"({' | '.join(PRIORITY_FNS)})")
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r} "
                             f"({' | '.join(LAYOUTS)})")


def _require_worklists(options: Mis2Options, engine: str) -> None:
    if not options.worklists:
        raise ValueError(
            f"{engine} implements §V-B worklist compaction by construction; "
            "use engine='dense' (masked lanes) or the host-driven "
            "'compacted' driver for the no-worklist ablation")


def _require_kernel_layout(options: Mis2Options, engine: str) -> None:
    if not (options.packed and options.layout == "ell"):
        raise ValueError(f"{engine} requires packed tuples + ELL layout")


@dataclass
class Mis2Result:
    in_set: np.ndarray        # bool [V], host
    iterations: int
    converged: bool
    host_syncs: int = 0       # device->host reads inside the fixed point
    collectives: dict | None = None   # cuda_hybrid: the traffic accounting
    num_compiles: int | None = None   # compacted engines: distinct pow2
    #                                   worklist-bucket pairs; resident: 1

    @property
    def size(self) -> int:
        return int(self.in_set.sum())


def _require_entries(neighbors: torch.Tensor, engine: str) -> None:
    """A graph with no entries has no closed neighbourhood to take the min
    over: raise ``ValueError``, as the reference's min over a zero-size
    array does (``neighbors``: the ELL adjacency or the COO column ids)."""
    if neighbors.numel() == 0:
        raise ValueError(f"mis2 engine {engine!r}: the graph has no entries "
                         "(zero-size array to reduction operation min)")


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

def _dense_round(t, und, fresh, neighbors, active):
    """One masked dense round over every row: the rows ``und`` take their
    ``fresh`` tuple (§V-A), then the closed-neighborhood min (§V-D) with
    the IN poison, and the decide (widened int64 words)."""
    t = torch.where(und, fresh, t)
    m = t[neighbors].amin(dim=1)
    m = torch.where(m == IN, OUT, m)            # IN-adjacent poison
    mn = m[neighbors]
    an = active[neighbors]
    any_out = (an & (mn == OUT)).any(dim=1)
    all_eq = (~an | (mn == t[:, None])).all(dim=1)
    t = torch.where(und & any_out, OUT, t)
    return torch.where(und & ~any_out & all_eq, IN, t)


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
        t = _dense_round(t, und, pack(prio_fn(it, vids), vids, b), nb, active)
        it += 1
    record_loop(syncs)
    return t, it, syncs


def _mis2_dense_impl(graph, active=None,
                     options: Mis2Options | None = None) -> Mis2Result:
    options = Mis2Options() if options is None else options
    ell = as_graph(graph).ell
    _require_entries(ell.neighbors, "dense")
    v = ell.num_vertices
    act = _active_mask(active, v, ell.neighbors.device)
    t, iters, syncs = mis2_dense_fixed_point(
        ell.neighbors, act, id_bits(v), options.priority, options.max_iters)
    undecided = bool((is_undecided(t) & act).any())
    return Mis2Result((t == IN).cpu().numpy(), iters, not undecided, syncs)


def mis2_dense_jittable(neighbors: torch.Tensor, active: torch.Tensor,
                        priority: str = "xorshift_star",
                        max_iters: int = MAX_ITERS_DEFAULT):
    """:func:`mis2_dense_fixed_point` with ``b = id_bits(V)`` taken from
    ``neighbors``' rows (the reference's public name, which the batched
    pipelines call).  Returns ``(T widened int64 [V], iterations,
    host_syncs)``."""
    return mis2_dense_fixed_point(neighbors, active,
                                  id_bits(neighbors.shape[0]), priority,
                                  max_iters)


# ===========================================================================
# incremental repair (the streaming mode of the serving layer)
# ===========================================================================

def mis2_repair_fixed_point(neighbors: torch.Tensor, t_init: torch.Tensor,
                            b: int, priority: str = "fixed",
                            max_iters: int = MAX_ITERS_DEFAULT):
    """Warm-started MIS-2 fixed point: the dense round, seeded from a prior
    solution instead of all-undecided.

    ``t_init`` (stored int32 or widened int64) holds IN / OUT on frozen
    vertices and the undecided seed 1 on the reactivated region.  Frozen
    vertices are never refreshed: a frozen IN poisons its distance-2
    neighbourhood like a vertex decided mid-run, a frozen OUT is
    invisible.  With the round-independent ``"fixed"`` priority the result
    is the unique lexicographically-first MIS-2, so a repaired solution
    with no :func:`lexfirst_violations` equals a from-scratch run bit for
    bit.  One call of ``ops.resident_fixed_point_seeded`` over the graph's
    self-padded ELL (int32 ``[V, D]``): on the card one launch with no host
    read inside it; on the CPU its twin, which reads the live count a
    round.  Returns ``(T widened int64 [V], iterations, host_syncs)``;
    ``iterations`` counts the rounds that had an undecided vertex.
    """
    v, dev = neighbors.shape[0], neighbors.device
    t = (t_init if t_init.dtype == torch.int32 else narrow(t_init)).clone()
    m = torch.empty(v, dtype=torch.int32, device=dev)
    t, stats = ops.resident_fixed_point_seeded(
        t, m, neighbors.to(torch.int32).contiguous().view(-1),
        priority=priority, b=b, max_iters=max_iters)
    iters = int(stats[0].item())
    syncs = 0 if dev.type == "cuda" else min(iters + 1, max_iters)
    record_loop(syncs)
    return widen(t), iters, syncs


def lexfirst_violations(neighbors: torch.Tensor, in_set: torch.Tensor,
                        p: torch.Tensor) -> torch.Tensor:
    """Vertices violating the lex-first MIS-2 recurrence (bool ``[V]``).

    Under the packed priority total order ``p`` (widened int64) the
    lex-first MIS-2 is the unique assignment with ``v`` IN iff no member
    within distance 2 has a smaller priority.  ``m2[v]``, two closed
    min-propagations of the members' priorities, is the smallest member
    priority within distance 2: an IN ``v`` must see ``m2 == p[v]``, an OUT
    one ``m2 < p[v]`` (which also covers maximality)."""
    nb = neighbors.to(torch.int64)
    pin = torch.where(in_set, p, OUT)
    m1 = torch.minimum(pin[nb].amin(dim=1), pin)
    m2 = torch.minimum(m1[nb].amin(dim=1), m1)
    return ~torch.where(in_set, m2 == p, m2 < p)


def fixed_packed_priorities(num_vertices: int,
                            device: torch.device | str = "cuda"
                            ) -> torch.Tensor:
    """The packed ``"fixed"``-priority total order (widened int64 ``[V]``)
    under which the MIS-2 fixed point computes the lex-first set."""
    vids = torch.arange(num_vertices, device=device)
    return pack(PRIORITY_FNS["fixed"](0, vids), vids, id_bits(num_vertices))


# ===========================================================================
# device-resident engine: the fixed point in one persistent kernel
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
    """The §V-B compacted fixed point over ``[V]`` device state, one call
    of ``ops.resident_fixed_point``: each round the fused refresh over the
    M worklist, the fused decide over the undecided worklist, both lists
    compacted over themselves; the round counter is both the loop bound and
    the §V-A priority round.  On the card that is one launch with no host
    read inside it; then one pull of the rounds run and the live count
    (the reference's final result pull).  On the CPU the twin reads the
    live count each round and once more at the end unless ``max_iters``
    cut it.  Returns ``(T stored int32 [V], iterations, live count,
    host_syncs)``.
    """
    v, dev = neighbors.shape[0], neighbors.device
    t = torch.empty(v, dtype=torch.int32, device=dev)
    m = torch.empty(v, dtype=torch.int32, device=dev)
    with _obs_span("mis2.resident_fixed_point", layout="ell", packed=True,
                   v=v) as sp:
        t, stats = ops.resident_fixed_point(
            t, m, active, neighbors.contiguous().view(-1), priority=priority,
            b=b, max_iters=max_iters)
        iters, n1 = stats.tolist()
        syncs = 0 if dev.type == "cuda" else min(iters + 1, max_iters)
        record_loop(syncs, resident=True)
        sp.annotate(iterations=iters)
    return t, iters, n1, syncs


def _mis2_resident_impl(graph, active=None,
                        options: Mis2Options | None = None) -> Mis2Result:
    options = Mis2Options() if options is None else options
    _require_worklists(options, "cuda_resident")
    _require_kernel_layout(options, "cuda_resident")
    ell = as_graph(graph).ell
    _require_entries(ell.neighbors, "cuda_resident")
    v = ell.num_vertices
    act = _active_mask(active, v, ell.neighbors.device)
    t, iters, n1, syncs = resident_ell_fixed_point(
        ell.neighbors, act, priority=options.priority,
        max_iters=options.max_iters, b=id_bits(v))
    return Mis2Result(t.cpu().numpy() == IN, iters, n1 == 0, syncs,
                      num_compiles=1)


# ===========================================================================
# the steps of the host-driven and plain resident engines (plain torch)
#   packed: T, M int32 [V] (stored words); unpacked: status uint8, rand and
#   id int32 (stored uint32 words), for T and M each.  Index worklists are
#   int32 with the sentinel V past their live slots (dropped by every
#   scatter); the csr_segment steps take [V] worklist masks instead.
# ===========================================================================

#: jax.ops.segment_max's identity for the int32 flags (an empty segment)
_I32_MIN = -(2 ** 31)


def _rows(wl: torch.Tensor, v: int) -> torch.Tensor:
    return wl.to(torch.int64).clamp(0, v - 1)


def _any_by_row(flags: torch.Tensor, seg: torch.Tensor, v: int):
    """Per row: does any of its entries' ``flags`` hold (``segment_max`` of
    the int32 flags ``> 0``)."""
    return segment_reduce(flags.to(torch.int64), seg, v, "amax",
                          _I32_MIN) > 0


# ---- packed representation ----

def _refresh_rows_packed(t, wl1, it: int, priority: str, b: int):
    """§V-A: the undecided wl1 rows take this round's packed priority."""
    rows = _rows(wl1, t.shape[0])
    told = widen(t[rows])
    newt = pack(PRIORITY_FNS[priority](it, rows), rows, b)
    newt = torch.where(is_undecided(told), newt, told)
    return ops.set_drop(t, wl1, narrow(newt))


def _refresh_cols_packed_ell(t, m, wl2, neighbors):
    """M of the wl2 rows: the twin of the ``refresh_columns`` kernel over
    every slot of the gathered rows."""
    nb = neighbors[_rows(wl2, neighbors.shape[0])]
    return ops.set_drop(m, wl2, ref.refresh_columns_ref(t, nb, nb.shape[0]))


def _decide_packed_ell(t, m, wl1, neighbors, active):
    """T of the wl1 rows: the twin of the ``decide`` kernel."""
    rows = _rows(wl1, neighbors.shape[0])
    newt = ref.decide_ref(t[rows], m, active, neighbors[rows], rows.shape[0])
    return ops.set_drop(t, wl1, newt)


def _refresh_cols_packed_csr(t, m, wl2_mask, edges, v: int):
    edge_rows, edge_cols = edges
    tw = widen(t)
    mv = segment_reduce(tw[edge_cols], edge_rows, v, "amin", U32MAX)
    mv = torch.minimum(mv, tw)                 # closed neighborhood
    mv = torch.where(mv == IN, OUT, mv)
    return torch.where(wl2_mask, narrow(mv), m)


def _decide_packed_csr(t, m, wl1_mask, edges, active, v: int):
    edge_rows, edge_cols = edges
    mn = m[edge_cols]
    an = active[edge_cols]
    has_out = _any_by_row(an & (mn == OUT_I32), edge_rows, v)
    has_out = has_out | (m == OUT_I32)        # closed (self term)
    neq = _any_by_row(an & (mn != t[edge_rows]), edge_rows, v)
    all_eq = ~neq & (m == t)                  # closed (self term)
    newt = torch.where(has_out, OUT_I32, torch.where(all_eq, IN, t))
    newt = torch.where(is_undecided(t), newt, t)
    return torch.where(wl1_mask, newt, t)


# ---- unpacked (3-field) representation (§V-C ablation) ----
# The lexicographic min of (status, rand, id) is taken field by field, as
# the reference does: packing the three into one int64 key would be exact,
# and would be the very optimization this variant switches off.

def _lex_lt(s1, r1, i1, s2, r2, i2):
    return (s1 < s2) | ((s1 == s2) & ((r1 < r2) | ((r1 == r2) & (i1 < i2))))


def _refresh_rows_unpacked(ts, tr, wl1, it: int, priority: str, b: int):
    """§V-A: the undecided wl1 rows take this round's rand field."""
    rows = _rows(wl1, ts.shape[0])
    prio = effective_priority(PRIORITY_FNS[priority](it, rows), b)
    newr = torch.where(ts[rows] == S_UND, narrow(prio), tr[rows])
    return ops.set_drop(tr, wl1, newr)


def _refresh_cols_unpacked_ell(ts, tr, ti, ms, mr, mi, wl2, neighbors):
    nb = neighbors[_rows(wl2, neighbors.shape[0])].to(torch.int64)
    cs, cr, ci = ts[nb], widen(tr[nb]), widen(ti[nb])
    bs, br, bi = cs[:, 0], cr[:, 0], ci[:, 0]
    for j in range(1, nb.shape[1]):           # per-column lexicographic min
        lt = _lex_lt(cs[:, j], cr[:, j], ci[:, j], bs, br, bi)
        bs = torch.where(lt, cs[:, j], bs)
        br = torch.where(lt, cr[:, j], br)
        bi = torch.where(lt, ci[:, j], bi)
    bs = torch.where(bs == S_IN, S_OUT, bs)   # IN-adjacent poison
    return (ops.set_drop(ms, wl2, bs), ops.set_drop(mr, wl2, narrow(br)),
            ops.set_drop(mi, wl2, narrow(bi)))


def _refresh_cols_unpacked_csr(ts, tr, ti, ms, mr, mi, wl2_mask, edges,
                               v: int):
    """Three segment passes: the traffic cost packing removes (§V-C).  An
    empty segment holds the uint8 / uint32 maximum, as
    ``jax.ops.segment_min`` gives it."""
    edge_rows, edge_cols = edges
    ts_w = ts.to(torch.int64)
    es = ts_w[edge_cols]
    smin = segment_reduce(es, edge_rows, v, "amin", 255)
    smin = torch.minimum(smin, ts_w)
    on_s = es == smin[edge_rows]
    del es
    er = widen(tr[edge_cols])
    rmin = segment_reduce(torch.where(on_s, er, U32MAX), edge_rows, v,
                          "amin", U32MAX)
    tr_w = widen(tr)
    s_self = ts_w == smin
    rmin = torch.where(s_self, torch.minimum(rmin, tr_w), rmin)
    on_r = on_s & (er == rmin[edge_rows])
    del on_s, er
    ei = widen(ti[edge_cols])
    imin = segment_reduce(torch.where(on_r, ei, U32MAX), edge_rows, v,
                          "amin", U32MAX)
    del on_r, ei
    imin = torch.where(s_self & (tr_w == rmin),
                       torch.minimum(imin, widen(ti)), imin)
    smin = torch.where(smin == S_IN, S_OUT, smin)
    return (torch.where(wl2_mask, smin.to(torch.uint8), ms),
            torch.where(wl2_mask, narrow(rmin), mr),
            torch.where(wl2_mask, narrow(imin), mi))


def _decide_unpacked_ell(ts, tr, ti, ms, mr, mi, wl1, neighbors, active):
    rows = _rows(wl1, neighbors.shape[0])
    nb = neighbors[rows].to(torch.int64)
    an = active[nb]
    cs, cr, ci = ms[nb], mr[nb], mi[nb]
    tvs, tvr, tvi = ts[rows], tr[rows], ti[rows]
    any_out = (an & (cs == S_OUT)).any(dim=1)
    eq = (cs == S_UND) & (cr == tvr[:, None]) & (ci == tvi[:, None])
    all_eq = (~an | eq).all(dim=1)
    news = torch.where(any_out, S_OUT, torch.where(all_eq, S_IN, tvs))
    news = torch.where(tvs == S_UND, news, tvs)
    return ops.set_drop(ts, wl1, news)


def _decide_unpacked_csr(ts, tr, ti, ms, mr, mi, wl1_mask, edges, active,
                         v: int):
    edge_rows, edge_cols = edges
    an = active[edge_cols]
    cs, cr, ci = ms[edge_cols], mr[edge_cols], mi[edge_cols]
    any_out = _any_by_row(an & (cs == S_OUT), edge_rows, v) | (ms == S_OUT)
    neq = (cs != S_UND) | (cr != tr[edge_rows]) | (ci != ti[edge_rows])
    some_neq = _any_by_row(an & neq, edge_rows, v)
    self_eq = (ms == S_UND) & (mr == tr) & (mi == ti)
    all_eq = ~some_neq & self_eq
    news = torch.where(any_out, S_OUT, torch.where(all_eq, S_IN, ts))
    news = torch.where(ts == S_UND, news, ts)
    return torch.where(wl1_mask, news, ts)


# ---- one round, either representation ----

def _initial_state(active: torch.Tensor, packed: bool) -> tuple:
    """Round-0 state: ``(T, M)`` packed, ``(ts, tr, ti, ms, mr, mi)``
    unpacked; inactive vertices are OUT and never refreshed."""
    v, dev = active.shape[0], active.device
    if packed:
        return (torch.where(active, 1, OUT_I32).to(torch.int32),
                torch.full((v,), OUT_I32, dtype=torch.int32, device=dev))
    none = torch.full((v,), -1, dtype=torch.int32, device=dev)   # U32MAX
    return (torch.where(active, S_UND, S_OUT).to(torch.uint8),
            torch.zeros(v, dtype=torch.int32, device=dev),
            torch.arange(v, dtype=torch.int32, device=dev),
            torch.full((v,), S_OUT, dtype=torch.uint8, device=dev),
            none, none.clone())


def _ell_round(state: tuple, wl1, wl2, neighbors, active, it: int, *,
               priority: str, b: int, counts=None) -> tuple:
    """Row refresh, column refresh and decide over the ELL rows of the two
    worklists.  ``counts`` (the live slots of ``wl1`` and ``wl2``) sends
    the packed passes through the ``refresh_columns`` / ``decide`` kernels;
    None runs the plain steps."""
    if len(state) == 2:
        t, m = state
        t = _refresh_rows_packed(t, wl1, it, priority, b)
        if counts is None:
            m = _refresh_cols_packed_ell(t, m, wl2, neighbors)
            t = _decide_packed_ell(t, m, wl1, neighbors, active)
        else:
            m = ops.refresh_columns(t, m, wl2, neighbors, counts[1])
            t = ops.decide(t, m, wl1, neighbors, active, counts[0])
        return t, m
    ts, tr, ti, ms, mr, mi = state
    tr = _refresh_rows_unpacked(ts, tr, wl1, it, priority, b)
    ms, mr, mi = _refresh_cols_unpacked_ell(ts, tr, ti, ms, mr, mi, wl2,
                                            neighbors)
    ts = _decide_unpacked_ell(ts, tr, ti, ms, mr, mi, wl1, neighbors, active)
    return ts, tr, ti, ms, mr, mi


def _csr_round(state: tuple, wl1_mask, wl2_mask, edges, active, it: int, *,
               priority: str, b: int) -> tuple:
    """The round over the ``csr_segment`` layout, worklists as masks; the
    row refresh goes through the mask (equal to the index scatter, as wl1
    holds every undecided row)."""
    v = active.shape[0]
    vids = torch.arange(v, device=active.device)
    prio = PRIORITY_FNS[priority](it, vids)
    if len(state) == 2:
        t, m = state
        fresh = narrow(pack(prio, vids, b))
        t = torch.where(wl1_mask & is_undecided(t), fresh, t)
        m = _refresh_cols_packed_csr(t, m, wl2_mask, edges, v)
        t = _decide_packed_csr(t, m, wl1_mask, edges, active, v)
        return t, m
    ts, tr, ti, ms, mr, mi = state
    tr = torch.where(wl1_mask & (ts == S_UND),
                     narrow(effective_priority(prio, b)), tr)
    ms, mr, mi = _refresh_cols_unpacked_csr(ts, tr, ti, ms, mr, mi, wl2_mask,
                                            edges, v)
    ts = _decide_unpacked_csr(ts, tr, ti, ms, mr, mi, wl1_mask, edges,
                              active, v)
    return ts, tr, ti, ms, mr, mi


def _undecided_live(state: tuple, host: bool = False):
    """(undecided rows, rows whose M is not OUT): the next worklists, as
    masks of either representation; ``host`` pulls T and M (the words or
    the two statuses) to the host first."""
    packed = len(state) == 2
    t, m = state[0], state[1 if packed else 3]
    if host:
        t, m = t.cpu(), m.cpu()
    if packed:
        return is_undecided(t), m != OUT_I32
    return t == S_UND, m != S_OUT


def _in_set(state: tuple) -> np.ndarray:
    return (state[0] == (IN if len(state) == 2 else S_IN)).cpu().numpy()


def _layout(gh, options: Mis2Options, engine: str):
    """``(V, ELL neighbors or None, int64 COO edges or None)``; raises on a
    graph with no entries."""
    if options.layout == "ell":
        nbrs = gh.ell.neighbors
        _require_entries(nbrs, engine)
        return nbrs.shape[0], nbrs, None
    edges = tuple(x.to(torch.int64) for x in gh.csr_edges)
    _require_entries(edges[1], engine)
    return gh.num_vertices, None, edges


# ===========================================================================
# the host-driven driver (compacted / cuda_compacted)
# ===========================================================================

def _bucket(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _pad_worklist(idx: np.ndarray, v: int, device) -> torch.Tensor:
    out = np.full(_bucket(len(idx)), v, dtype=np.int32)
    out[:len(idx)] = idx
    return torch.from_numpy(out).to(device)


class _WorklistPadCache:
    """Per-solve record of the pow2 bucket shapes the host driver used.

    ``shape_pairs`` holds the distinct ``(len(wl1), len(wl2))`` pairs: the
    reference's jit-churn metric, reported as ``Mis2Result.num_compiles``.
    Each pad is a fresh host buffer: ``torch.from_numpy`` aliases it, and
    on the CPU ``.to`` keeps the alias, so refilling a reused buffer would
    rewrite a live worklist.
    """

    def __init__(self, v: int, device):
        self.v = v
        self.device = device
        self.shape_pairs: set[tuple[int, int]] = set()

    def pad(self, idx: np.ndarray) -> torch.Tensor:
        return _pad_worklist(idx, self.v, self.device)


def _mask_of(wl: torch.Tensor, v: int) -> torch.Tensor:
    buf = torch.zeros(v + 1, dtype=torch.bool, device=wl.device)
    buf[wl.to(torch.int64)] = True
    return buf[:v]


def _mis2_compacted_impl(graph, active=None,
                         options: Mis2Options | None = None, *,
                         kernels: bool = False) -> Mis2Result:
    """Engine entry for ``compacted`` and, with ``kernels``,
    ``cuda_compacted``.

    Without worklists the round-0 buffers (every active row, every row)
    serve every round.  The kernels are given the live count of the buffer
    they get, which is then the round-0 count: the reference's ``pallas``
    engine passes the current worklist's length there instead, and its
    kernels write OUT into the M of real rows past it.
    """
    options = Mis2Options() if options is None else options
    if kernels:
        _require_kernel_layout(options, "cuda_compacted")
    gh = as_graph(graph)
    v, nbrs, edges = _layout(gh, options,
                             "cuda_compacted" if kernels else "compacted")
    act = _active_mask(active, v, gh.device)
    kw = dict(priority=options.priority, b=id_bits(v))
    state = _initial_state(act, options.packed)
    pads = _WorklistPadCache(v, gh.device)
    wl1_np = np.flatnonzero(act.cpu().numpy()).astype(np.int32)
    wl2_np = np.arange(v, dtype=np.int32)
    it = syncs = 0
    while len(wl1_np) and it < options.max_iters:
        if options.worklists or it == 0:
            wl1, wl2 = pads.pad(wl1_np), pads.pad(wl2_np)
            counts = (len(wl1_np), len(wl2_np))
            if edges is not None:
                wl1_mask, wl2_mask = _mask_of(wl1, v), _mask_of(wl2, v)
        pads.shape_pairs.add((len(wl1), len(wl2)))
        if edges is None:
            state = _ell_round(state, wl1, wl2, nbrs, act, it,
                               counts=counts if kernels else None, **kw)
        else:
            state = _csr_round(state, wl1_mask, wl2_mask, edges, act, it,
                               **kw)
        # the host-driven driver by design: T and M pulled every round
        # repro-lint: ignore[RL101] mis2.host_syncs counts both; the reference's pallas pulls both
        wl1_np, wl2_np = (np.flatnonzero(x.numpy()).astype(np.int32)
                          for x in _undecided_live(state, host=True))
        syncs += 2                    # T and M pulled to the host
        it += 1
    record_loop(syncs)
    return Mis2Result(_in_set(state), it, len(wl1_np) == 0, syncs,
                      num_compiles=max(1, len(pads.shape_pairs)))


# ===========================================================================
# the plain steps in the resident loop (compacted_resident)
# ===========================================================================

def _mis2_resident_plain_impl(graph, active=None,
                              options: Mis2Options | None = None
                              ) -> Mis2Result:
    """Engine entry for ``compacted_resident``: the round of the host
    driver over ``[V]`` device state, the worklists compacted on the device
    (ELL) or kept as masks (``csr_segment``); one host read a round, as
    ``cuda_resident``'s twin on the CPU."""
    options = Mis2Options() if options is None else options
    _require_worklists(options, "compacted_resident")
    gh = as_graph(graph)
    v, nbrs, edges = _layout(gh, options, "compacted_resident")
    act = _active_mask(active, v, gh.device)
    kw = dict(priority=options.priority, b=id_bits(v))
    state = _initial_state(act, options.packed)
    und, live = act, torch.ones(v, dtype=torch.bool, device=gh.device)
    it = syncs = 0
    while it < options.max_iters:
        syncs += 1
        # the one host read per round (the plain steps launch no kernel:
        # _ell_round without counts), the flag the reference's
        # compacted_resident while_loop tests on the device
        # repro-lint: ignore[RL101] mis2.host_syncs counts it; the flag the reference's loop tests
        if not bool(und.any()):
            break
        if edges is None:
            wl1, _ = compact_worklist(und)
            wl2, _ = compact_worklist(live)
            state = _ell_round(state, wl1, wl2, nbrs, act, it, **kw)
        else:
            state = _csr_round(state, und, live, edges, act, it, **kw)
        und, live = _undecided_live(state)
        it += 1
    record_loop(syncs, resident=True)
    return Mis2Result(_in_set(state), it, not bool(und.any()), syncs,
                      num_compiles=1)

#: the engines that partition the vertices over a process group
DISTRIBUTED_ENGINES = ("distributed", "distributed_single_gather")


def run_mis2(graph, active=None, options: Mis2Options | None = None,
             engine: str = "cuda_resident", backend=None) -> Mis2Result:
    """Engine dispatch used by the facade and the coarsening drivers; every
    engine gives a bit-identical set for equal options.  ``backend`` names
    the process group of the distributed engines (``Backend.group``)."""
    if engine in DISTRIBUTED_ENGINES:
        from .dist import _mis2_distributed_impl

        return _mis2_distributed_impl(
            graph, active, options, backend=backend,
            single_gather=engine == "distributed_single_gather")
    if engine == "dense":
        return _mis2_dense_impl(graph, active, options)
    if engine == "cuda_resident":
        return _mis2_resident_impl(graph, active, options)
    if engine == "cuda_hybrid":
        from .mis2_hybrid import _mis2_hybrid_impl

        return _mis2_hybrid_impl(graph, active, options)
    if engine in ("compacted", "cuda_compacted"):
        return _mis2_compacted_impl(graph, active, options,
                                    kernels=engine == "cuda_compacted")
    if engine == "compacted_resident":
        return _mis2_resident_plain_impl(graph, active, options)
    raise ValueError(f"unknown mis2 engine {engine!r} (dense | compacted | "
                     "cuda_compacted | compacted_resident | cuda_resident | "
                     "cuda_hybrid | distributed | "
                     "distributed_single_gather)")


# Fig. 2 cumulative ablation chain: Bell's baseline, then each of the
# paper's four optimizations switched on in turn (the last entry is the
# production default)
ABLATION_CHAIN = {
    "baseline_bell": Mis2Options(priority="fixed", worklists=False,
                                 packed=False, layout="csr_segment"),
    "+rand_priority": Mis2Options(priority="xorshift_star", worklists=False,
                                  packed=False, layout="csr_segment"),
    "+worklists": Mis2Options(priority="xorshift_star", worklists=True,
                              packed=False, layout="csr_segment"),
    "+packed_status": Mis2Options(priority="xorshift_star", worklists=True,
                                  packed=True, layout="csr_segment"),
    "+simd_ell": Mis2Options(priority="xorshift_star", worklists=True,
                             packed=True, layout="ell"),
}
