"""Plain-torch twins of the MIS-2 kernels (``csrc/minprop_ell.cu``).

The fused and sliced twins compute what their kernels compute, in place:
the function of ``repro.kernels.minprop_ell.ref.fused_*_ref`` (or of the
sliced Pallas kernels) followed by the drop-scatter
``x.at[gids].set(out, mode="drop")`` of the JAX ops wrapper.  Slots at or
past ``count`` and sentinel slots (``wl[i] == V``, or ``R`` for a hybrid
slab of ``R`` rows) write nothing.  The sliced decide also takes
``active=None``: then a neighbour is active exactly when its M is not IN.

``resident_fixed_point_ref`` is the twin of the persistent kernel: the
resident fixed point, round after round of the fused twins and the ordered
compaction of both worklists over themselves (``compact_over_ref``); it
reads the live count on the host each round.  Its batched form
(``resident_fixed_point_batched_ref``: a bucket of graphs as one
block-diagonal ELL, each row hashing its member-local id with its member's
bits, and each member's round count) and its seeded form
(``resident_fixed_point_seeded_ref``: from a given T, every row active) run
the same loop.  ``hybrid_fixed_point_ref``
is the twin of the hybrid persistent kernel, the same loop over each slab
of the hybrid layout (the sliced twins, each slab's lists compacted over
themselves) and the spill's passes by ``scatter_reduce`` (``segment_reduce``
with ``amin`` / ``amax`` on widened int64, whose result does not depend on
the order of the entries).

``refresh_columns_ref`` / ``decide_ref`` are the twins of the host-driven
round's kernels: they take pre-gathered worklist rows ``[W, D]`` and return
a ``[W]`` output, exactly as ``repro.kernels.minprop_ell.ref``'s functions
of the same names (slots at or past ``count`` hold OUT, or the row's own
tuple for decide).

The words are stored as int32 bit patterns and widened to int64 for every
compare (see ``core.tuples``).  ``count`` and ``it`` are one-element int32
tensors, read on the device: a twin issues no host sync, so it can be
timed beside its kernel on the card.  They do the work of every slot and
mask the dead ones, which is the plain version and no yardstick of speed.
"""
from __future__ import annotations

import torch

from ...core.hashing import PRIORITY_FNS
from ...core.segments import segment_reduce
from ...core.tuples import IN, OUT, OUT_I32, is_undecided, narrow, pack, widen


def _refresh(t_u: torch.Tensor, ids: torch.Tensor, it: torch.Tensor,
             priority: str, b: int, members=None) -> torch.Tensor:
    """§V-A refresh of widened tuples ``t_u`` of vertices ``ids``; in a
    bucket of graphs laid end to end (``members = (bits int32 [B], rows)``)
    each vertex hashes its member-local id ``id % rows`` and packs it with
    its member's ``bits[id // rows]``."""
    if members is not None:
        bits, rows = members
        b = bits.to(torch.int64)[ids.to(torch.int64) >> (rows.bit_length() - 1)]
        ids = ids & (rows - 1)
    fresh = pack(PRIORITY_FNS[priority](it, ids), ids, b)
    return torch.where(is_undecided(t_u), fresh, t_u)


def _live_slots(wl: torch.Tensor, count: torch.Tensor, r: int):
    """(worklist entries clamped into [0, R), live mask of the slots)."""
    slot = torch.arange(wl.shape[0], device=wl.device)
    live = (slot < count.to(torch.int64)) & (wl >= 0) & (wl < r)
    return wl.to(torch.int64).clamp(0, r - 1), live


def set_drop(x: torch.Tensor, target: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """``x.at[target].set(vals, mode="drop")`` for a ``[V]`` tensor whose
    out-of-range targets are the sentinel ``V``: a new tensor (a ``[V+1]``
    buffer whose dump slot ``V`` is sliced off)."""
    v = x.shape[0]
    buf = torch.empty(v + 1, dtype=x.dtype, device=x.device)
    buf[:v] = x
    buf.scatter_(0, target.to(torch.int64), vals)
    return buf[:v]


def _scatter_drop(x: torch.Tensor, target: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """x[target] = vals in place, dropping target == V."""
    x.copy_(set_drop(x, target, vals))


def _refresh_min(t, nb, it, priority: str, b: int,
                 members=None) -> torch.Tensor:
    """Per row of ``nb`` [n, D]: min of the refreshed T over the ids, with
    IN -> OUT (the widened M values)."""
    vids = torch.arange(t.shape[0], device=t.device)
    t_ref = _refresh(widen(t), vids, it, priority, b, members)
    mv = t_ref[nb].amin(dim=1)
    return torch.where(mv == 0, OUT, mv)


def _decide(t, m, active, rows, nb, it, priority: str, b: int,
            members=None) -> torch.Tensor:
    """The widened new T of global rows ``rows`` [n] with adjacency ``nb``
    [n, D]: IN / OUT / the refreshed tuple; decided rows keep theirs.
    ``active=None``: the neighbours whose M is not IN are active."""
    tv_old = widen(t)[rows]
    tv = _refresh(tv_old, rows, it, priority, b, members)
    mn = widen(m)[nb]
    an = mn != IN if active is None else active[nb]
    any_out = (an & (mn == OUT)).any(dim=1)
    all_eq = (~an | (mn == tv[:, None])).all(dim=1)
    newt = torch.where(any_out, OUT, torch.where(all_eq, 0, tv))
    return torch.where(is_undecided(tv_old), newt, tv_old)


def fused_refresh_columns_ref(t, m, nbrs_flat, wl, count, it, *,
                              priority: str, b: int,
                              members=None) -> torch.Tensor:
    """M[wl] <- closed-neighborhood min of the refreshed T, IN -> OUT
    (``members``: a bucket's, as ``_refresh`` takes them)."""
    v = t.shape[0]
    rows, live = _live_slots(wl, count, v)
    nb = nbrs_flat.view(v, -1)[rows].to(torch.int64)
    mv = _refresh_min(t, nb, it, priority, b, members)
    _scatter_drop(m, torch.where(live, rows, v), narrow(mv))
    return m


def fused_decide_ref(t, m, active, nbrs_flat, wl, count, it, *,
                     priority: str, b: int, members=None) -> torch.Tensor:
    """T[wl] <- IN / OUT / refreshed tuple for the still-undecided rows."""
    v = t.shape[0]
    rows, live = _live_slots(wl, count, v)
    nb = nbrs_flat.view(v, -1)[rows].to(torch.int64)
    newt = _decide(t, m, active, rows, nb, it, priority, b, members)
    _scatter_drop(t, torch.where(live, rows, v), narrow(newt))
    return t


def sliced_refresh_columns_ref(t, m, slab_rows, nbrs_flat, wl, count, it, *,
                               priority: str, b: int) -> torch.Tensor:
    """The fused refresh over one hybrid slab ``[R, W]``: ``wl`` holds
    slab-local rows (sentinel ``R``); M is written at the global ids
    ``slab_rows[wl]``."""
    r = slab_rows.shape[0]
    local, live = _live_slots(wl, count, r)
    rows = slab_rows.to(torch.int64)[local]
    nb = nbrs_flat.view(r, -1)[local].to(torch.int64)
    mv = _refresh_min(t, nb, it, priority, b)
    _scatter_drop(m, torch.where(live, rows, t.shape[0]), narrow(mv))
    return m


def sliced_decide_ref(t, m, active, slab_rows, nbrs_flat, wl, count, it, *,
                      priority: str, b: int) -> torch.Tensor:
    """The fused decide over one hybrid slab: the row's global id keys the
    T read, the refresh and the write.  ``active=None``: the neighbours
    whose M is not IN are active."""
    r = slab_rows.shape[0]
    local, live = _live_slots(wl, count, r)
    rows = slab_rows.to(torch.int64)[local]
    nb = nbrs_flat.view(r, -1)[local].to(torch.int64)
    newt = _decide(t, m, active, rows, nb, it, priority, b)
    _scatter_drop(t, torch.where(live, rows, t.shape[0]), narrow(newt))
    return t


# ---------------------------------------------------------------------------
# the resident fixed point (the persistent kernel's twin)
# ---------------------------------------------------------------------------

def compact_over_ref(prev: torch.Tensor, count: int,
                     keep: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The rows of the worklist ``prev[:count]`` that ``keep`` (bool
    ``[V]``) holds, in their order, then the sentinel ``V``: ``(int32 [V],
    their count)``.  ``prev`` ascending and every kept row in
    ``prev[:count]``, this is ``core.mis2.compact_worklist(keep)`` slot for
    slot, as the kernel's compaction of a list over itself computes it."""
    v = keep.shape[0]
    rows = prev[:count]
    kept = rows[keep[rows.to(torch.int64)]]
    out = torch.full((v,), v, dtype=torch.int32, device=prev.device)
    out[:kept.shape[0]] = kept
    return out, int(kept.shape[0])


def resident_fixed_point_ref(t, m, active, nbrs_flat, *, priority: str,
                             b: int, max_iters: int, trace=None):
    """The §V-B fixed point over padded ELL from ``active``: T = 1 on the
    active rows and OUT elsewhere, M = OUT, the undecided worklist the
    active rows and the M worklist every row; each round the fused refresh
    over the M worklist, the fused decide over the undecided one, and both
    compacted over themselves, while a row is undecided and fewer than
    ``max_iters`` rounds ran.  ``t``, ``m`` (int32 ``[V]``) are written in
    place, whatever they held.  Returns ``(t, int32 [2])``: the rounds run
    and the undecided worklist's last count.  ``trace`` (a list) gets each
    round's live counts ``(M worklist, undecided worklist)``."""
    t.copy_(torch.where(active, 1, OUT_I32).to(torch.int32))
    it, n1, _ = _resident_loop(t, m, active, nbrs_flat, priority=priority,
                               b=b, max_iters=max_iters, trace=trace)
    return t, torch.tensor([it, n1], dtype=torch.int32, device=t.device)


def resident_fixed_point_batched_ref(t, m, active, nbrs_flat, *,
                                     priority: str, bits: torch.Tensor,
                                     rows: int, max_iters: int, trace=None):
    """:func:`resident_fixed_point_ref` over a bucket of ``B`` graphs laid
    end to end, ``rows`` (a power of two) each: the block-diagonal ELL of
    ``V = B * rows`` rows, row ``i`` hashing its local id ``i % rows`` with
    its member's ``bits[i // rows]`` (int32 ``[B]``).  Returns ``(t, int32
    [2], int32 [B])``: the rounds run, the last live count, and each
    member's rounds with an undecided row (the reference's vmapped
    ``while_loop`` counters: a member stops for good, so every live
    member's count is the loop's round)."""
    t.copy_(torch.where(active, 1, OUT_I32).to(torch.int32))
    it, n1, its = _resident_loop(t, m, active, nbrs_flat, priority=priority,
                                 b=1, max_iters=max_iters, trace=trace,
                                 members=(bits, rows))
    return t, torch.tensor([it, n1], dtype=torch.int32, device=t.device), its


def resident_fixed_point_seeded_ref(t, m, nbrs_flat, *, priority: str,
                                    b: int, max_iters: int, trace=None):
    """:func:`resident_fixed_point_ref` from the T that ``t`` holds (IN /
    OUT on frozen rows, undecided words on the rows to solve) with every
    row active: the undecided worklist starts as T's undecided rows.  This
    is the reference's ``mis2_repair_fixed_point``: its dense round with
    every row active, a frozen IN poisoning its neighbourhood and a frozen
    OUT invisible.  Returns ``(t, int32 [2])`` as
    :func:`resident_fixed_point_ref`."""
    active = torch.ones(t.shape[0], dtype=torch.bool, device=t.device)
    it, n1, _ = _resident_loop(t, m, active, nbrs_flat, priority=priority,
                               b=b, max_iters=max_iters, trace=trace)
    return t, torch.tensor([it, n1], dtype=torch.int32, device=t.device)


def _resident_loop(t, m, active, nbrs_flat, *, priority: str, b: int,
                   max_iters: int, trace=None, members=None):
    """The resident rounds from the T that ``t`` holds: the undecided
    worklist its undecided rows, the M worklist every row, M = OUT.
    Returns ``(rounds run, last live count, int32 [B] member rounds)``
    (empty without ``members``)."""
    v, dev = t.shape[0], t.device
    m.fill_(OUT_I32)
    every = torch.arange(v, dtype=torch.int32, device=dev)
    wl1, n1 = compact_over_ref(every, v, is_undecided(t))
    wl2, n2 = every, v
    its = torch.zeros(0 if members is None else members[0].shape[0],
                      dtype=torch.int32, device=dev)
    kw = dict(priority=priority, b=b, members=members)
    it = 0
    while it < max_iters:
        if n1 == 0:                   # the twin's host read a round
            break
        if trace is not None:
            trace.append((n2, n1))
        if members is not None:       # the members with an undecided row
            shift = members[1].bit_length() - 1
            its[wl1[:n1].to(torch.int64) >> shift] = it + 1
        it_t = torch.full((1,), it, dtype=torch.int32, device=dev)
        fused_refresh_columns_ref(t, m, nbrs_flat, wl2, _count(n2, dev),
                                  it_t, **kw)
        fused_decide_ref(t, m, active, nbrs_flat, wl1, _count(n1, dev), it_t,
                         **kw)
        wl1, n1 = compact_over_ref(wl1, n1, is_undecided(t))
        wl2, n2 = compact_over_ref(wl2, n2, m != OUT_I32)
        it += 1
    return it, n1, its


def _count(n: int, device) -> torch.Tensor:
    return torch.full((1,), n, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# the hybrid layout's spill passes and fixed point (the hybrid persistent
# kernel's twin)
# ---------------------------------------------------------------------------

def spill_refresh_columns(t, m, spill_rows, spill_seg, spill_cols, live, it,
                          *, priority: str, b: int) -> torch.Tensor:
    """M over the heavy (spill) rows: the closed min of the refreshed T
    with IN -> OUT, as the slab kernels; rows off the round's ``live`` mask
    keep their M (in place; returns ``m``)."""
    h = spill_rows.shape[0]
    rows = spill_rows.to(torch.int64)
    cols = spill_cols.to(torch.int64)
    te = _refresh(widen(t)[cols], cols, it, priority, b)
    mv = segment_reduce(te, spill_seg, h, "amin", OUT)
    tself = _refresh(widen(t)[rows], rows, it, priority, b)
    mv = torch.minimum(mv, tself)
    mv = torch.where(mv == IN, OUT, mv)
    m[rows] = torch.where(live[rows], narrow(mv), m[rows])
    return m


def spill_decide(t, m, active, spill_rows, spill_seg, spill_cols, it, *,
                 priority: str, b: int) -> torch.Tensor:
    """The IN/OUT decision of the heavy rows by segment reductions, equal
    to the slab decide: neighbour terms gated by ``active``, the self term
    folded in, still-undecided rows written with their refreshed tuple (in
    place; returns ``t``)."""
    h = spill_rows.shape[0]
    rows = spill_rows.to(torch.int64)
    cols = spill_cols.to(torch.int64)
    seg = spill_seg.to(torch.int64)
    tv_old = widen(t)[rows]
    tv = _refresh(tv_old, rows, it, priority, b)
    mn = widen(m)[cols]
    an = active[cols]
    any_out = segment_reduce((an & (mn == OUT)).to(torch.int64), seg, h,
                             "amax", 0) > 0
    neq = segment_reduce((an & (mn != tv[seg])).to(torch.int64), seg, h,
                         "amax", 0) > 0
    m_self = widen(m)[rows]
    a_self = active[rows]
    any_out = any_out | (a_self & (m_self == OUT))
    neq = neq | (a_self & (m_self != tv))
    newt = torch.where(any_out, OUT, torch.where(~neq, IN, tv))
    t[rows] = narrow(torch.where(is_undecided(tv_old), newt, tv_old))
    return t


def hybrid_fixed_point_ref(t, m, active, slabs, spill, *, priority: str,
                           b: int, max_iters: int, trace=None):
    """The §V-B fixed point over the hybrid layout (the reference's
    ``_hybrid_fixed_point``): T = 1 on the active rows (every row when
    ``active`` is None) and OUT elsewhere, M = OUT; each slab's undecided
    list its active rows and its M list every row.  Each round, while a
    row is undecided and fewer than ``max_iters`` rounds ran: the sliced
    refresh of every slab over its M list, the spill's refresh, the sliced
    decide of every slab over its undecided list (without a mask when
    ``active`` is None), the spill's decide, and each slab's two lists
    compacted over themselves (``compact_over_ref``, sentinel ``R``).
    ``slabs``: ``(rows int32 [R], ids int32 [R*D])`` each; ``spill``:
    ``(rows [H], seg [E], cols [E])``.  ``t``, ``m`` (int32 ``[V]``) are
    written in place.  Returns ``(t, int32 [2], int64 [S])``: the rounds
    run and the last live count, and each slab's live list rows processed.
    ``trace`` (a list) gets each round's ``(lists, heavy_live,
    heavy_undecided)``: per slab ``(M list, undecided list)`` as ``(int32
    [R] buffer, count)`` pairs, and bool ``[H]`` masks of the heavy rows
    the round's spill refresh and decide visit (M not OUT, every row in
    round 0; T undecided), all as the round starts."""
    v, dev = t.shape[0], t.device
    act = torch.ones(v, dtype=torch.bool, device=dev) if active is None \
        else active
    t.copy_(torch.where(act, 1, OUT_I32).to(torch.int32))
    m.fill_(OUT_I32)
    kw = dict(priority=priority, b=b)
    lists = []
    for rows, _ in slabs:
        r = rows.shape[0]
        every = torch.arange(r, dtype=torch.int32, device=dev)
        lists.append([(every, r),
                      compact_over_ref(every, r, act[rows.to(torch.int64)])])
    acc = torch.zeros(len(slabs), dtype=torch.int64, device=dev)
    has_spill = spill[0].shape[0] > 0
    n1 = int(is_undecided(t).sum())
    it = 0
    while it < max_iters:
        if n1 == 0:                   # the twin's host read a round
            break
        it_t = torch.full((1,), it, dtype=torch.int32, device=dev)
        live = m != OUT_I32 if it else torch.ones(v, dtype=torch.bool,
                                                  device=dev)
        if trace is not None:
            heavy = spill[0].to(torch.int64)
            trace.append(([tuple(x) for x in lists], live[heavy],
                          is_undecided(t)[heavy]))
        for (rows, nbrs), ((wl2, n2), _) in zip(slabs, lists):
            sliced_refresh_columns_ref(t, m, rows, nbrs, wl2, _count(n2, dev),
                                       it_t, **kw)
        if has_spill:
            spill_refresh_columns(t, m, *spill, live, it_t, **kw)
        for (rows, nbrs), (_, (wl1, n1s)) in zip(slabs, lists):
            sliced_decide_ref(t, m, active, rows, nbrs, wl1, _count(n1s, dev),
                              it_t, **kw)
        if has_spill:
            spill_decide(t, m, act, *spill, it_t, **kw)
        und, mlive = is_undecided(t), m != OUT_I32
        for i, ((rows, _), ((wl2, n2), (wl1, n1s))) in enumerate(
                zip(slabs, lists)):
            acc[i] += n1s + n2
            r64 = rows.to(torch.int64)
            lists[i] = [compact_over_ref(wl2, n2, mlive[r64]),
                        compact_over_ref(wl1, n1s, und[r64])]
        n1 = int(und.sum())
        it += 1
    return t, torch.tensor([it, n1], dtype=torch.int32, device=dev), acc


# ---------------------------------------------------------------------------
# the host-driven round: pre-gathered worklist rows in, a [W] output out
# ---------------------------------------------------------------------------

def _live(w: int, count: int, device) -> torch.Tensor:
    return torch.arange(w, device=device) < count


def refresh_columns_ref(t, wl_neighbors, count: int) -> torch.Tensor:
    """M of each pre-gathered worklist row: the min of T over the row's
    ids with IN -> OUT; OUT at slots ``>= count``.  ``t``: int32 [V]
    (stored words); ``wl_neighbors``: int32 [W, D]; returns int32 [W]."""
    mv = widen(t)[wl_neighbors.to(torch.int64)].amin(dim=1)
    mv = torch.where(mv == IN, OUT, mv)
    return narrow(torch.where(_live(mv.shape[0], count, t.device), mv, OUT))


def decide_ref(t_rows, m, active, wl_neighbors, count: int) -> torch.Tensor:
    """New T of each pre-gathered worklist row: OUT if an active
    neighbour's M is OUT, else IN if every active neighbour's M equals the
    row's tuple, else the tuple; decided rows and slots ``>= count`` keep
    theirs.  ``t_rows``: int32 [W]; ``m``: int32 [V]; ``active``: bool [V];
    ``wl_neighbors``: int32 [W, D]; returns int32 [W].  Only equality is
    asked of the words, so they stay in the stored form."""
    nb = wl_neighbors.to(torch.int64)
    mn = m[nb]
    an = active[nb]
    any_out = (an & (mn == OUT_I32)).any(dim=1)
    all_eq = (~an | (mn == t_rows[:, None])).all(dim=1)
    newt = torch.where(any_out, OUT_I32, torch.where(all_eq, IN, t_rows))
    keep = ~is_undecided(t_rows) | ~_live(t_rows.shape[0], count, m.device)
    return torch.where(keep, t_rows, newt)
