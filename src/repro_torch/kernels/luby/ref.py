"""Plain-torch twins of the Luby coloring kernel (``csrc/luby.cu``): the
reference's round loops ``repro.core.coloring._color_fixed_point`` (padded
ELL), ``_color_fixed_point_hybrid`` (the hybrid layout's slabs and COO
spill) and ``repro.batch.pipeline._color_batch_impl``'s (a bucket of
graphs), round for round.

Each round hashes the priorities with the hash-pack wrapper
(``kernels.hash_priority.ops.round_priorities``, its own twin on the CPU)
and runs the rowwise round in plain torch; the loop reads one flag a round
on the host, which is the plain version and no yardstick of speed.  The
words are widened to int64 for every compare (see ``core.tuples``).

The batched twin hashes with the batched hash-pack wrapper
(``round_priorities_batched``: each member's local ids and its own bits).
"""
from __future__ import annotations

import torch

from ...core.segments import segment_reduce
from ...core.tuples import U32_MASK, id_bits
from ..hash_priority import ops as hash_ops

MAX_COLORS = 64


def lowest_set_bit(x: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of widened uint32 words (int64), through
    the reference's float32 exponent: -127 where ``x == 0``."""
    isolated = (x & -x).to(torch.float32)        # an exact power of two
    return (isolated.view(torch.int32) >> 23).to(torch.int64) - 127


def smallest_free_color(forb_lo: torch.Tensor,
                        forb_hi: torch.Tensor) -> torch.Tensor:
    """Smallest color whose bit is clear in the 64-bit forbidden mask; -95
    (the reference's -127 + 32) where all 64 are set."""
    free_lo = ~forb_lo & U32_MASK
    free_hi = ~forb_hi & U32_MASK
    low_idx = lowest_set_bit(free_lo)
    high_idx = lowest_set_bit(free_hi) + 32
    return torch.where(free_lo != 0, low_idx, high_idx).to(torch.int32)


def color_round_rows(neighbors, mask, row_ids, colors, prio):
    """One Luby round over the rows ``row_ids`` of a ``[V]`` coloring:
    ``colors`` int32 and ``prio`` widened int64, both ``[V]``."""
    nb = neighbors.to(torch.int64)
    own = colors[row_ids]
    real = mask & (neighbors != row_ids[:, None])
    pn = prio[nb]
    contender = real & (colors[nb] < 0)
    is_min = torch.where(contender, prio[row_ids][:, None] < pn,
                         True).all(dim=1)
    # forbidden colors bitmask (two 32-bit words -> up to 64 colors)
    cn = colors[nb].to(torch.int64)
    has = real & (cn >= 0)
    lo_bits = torch.where(has & (cn < 32), 1 << cn.clamp(0, 31), 0)
    hi_bits = torch.where(has & (cn >= 32), 1 << (cn - 32).clamp(0, 31), 0)
    forb_lo = torch.zeros_like(own, dtype=torch.int64)   # ELL width may be 0
    forb_hi = torch.zeros_like(forb_lo)
    for j in range(nb.shape[1]):           # torch has no OR reduction
        forb_lo = forb_lo | lo_bits[:, j]
        forb_hi = forb_hi | hi_bits[:, j]
    chosen = smallest_free_color(forb_lo, forb_hi)
    return torch.where((own < 0) & is_min, chosen, own)


def spill_color_round(spill_rows, spill_seg, spill_cols, colors, prio):
    """One Luby round over the heavy rows of the COO spill, equal to
    :func:`color_round_rows` on the same rows: ``all(own < pn)`` over the
    contenders is ``own < segment min(pn)``, the segment holding 2**32 - 1
    where there is no contender (a packed priority never equals it: its
    low ``b`` bits are ``id + 1 <= V < 2**b - 1``), and the forbidden-color
    OR is a ``[H*64]`` one-hot ``amax`` scatter summed against distinct
    powers of two (sum == OR for distinct bits)."""
    h = spill_rows.shape[0]
    rows = spill_rows.to(torch.int64)
    cols = spill_cols.to(torch.int64)
    seg = spill_seg.to(torch.int64)
    own = colors[rows]
    cn = colors[cols].to(torch.int64)
    pn = prio[cols]
    real = cols != rows[seg]
    contender = real & (cn < 0)
    min_pn = segment_reduce(torch.where(contender, pn, U32_MASK), seg, h,
                            "amin", U32_MASK)
    is_min = prio[rows] < min_pn
    has = real & (cn >= 0)
    onehot = segment_reduce(has.to(torch.int64),
                            seg * MAX_COLORS + cn.clamp(0, MAX_COLORS - 1),
                            h * MAX_COLORS, "amax", 0).view(h, MAX_COLORS)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=colors.device)
    forb_lo = (onehot[:, :32] * weights).sum(dim=1)
    forb_hi = (onehot[:, 32:] * weights).sum(dim=1)
    chosen = smallest_free_color(forb_lo, forb_hi)
    return torch.where((own < 0) & is_min, chosen, own)


def luby_loop(v: int, dev, max_rounds: int, round_fn, trace=None):
    """The Luby round loop with the reference's do-while shape (at least
    one round, then on while a vertex is uncolored and fewer than
    ``max_rounds`` rounds ran); ``round_fn(colors, prio)`` is one round over
    every row.  Returns ``(colors int32 [V], int32 [1] rounds)``.
    ``trace`` (a list) gets each round's starting colors."""
    b = id_bits(v)
    colors = torch.full((v,), -1, dtype=torch.int32, device=dev)
    rnd_dev = torch.zeros(1, dtype=torch.int32, device=dev)
    rnd = 0
    while True:
        if rnd > 0:
            if rnd >= max_rounds:
                break
            if not bool((colors < 0).any()):    # the twin's host read a round
                break
        if trace is not None:
            trace.append(colors)
        colors = round_fn(colors, hash_ops.round_priorities(v, rnd_dev, b))
        rnd_dev += 1
        rnd += 1
    return colors, torch.tensor([rnd], dtype=torch.int32, device=dev)


def luby_fixed_point_ref(neighbors, mask, *, max_rounds: int, trace=None):
    """The Luby loop over the padded ELL ``neighbors`` (int32 ``[V, D]``)
    and ``mask`` (bool ``[V, D]``): the reference's
    ``_color_fixed_point``."""
    v = neighbors.shape[0]
    vids = torch.arange(v, dtype=torch.int32, device=neighbors.device)
    return luby_loop(v, neighbors.device, max_rounds,
                     lambda colors, prio: color_round_rows(
                         neighbors, mask, vids, colors, prio), trace)


def luby_fixed_point_hybrid_ref(slabs, spill, v: int, *, max_rounds: int,
                                trace=None):
    """The Luby loop over the hybrid layout (the reference's
    ``_color_fixed_point_hybrid``): each round runs
    :func:`color_round_rows` on every slab ``(rows [R], neighbors [R, W],
    mask [R, W])`` and :func:`spill_color_round` on the spill ``(rows [H],
    seg [E], cols [E])``, all reading the round-start colors and writing a
    fresh buffer (the slabs and the spill partition the rows), so every
    round is the monolithic round evaluated piecewise."""
    dev = spill[0].device
    rows64 = [rows.to(torch.int64) for rows, _, _ in slabs]
    spill_rows = spill[0].to(torch.int64)

    def round_fn(colors, prio):
        new = colors.clone()
        for (rows, nbrs, mask), r64 in zip(slabs, rows64):
            new[r64] = color_round_rows(nbrs, mask, rows, colors, prio)
        if spill[0].shape[0]:
            new[spill_rows] = spill_color_round(*spill, colors, prio)
        return new

    return luby_loop(v, dev, max_rounds, round_fn, trace)


def luby_fixed_point_batched_ref(neighbors, mask, row_valid, bits,
                                 rows: int, *, max_rounds: int, trace=None):
    """The batched Luby loop (the reference's ``_color_batch_impl`` over one
    bucket): ``neighbors`` / ``mask`` the bucket's block-diagonal ELL
    (``[B * rows, W]``), ``row_valid`` its real rows, ``bits`` (int32
    ``[B]``) the members' id bits; padded rows enter colored 0; each round
    :func:`color_round_rows` over every row with one batched hash-pack call
    for the priorities, the round shared by the members.  Returns
    ``(colors int32 [B * rows], done_round int32 [B], int32 [1] rounds)``,
    ``done_round[j]`` the round after which member ``j`` had every real row
    colored (-1: never).  ``trace`` (a list) gets each round's starting
    colors."""
    dev = neighbors.device
    vids = torch.arange(neighbors.shape[0], dtype=torch.int32, device=dev)
    colors = torch.where(row_valid, -1, 0).to(torch.int32)
    done = torch.full((bits.shape[0],), -1, dtype=torch.int32, device=dev)
    rnd_dev = torch.zeros(1, dtype=torch.int32, device=dev)
    rnd = 0
    while True:
        if trace is not None:
            trace.append(colors)
        prio = hash_ops.round_priorities_batched(rows, rnd_dev, bits)
        colors = color_round_rows(neighbors, mask, vids, colors, prio)
        rnd_dev += 1
        rnd += 1
        finished = ((colors >= 0) | ~row_valid).view(-1, rows).all(dim=1)
        done = torch.where((done < 0) & finished, rnd, done)
        if rnd >= max_rounds or bool(finished.all()):   # a host read a round
            break
    return colors, done, torch.tensor([rnd], dtype=torch.int32, device=dev)
