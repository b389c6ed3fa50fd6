"""The one-dispatch hybrid MIS-2 fixed point of the port, on the CPU.

``kernels.minprop_ell.ref.hybrid_fixed_point_ref`` (the twin of the
persistent kernel behind ``cuda_hybrid``) against the JAX package's jitted
``_hybrid_fixed_point`` (its Pallas kernels in interpret mode, as the
reference's own tests run them here): equal T, rounds, live count and
``slice_rows_processed``, exactly (all integers), for each priority, with
and without an active mask, capped at 1, 2 and 4 rounds, on the small
graphs of ``tests/_torch_common.py`` (laplace3d(8), ER(600),
``powerlaw_graph(900, 8, seed=4)``, whose 7 heavy rows go through the
spill).  Each slab's two worklists, compacted over themselves, against
``compact_worklist`` over the slab's rows round by round.  The wrapper's
argument checks.  The kernel itself is held against the twin on the card
in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mis2_hybrid import _hybrid_fixed_point
from repro_torch.core.mis2 import compact_worklist
from repro_torch.core.tuples import OUT_I32, id_bits, is_undecided
from repro_torch.kernels.minprop_ell import ops, ref

from _torch_common import hybrid_active, port_hybrid_graph, ref_hybrid_graph

GRAPHS = ("laplace3d", "er_random", "powerlaw")


def _layouts(name: str):
    hyb = port_hybrid_graph(name).hybrid()
    slabs = [(sl.rows, sl.neighbors.reshape(-1)) for sl in hyb.slices]
    return hyb, slabs, (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols)


@functools.lru_cache(maxsize=None)
def _reference(name: str, priority: str, masked: bool, max_iters: int):
    """The reference's T (stored int32 bits), rounds, live count and slab
    rows processed from its jitted fixed point."""
    g = ref_hybrid_graph(name)
    h = g.hybrid()
    v = g.num_vertices
    mask = hybrid_active(name, "random" if masked else None)
    active = jnp.ones(v, dtype=bool) if mask is None else jnp.asarray(mask)
    t, it, n1, acc = _hybrid_fixed_point(
        h.slices, h.spill_rows, h.spill_seg, h.spill_cols, active,
        priority=priority, max_iters=max_iters, b=id_bits(v), interpret=True)
    return (np.asarray(t).view(np.int32), int(it), int(n1),
            np.asarray(acc)[:len(h.slices)].tolist())


def _twin(name: str, priority: str, masked: bool, max_iters: int,
          trace=None):
    hyb, slabs, spill = _layouts(name)
    v = hyb.num_vertices
    mask = hybrid_active(name, "random" if masked else None)
    act = None if mask is None else torch.from_numpy(mask)
    t, stats, acc = ref.hybrid_fixed_point_ref(
        torch.empty(v, dtype=torch.int32), torch.empty(v, dtype=torch.int32),
        act, slabs, spill, priority=priority, b=id_bits(v),
        max_iters=max_iters, trace=trace)
    return t.numpy(), *stats.tolist(), acc.tolist()


def _same(name: str, priority: str, masked: bool, max_iters: int) -> int:
    """Assert the twin equals the reference exactly; returns the rounds."""
    t_ref, it_ref, n1_ref, acc_ref = _reference(name, priority, masked,
                                                max_iters)
    t, it, n1, acc = _twin(name, priority, masked, max_iters)
    assert np.array_equal(t, t_ref)
    assert (it, n1, acc) == (it_ref, n1_ref, acc_ref)
    return it


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", GRAPHS)
def test_twin_equals_the_reference(name, masked):
    assert _same(name, "xorshift_star", masked, 128) > 1


@pytest.mark.parametrize("priority", ["xorshift", "fixed"])
def test_twin_equals_the_reference_for_each_priority(priority):
    _same("powerlaw", priority, False, 128)


@pytest.mark.parametrize("name,masked,max_iters", [
    ("powerlaw", False, 1), ("powerlaw", False, 2),
    ("laplace3d", True, 1), ("laplace3d", True, 2), ("laplace3d", True, 4)])
def test_twin_equals_the_reference_capped(name, masked, max_iters):
    assert _same(name, "xorshift_star", masked, max_iters) == max_iters


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["er_random", "powerlaw"])
def test_slab_lists_are_compact_worklist_every_round(name, masked):
    """Round k's lists (each compacted over its previous list, sentinel R)
    equal ``compact_worklist`` over the slab's rows of the state after k
    rounds: the rows whose M is not OUT (every row at round 0) and the
    undecided ones; its heavy-row masks are the same two sets over the
    spill's rows."""
    hyb, slabs, spill = _layouts(name)
    v = hyb.num_vertices
    trace = []
    rounds = _twin(name, "xorshift_star", masked, 128, trace)[1]
    assert rounds == len(trace) > 1
    heavy = spill[0].to(torch.int64)
    for k, (lists, heavy_live, heavy_und) in enumerate(trace):
        t, m = (torch.from_numpy(x) for x in _state_after(name, masked, k))
        live = m != OUT_I32 if k else torch.ones(v, dtype=torch.bool)
        und = is_undecided(t)
        assert torch.equal(heavy_live, live[heavy])
        assert torch.equal(heavy_und, und[heavy])
        for (rows, _), ((wl2, n2), (wl1, n1)) in zip(slabs, lists):
            r64 = rows.to(torch.int64)
            for (wl, n), keep in (((wl2, n2), live[r64]),
                                  ((wl1, n1), und[r64])):
                want, count = compact_worklist(keep)
                assert torch.equal(wl, want) and n == int(count)


def _state_after(name: str, masked: bool, rounds: int):
    """T and M of the twin after ``rounds`` rounds."""
    hyb, slabs, spill = _layouts(name)
    v = hyb.num_vertices
    mask = hybrid_active(name, "random" if masked else None)
    t = torch.empty(v, dtype=torch.int32)
    m = torch.empty(v, dtype=torch.int32)
    ref.hybrid_fixed_point_ref(
        t, m, None if mask is None else torch.from_numpy(mask), slabs, spill,
        priority="xorshift_star", b=id_bits(v), max_iters=rounds)
    return t.numpy(), m.numpy()


def test_wrapper_checks_its_arguments():
    hyb, slabs, spill = _layouts("powerlaw")
    v = hyb.num_vertices
    t = torch.empty(v, dtype=torch.int32)
    m = torch.empty(v, dtype=torch.int32)
    kw = dict(priority="xorshift_star", b=id_bits(v), max_iters=8)
    with pytest.raises(ValueError, match="negative"):
        ops.hybrid_fixed_point(t, m, None, slabs, spill,
                               **{**kw, "max_iters": -1})
    with pytest.raises(TypeError, match="active"):
        ops.hybrid_fixed_point(t, m, torch.ones(v, dtype=torch.uint8), slabs,
                               spill, **kw)
    with pytest.raises(ValueError, match="rows"):
        ops.hybrid_fixed_point(t, m[:-1], None, slabs, spill, **kw)
    with pytest.raises(ValueError, match="whole number"):
        ops.hybrid_fixed_point(t, m, None, [(slabs[1][0], slabs[1][1][1:])],
                               spill, **kw)
    with pytest.raises(ValueError, match="differ in length"):
        ops.hybrid_fixed_point(t, m, None, slabs,
                               (spill[0], spill[1][1:], spill[2]), **kw)
    with pytest.raises(ValueError, match="unknown priority"):
        ops.hybrid_fixed_point(t, m, None, slabs, spill,
                               **{**kw, "priority": "nope"})
    before = ops.LAUNCHES["hybrid_fixed_point"]
    _, stats, acc = ops.hybrid_fixed_point(t, m, None, slabs, spill, **kw)
    assert ops.LAUNCHES["hybrid_fixed_point"] == before   # a twin call
    assert stats.tolist() == [4, 0] and acc.dtype == torch.int64
