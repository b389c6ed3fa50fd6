"""The one-dispatch resident fixed point of the port, on the CPU.

``kernels.minprop_ell.ref.resident_fixed_point_ref`` (the twin of the
persistent kernel behind ``cuda_resident``) against the JAX package's
``compacted_resident`` and ``pallas_resident`` fixed point (Pallas in
interpret mode, as the reference's own tests run it here): equal T, digest,
iterations and ``converged``, at the default round cap, capped at 1, 2 and
4 rounds, and with an active subset.  The ordered compaction of a worklist
over itself, which the kernel relies on, against ``compact_worklist`` over
``[V]`` round by round.  And ``tools/check_shape_torch.py`` in-process on
the CPU: three gates pass, the ``resident`` and ``hybrid_traffic`` gates fail
(each asks for one launch and no host sync a solve: they need the card).
"""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.core.mis2 import _resident_ell_fixed_point
from repro.graphs import generators as ref_gen
from repro_torch.core.mis2 import compact_worklist
from repro_torch.core.tuples import OUT_I32, id_bits, is_undecided
from repro_torch.graphs import generators as port_gen
from repro_torch.kernels.minprop_ell import ops, ref

from _torch_common import CPU

# two random graphs of one ELL shape (1000 x 16) share the reference's
# compiled loops
GRAPHS = {
    "laplace3d(8)": ("laplace3d", (8,), {}),
    "laplace3d(12)": ("laplace3d", (12,), {}),
    "uniform(1000,6,s2)": ("random_uniform_graph", (1000, 6.0), {"seed": 2}),
    "uniform(1000,6,s3)": ("random_uniform_graph", (1000, 6.0), {"seed": 3}),
}
ENGINES = ("compacted_resident", "pallas_resident")
PRIORITY = "xorshift_star"

TOOL = Path(__file__).resolve().parents[1] / "tools" / "check_shape_torch.py"


@functools.lru_cache(maxsize=None)
def _ref_graph(name: str):
    fn, args, kw = GRAPHS[name]
    return repro.Graph(getattr(ref_gen, fn)(*args, **kw))


@functools.lru_cache(maxsize=None)
def _port_graph(name: str):
    fn, args, kw = GRAPHS[name]
    return rt.Graph(getattr(port_gen, fn)(*args, **kw), device="cpu")


def _mask(name: str, masked: bool):
    if not masked:
        return None
    v = _ref_graph(name).num_vertices
    return np.random.default_rng(v).random(v) < 0.5


@functools.lru_cache(maxsize=None)
def _reference(name: str, engine: str, max_iters: int, masked: bool):
    """The reference's T (stored int32 bits) and rounds from its jitted
    fixed point, and its facade result on the same jit cache entry."""
    g = _ref_graph(name)
    v = g.ell.num_vertices
    mask = _mask(name, masked)
    pallas = engine == "pallas_resident"
    r = repro.mis2(g, active=mask, engine=engine,
                   options=repro.Mis2Options(priority=PRIORITY,
                                             max_iters=max_iters))
    active = jnp.ones(v, dtype=bool) if mask is None else jnp.asarray(mask)
    t, it, _ = _resident_ell_fixed_point(
        g.ell.neighbors, active, priority=PRIORITY, packed=True,
        max_iters=max_iters, b=id_bits(v), use_pallas=pallas,
        interpret=True)
    return np.asarray(t).view(np.int32), int(it), r


def _twin(name: str, max_iters: int, masked: bool):
    g = _port_graph(name)
    ell = g.ell
    v = ell.num_vertices
    mask = _mask(name, masked)
    act = torch.ones(v, dtype=torch.bool) if mask is None \
        else torch.from_numpy(mask)
    t, stats = ref.resident_fixed_point_ref(
        torch.empty(v, dtype=torch.int32), torch.empty(v, dtype=torch.int32),
        act, ell.neighbors.reshape(-1), priority=PRIORITY, b=id_bits(v),
        max_iters=max_iters)
    r = rt.mis2(g, active=mask, backend=CPU,
                options=rt.Mis2Options(priority=PRIORITY,
                                       max_iters=max_iters))
    return t.numpy(), stats.tolist(), r


def _same(name: str, engine: str, max_iters: int, masked: bool) -> int:
    """Assert the twin equals the reference; returns the rounds run."""
    t_ref, it_ref, r_ref = _reference(name, engine, max_iters, masked)
    t, (it, n1), r = _twin(name, max_iters, masked)
    assert np.array_equal(t, t_ref)
    assert it == it_ref == r_ref.iterations == r.iterations
    assert (r.digest, r.converged) == (r_ref.digest, r_ref.converged)
    assert r.engine == "cuda_resident"
    assert r.converged == (n1 == 0)
    assert r.host_syncs == min(it + 1, max_iters)     # the twin's reads
    return it


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_twin_equals_the_reference(name, engine):
    _same(name, engine, 128, masked=False)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_twin_equals_the_reference_on_an_active_subset(name, engine):
    _same(name, engine, 128, masked=True)


@pytest.mark.parametrize("max_iters", [1, 2, 4])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["uniform(1000,6,s2)", "uniform(1000,6,s3)"])
def test_twin_equals_the_reference_capped(name, engine, max_iters):
    assert _same(name, engine, max_iters, masked=False) == max_iters


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_compaction_over_the_previous_list_is_compact_worklist(name, masked):
    """Round by round, each list compacted over itself (in order, the
    sentinel past its count) equals ``compact_worklist`` over ``[V]``: the
    undecided rows lie in the last undecided list, the rows whose M is not
    OUT in the last M list."""
    ell = _port_graph(name).ell
    v = ell.num_vertices
    mask = _mask(name, masked)
    act = torch.ones(v, dtype=torch.bool) if mask is None \
        else torch.from_numpy(mask)
    nbrs = ell.neighbors.reshape(-1)
    t = torch.where(act, 1, OUT_I32).to(torch.int32)
    m = torch.full((v,), OUT_I32, dtype=torch.int32)
    every = torch.arange(v, dtype=torch.int32)
    wl1, n1 = ref.compact_over_ref(every, v, act)
    want1, c1 = compact_worklist(act)
    assert torch.equal(wl1, want1) and n1 == int(c1)
    wl2, n2 = every, v
    kw = dict(priority=PRIORITY, b=id_bits(v))
    rounds = 0
    while n1:
        it = torch.tensor([rounds], dtype=torch.int32)
        ref.fused_refresh_columns_ref(t, m, nbrs, wl2,
                                      torch.tensor([n2], dtype=torch.int32),
                                      it, **kw)
        ref.fused_decide_ref(t, m, act, nbrs, wl1,
                             torch.tensor([n1], dtype=torch.int32), it, **kw)
        for prev, n, keep, lst in ((wl1, n1, is_undecided(t), 1),
                                   (wl2, n2, m != OUT_I32, 2)):
            assert not (keep & ~compact_worklist_mask(prev, n, v)).any()
            got, count = ref.compact_over_ref(prev, n, keep)
            want, want_count = compact_worklist(keep)
            assert torch.equal(got, want) and count == int(want_count)
            if lst == 1:
                wl1, n1 = got, count
            else:
                wl2, n2 = got, count
        rounds += 1
    assert rounds > 1


def compact_worklist_mask(wl: torch.Tensor, n: int, v: int) -> torch.Tensor:
    """The ``[V]`` mask of the rows in ``wl[:n]``."""
    mask = torch.zeros(v, dtype=torch.bool)
    mask[wl[:n].to(torch.int64)] = True
    return mask


def test_wrapper_checks_its_arguments():
    ell = _port_graph("laplace3d(8)").ell
    v = ell.num_vertices
    t, m = torch.empty(v, dtype=torch.int32), torch.empty(v, dtype=torch.int32)
    act = torch.ones(v, dtype=torch.bool)
    nbrs = ell.neighbors.reshape(-1)
    with pytest.raises(ValueError, match="negative"):
        ops.resident_fixed_point(t, m, act, nbrs, priority=PRIORITY, b=10,
                                 max_iters=-1)
    with pytest.raises(TypeError):
        ops.resident_fixed_point(t, m, act.to(torch.uint8), nbrs,
                                 priority=PRIORITY, b=10, max_iters=4)
    with pytest.raises(ValueError, match="rows"):
        ops.resident_fixed_point(t, m[:-1], act, nbrs, priority=PRIORITY,
                                 b=10, max_iters=4)
    before = ops.LAUNCHES["resident_fixed_point"]
    _, stats = ops.resident_fixed_point(t, m, act, nbrs, priority=PRIORITY,
                                        b=id_bits(v), max_iters=128)
    assert ops.LAUNCHES["resident_fixed_point"] == before   # a twin call
    assert stats.tolist() == [6, 0]


# ---------------------------------------------------------------------------
# tools/check_shape_torch.py in-process
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tool():
    spec = importlib.util.spec_from_file_location("check_shape_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("gate", ["serve", "serve_dedup", "dist"])
def test_gate_passes_on_the_cpu(gate, capsys):
    assert _tool().main(["--device", "cpu", "--gates", gate]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"PASS  {gate} ")


@pytest.mark.parametrize("gate", ["resident", "hybrid_traffic"])
def test_resident_gate_fails_on_the_cpu(gate, capsys):
    assert _tool().main(["--device", "cpu", "--gates", gate]) == 1
    out = capsys.readouterr().out
    assert out.startswith(f"FAIL  {gate} ")
    assert "needs the card" in out
