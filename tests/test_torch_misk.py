"""The port's distance-k MIS (``rt.misk``, engines ``dense`` and
``resident``) and the MIS-2 helpers of the batched and streaming modes
(``mis2_dense_jittable``, the warm-started repair loop, the lex-first check)
against the JAX package's, on the CPU: equal digests, rounds and flags."""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.graphs.csr import CSRGraph as RefCSRGraph
from repro_torch.core import mis2 as port_mis2
from repro_torch.core.tuples import id_bits, widen

from _torch_common import CPU, GRAPHS, port_graph, ref_graph, ref_misk

# the module (``repro.core`` exports a function of its name)
ref_mis2 = importlib.import_module("repro.core.mis2")


@pytest.mark.parametrize("engine", ["dense", "resident"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_misk_matches_reference(name, k, engine):
    ref = ref_misk(name, k, engine)
    r = rt.misk(port_graph(name), k=k, engine=engine, backend=CPU)
    assert (r.digest, r.size, r.iterations, r.converged) == (
        ref.digest, ref.size, ref.iterations, ref.converged)
    assert r.engine == ref.engine == f"misk{k}_{engine}"
    assert r.num_compiles == (1 if engine == "resident" else None)
    assert r.host_syncs == r.iterations + 1      # one live read a round


@pytest.mark.parametrize("priority", ["fixed", "xorshift"])
def test_misk_priorities_match_reference(priority):
    ref = ref_misk("laplace3d(8)", 2, "dense", priority)
    for engine in ("dense", "resident"):
        r = rt.misk(port_graph("laplace3d(8)"), k=2, priority=priority,
                    engine=engine, backend=CPU)
        assert (r.digest, r.iterations, r.converged) == (
            ref.digest, ref.iterations, ref.converged)


@pytest.mark.parametrize("engine", ["dense", "resident"])
def test_misk_capped_rounds_match_reference(engine):
    ref = ref_misk("laplace3d(12)", 3, engine, max_iters=2)
    r = rt.misk(port_graph("laplace3d(12)"), k=3, max_iters=2, engine=engine,
                backend=CPU)
    assert not ref.converged
    assert (r.digest, r.iterations, r.converged) == (
        ref.digest, ref.iterations, ref.converged)
    assert r.host_syncs == 2


def test_misk_default_engine_and_bad_arguments():
    g = port_graph("laplace3d(8)")
    r = rt.misk(g, backend=CPU)
    assert r.engine == "misk2_dense"
    assert r.digest == ref_misk("laplace3d(8)", 2, "dense").digest
    with pytest.raises(ValueError, match="k >= 1"):
        rt.misk(g, k=0, backend=CPU)
    with pytest.raises(ValueError, match="k >= 1"):
        repro.misk(ref_graph("laplace3d(8)"), k=0)


def test_misk_on_a_graph_without_entries_raises_as_the_reference():
    with pytest.raises(ValueError):
        repro.misk(repro.Graph(RefCSRGraph(jnp.zeros(6, jnp.int32),
                                           jnp.zeros(0, jnp.int32))))
    empty = rt.Graph(rt.graphs.CSRGraph(np.zeros(6, np.int32),
                                        np.zeros(0, np.int32)), device="cpu")
    for engine in ("dense", "resident"):
        with pytest.raises(ValueError, match="no entries"):
            rt.misk(empty, engine=engine, backend=CPU)


# -- the MIS-2 helpers ---------------------------------------------------------

def _neighbors(name: str):
    return ref_graph(name).ell.neighbors, port_graph(name).ell.neighbors


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_mis2_dense_jittable_matches_reference(name):
    ref_nb, nb = _neighbors(name)
    active = np.random.default_rng(4).random(nb.shape[0]) < 0.8
    t_ref, it_ref = ref_mis2.mis2_dense_jittable(ref_nb, jnp.asarray(active))
    t, it, syncs = port_mis2.mis2_dense_jittable(nb, torch.from_numpy(active))
    np.testing.assert_array_equal(_u32(t), np.asarray(t_ref))
    assert it == int(it_ref) and syncs == it + 1


def _fixed_solution(name: str):
    """The from-scratch fixed-priority fixed point of both packages."""
    ref_nb, nb = _neighbors(name)
    v = nb.shape[0]
    t_ref, it_ref = ref_mis2.mis2_repair_fixed_point(
        ref_nb, jnp.ones(v, jnp.uint32), jnp.uint32(id_bits(v)))
    t, it, _ = port_mis2.mis2_repair_fixed_point(
        nb, torch.ones(v, dtype=torch.int64), id_bits(v))
    return np.asarray(t_ref), int(it_ref), t, it


@pytest.mark.parametrize("name", list(GRAPHS))
def test_repair_from_scratch_matches_reference(name):
    t_ref, it_ref, t, it = _fixed_solution(name)
    np.testing.assert_array_equal(_u32(t), t_ref)
    assert it == it_ref


@pytest.mark.parametrize("frac", [0.05, 0.3])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_warm_started_repair_matches_reference(name, frac):
    """Freeze the solution, reactivate a random region (the undecided seed
    1 there), and repair: the same T and live-round count."""
    ref_nb, nb = _neighbors(name)
    t_ref0, _, _, _ = _fixed_solution(name)
    v = nb.shape[0]
    region = np.random.default_rng(11).random(v) < frac
    t_init = np.where(region, np.uint32(1), t_ref0).astype(np.uint32)
    t_ref, it_ref = ref_mis2.mis2_repair_fixed_point(
        ref_nb, jnp.asarray(t_init), jnp.uint32(id_bits(v)))
    # the stored int32 form, as a resident loop holds it
    t, it, _ = port_mis2.mis2_repair_fixed_point(
        nb, torch.from_numpy(t_init.view(np.int32)), id_bits(v))
    np.testing.assert_array_equal(_u32(t), np.asarray(t_ref))
    assert it == int(it_ref)


@pytest.mark.parametrize("flip", [0.0, 0.05])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_lexfirst_violations_match_reference(name, flip):
    ref_nb, nb = _neighbors(name)
    t_ref0, _, _, _ = _fixed_solution(name)
    v = nb.shape[0]
    in_set = t_ref0 == 0
    in_set ^= np.random.default_rng(2).random(v) < flip
    p_ref = ref_mis2.fixed_packed_priorities(v)
    p = port_mis2.fixed_packed_priorities(v, device="cpu")
    np.testing.assert_array_equal(_u32(p), np.asarray(p_ref))
    bad_ref = np.asarray(ref_mis2.lexfirst_violations(
        ref_nb, jnp.asarray(in_set), p_ref))
    bad = port_mis2.lexfirst_violations(nb, torch.from_numpy(in_set), p)
    np.testing.assert_array_equal(bad.numpy(), bad_ref)
    assert bad.any().item() == (flip > 0)


def test_repair_accepts_both_word_forms():
    _, nb = _neighbors("laplace3d(8)")
    v = nb.shape[0]
    seed = torch.ones(v, dtype=torch.int64)
    wide, _, _ = port_mis2.mis2_repair_fixed_point(nb, seed, id_bits(v))
    stored, _, _ = port_mis2.mis2_repair_fixed_point(
        nb, seed.to(torch.int32), id_bits(v))
    assert torch.equal(wide, stored)
    assert torch.equal(widen(wide.to(torch.int32)), wide)
