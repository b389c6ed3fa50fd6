"""The host-driven MIS-2 engines (``compacted``, ``cuda_compacted``), the
plain resident variants (``compacted_resident``) and the Fig. 2 ablation
chain of the port against the JAX package on the CPU, where the twins of
the ``refresh_columns`` / ``decide`` kernels stand in.  The kernels are
held against the twins in ``test_torch_cuda.py``."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.core.mis2 import ABLATION_CHAIN as REF_CHAIN
from repro.graphs import csr as ref_csr
from repro.graphs import generators as ref_gen
from repro.kernels.minprop_ell import kernel as ref_kernel
from repro.kernels.minprop_ell import ops as ref_ops
from repro.kernels.minprop_ell import ref as ref_oracle
from repro_torch.api.backend import default_mis2_engine
from repro_torch.graphs import hybrid
from repro_torch.kernels.minprop_ell import ops, ref

from _torch_common import (
    CPU,
    active_mask,
    port_graph,
    ref_ablation,
    ref_coarsen,
    ref_graph,
    ref_mis2,
)

PRIORITIES = ["xorshift_star", "xorshift", "fixed"]
OUT = np.uint32(0xFFFFFFFF)

#: (chain entry, engine) pairs the engine accepts
CASES = ([(e, "compacted") for e in REF_CHAIN]
         + [(e, "compacted_resident") for e, o in REF_CHAIN.items()
            if o.worklists]
         + [(e, "cuda_compacted") for e, o in REF_CHAIN.items()
            if o.packed and o.layout == "ell"])


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# the twins of kernels 5-6 against the reference's kernels and oracles
# ---------------------------------------------------------------------------

def _rows_inputs(v: int, deg: float, seed: int, count_frac: float):
    """Pre-gathered rows of a pow2-padded worklist (sentinel slots gather
    row V-1, as the drivers' clamp does), random T / M / active.  The
    worklist holds ``max(1, min(V, V * count_frac))`` rows; the count
    passed is ``V * count_frac``: 0, or past the worklist's end at 2.0."""
    ell = ref_csr.csr_to_ell_graph(ref_gen.random_uniform_graph(v, deg,
                                                                seed=seed))
    nbrs = np.array(ell.neighbors)
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 2**32 - 1, size=v, dtype=np.uint32)
    t[rng.random(v) < 0.1] = 0
    t[rng.random(v) < 0.1] = OUT
    m = rng.integers(0, 2**32, size=v, dtype=np.uint32)
    m[rng.random(v) < 0.2] = OUT
    active = rng.random(v) < 0.9
    count = int(v * count_frac)
    live = max(1, min(v, count))
    w = 1 << (live - 1).bit_length()
    wl = np.full(w, v, dtype=np.int32)
    wl[:live] = rng.permutation(v)[:live]
    rows = np.clip(wl, 0, v - 1)
    return nbrs[rows], t, m, active, rows, count


@pytest.mark.parametrize("v,deg,seed,count_frac", [(257, 4.0, 0, 0.1),
                                                   (1024, 8.0, 1, 1.0),
                                                   (300, 6.0, 3, 0.0),
                                                   (300, 6.0, 3, 2.0)])
def test_refresh_columns_twin_matches_reference_oracle(v, deg, seed,
                                                       count_frac):
    wl_nbrs, t, _, _, _, count = _rows_inputs(v, deg, seed, count_frac)
    want = ref_oracle.refresh_columns_ref(jnp.asarray(t),
                                          jnp.asarray(wl_nbrs), count)
    got = ops.refresh_columns_rows(_i32(t), torch.from_numpy(wl_nbrs), count)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("v,deg,seed,count_frac", [(333, 12.0, 2, 0.5),
                                                   (1024, 8.0, 1, 1.0),
                                                   (300, 6.0, 3, 0.0),
                                                   (300, 6.0, 3, 2.0)])
def test_decide_twin_matches_reference_oracle(v, deg, seed, count_frac):
    wl_nbrs, t, m, active, rows, count = _rows_inputs(v, deg, seed,
                                                      count_frac)
    want = ref_oracle.decide_ref(jnp.asarray(t[rows]), jnp.asarray(m),
                                 jnp.asarray(active), jnp.asarray(wl_nbrs),
                                 count)
    got = ops.decide_rows(_i32(t[rows]), _i32(m), torch.from_numpy(active),
                          torch.from_numpy(wl_nbrs), count)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("v,deg,seed", [(1024, 8.0, 1)])
def test_twins_match_pallas_kernels_on_the_live_region(v, deg, seed):
    """The Pallas kernels (interpret mode) differ from the oracles only at
    slots past ``count`` inside a live block."""
    wl_nbrs, t, m, active, rows, count = _rows_inputs(v, deg, seed, 0.3)
    cnt = jnp.asarray(count, jnp.int32)
    k_ref = ref_kernel.refresh_columns_pallas(jnp.asarray(t),
                                              jnp.asarray(wl_nbrs), cnt)
    k_dec = ref_kernel.decide_pallas(jnp.asarray(t[rows]), jnp.asarray(m),
                                     jnp.asarray(active),
                                     jnp.asarray(wl_nbrs), cnt)
    got_ref = ref.refresh_columns_ref(_i32(t), torch.from_numpy(wl_nbrs),
                                      count)
    got_dec = ref.decide_ref(_i32(t[rows]), _i32(m), torch.from_numpy(active),
                             torch.from_numpy(wl_nbrs), count)
    np.testing.assert_array_equal(_u32(got_ref)[:count],
                                  np.asarray(k_ref)[:count])
    np.testing.assert_array_equal(_u32(got_dec)[:count],
                                  np.asarray(k_dec)[:count])


def test_round_wrappers_scatter_into_the_worklist_rows_only():
    """``ops.refresh_columns`` / ``ops.decide``: rows gathered, twin, drop-
    scatter; equal to the reference's XLA steps of the same round."""
    from repro.core.mis2 import _decide_packed_ell, _refresh_cols_packed_ell

    wl_nbrs, t, m, active, rows, count = _rows_inputs(512, 6.0, 5, 0.6)
    nbrs = np.array(ref_csr.csr_to_ell_graph(
        ref_gen.random_uniform_graph(512, 6.0, seed=5)).neighbors)
    wl = np.where(np.arange(len(rows)) < count, rows, 512).astype(np.int32)
    got_m = ops.refresh_columns(_i32(t), _i32(m), torch.from_numpy(wl),
                                torch.from_numpy(nbrs), count)
    want_m = _refresh_cols_packed_ell(
        jnp.asarray(t), jnp.asarray(m), jnp.asarray(wl), jnp.asarray(nbrs))
    np.testing.assert_array_equal(_u32(got_m), np.asarray(want_m))
    got_t = ops.decide(_i32(t), got_m, torch.from_numpy(wl),
                       torch.from_numpy(nbrs), torch.from_numpy(active), count)
    want_t = _decide_packed_ell(
        jnp.asarray(t), want_m, jnp.asarray(wl), jnp.asarray(nbrs),
        jnp.asarray(active))
    np.testing.assert_array_equal(_u32(got_t), np.asarray(want_t))


def test_row_wrappers_validate_their_inputs():
    t = torch.zeros(8, dtype=torch.int32)
    rows = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ops.refresh_columns_rows(t, rows.to(torch.int64), 4)
    with pytest.raises(ValueError, match="shape"):
        ops.refresh_columns_rows(t, rows.reshape(-1), 4)
    with pytest.raises(ValueError, match="negative"):
        ops.refresh_columns_rows(t, rows, -1)
    with pytest.raises(ValueError, match="t_rows"):
        ops.decide_rows(t, t, torch.ones(8, dtype=torch.bool), rows, 4)


# ---------------------------------------------------------------------------
# the engines against the reference's host-driven driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("priority,active_seed", [
    *((p, None) for p in PRIORITIES), ("xorshift_star", 3)])
@pytest.mark.parametrize("entry,engine", CASES)
def test_ablation_engines_match_reference(entry, engine, priority,
                                          active_seed):
    opts = dataclasses.replace(rt.ABLATION_CHAIN[entry], priority=priority)
    r = rt.mis2(port_graph("laplace3d(8)"), engine=engine, options=opts,
                active=active_mask("laplace3d(8)", active_seed), backend=CPU)
    want, want_syncs = ref_ablation("laplace3d(8)", entry, priority,
                                    active_seed)
    assert (r.digest, r.size, r.iterations, r.converged) == (
        want.digest, want.size, want.iterations, want.converged)
    if engine == "compacted_resident":
        assert r.num_compiles == 1
        assert r.host_syncs == r.iterations + 1
    else:
        assert r.num_compiles == want.num_compiles
        assert r.host_syncs == want_syncs == 2 * r.iterations


@pytest.mark.parametrize("entry", [e for e, o in REF_CHAIN.items()
                                   if o.worklists])
def test_compacted_resident_matches_reference_resident(entry):
    r = rt.mis2(port_graph("laplace3d(8)"), engine="compacted_resident",
                options=rt.ABLATION_CHAIN[entry], backend=CPU)
    want, _ = ref_ablation("laplace3d(8)", entry,
                           engine="compacted_resident")
    assert (r.digest, r.iterations, r.converged, r.num_compiles) == (
        want.digest, want.iterations, want.converged, want.num_compiles)


@pytest.mark.parametrize("name,priority", [
    *(("laplace3d(8)", p) for p in PRIORITIES),
    ("laplace3d(12)", "xorshift_star")])
def test_cuda_compacted_without_worklists_matches_reference_compacted(
        name, priority):
    """The reference's ``pallas`` engine gives a wrong set here (it passes
    the shrinking worklist length as the count of the reused round-0
    buffers); the port passes the buffer's own count."""
    opts = rt.Mis2Options(priority=priority, worklists=False)
    r = rt.mis2(port_graph(name), engine="cuda_compacted", options=opts,
                backend=CPU)
    want, want_syncs = ref_ablation(name, "+simd_ell", priority,
                                    worklists=False)
    assert (r.digest, r.iterations, r.converged, r.num_compiles) == (
        want.digest, want.iterations, want.converged, want.num_compiles)
    assert r.host_syncs == want_syncs
    assert r.digest == ref_mis2(name, priority).digest


def _with_isolated_vertex():
    g = ref_gen.random_uniform_graph(300, 5.0, seed=11)
    indptr = np.append(np.asarray(g.indptr), np.asarray(g.indptr)[-1])
    return np.asarray(indptr, np.int32), np.asarray(g.indices, np.int32)


@pytest.mark.parametrize("engine", ["compacted", "compacted_resident"])
@pytest.mark.parametrize("packed", [False, True])
def test_csr_segment_isolated_vertex_takes_segment_identities(packed, engine):
    indptr, indices = _with_isolated_vertex()
    opts = rt.Mis2Options(packed=packed, layout="csr_segment")
    r = rt.mis2(rt.Graph.from_reference(indptr, indices, device="cpu"),
                engine=engine, options=opts, backend=CPU)
    want = repro.mis2(repro.Graph(ref_csr.CSRGraph(indptr, indices)),
                      engine="compacted",
                      options=repro.Mis2Options(packed=packed,
                                                layout="csr_segment"))
    assert (r.digest, r.iterations, r.converged) == (
        want.digest, want.iterations, want.converged)
    assert r.in_set[-1]          # alone, it joins the set


def test_csr_edges_equal_reference_arrays():
    g = port_graph("elasticity3d(4)")
    rows, cols = g.csr_edges
    want_rows, want_cols = ref_graph("elasticity3d(4)").csr_edges
    assert rows.dtype == cols.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want_cols))
    assert g.csr_edges is g.csr_edges and g.conversions["csr_edges"] == 1


# ---------------------------------------------------------------------------
# the engine=None rule, the option gates, coarsening
# ---------------------------------------------------------------------------

WANT_ENGINE = {"baseline_bell": "compacted", "+rand_priority": "compacted",
               "+worklists": "compacted_resident",
               "+packed_status": "compacted_resident",
               "+simd_ell": "cuda_resident"}


@pytest.mark.parametrize("lowered", [False, True])
def test_default_engine_for_each_chain_entry(monkeypatch, lowered):
    g = port_graph("laplace3d(8)")
    if lowered:
        monkeypatch.setattr(hybrid, "HYBRID_AUTO_BYTES", 1)
    for entry, opts in rt.ABLATION_CHAIN.items():
        want = WANT_ENGINE[entry]
        if lowered and want == "cuda_resident":
            want = "cuda_hybrid"
        assert default_mis2_engine(g, opts) == want
        assert rt.mis2(g, options=opts, backend=CPU).engine == want
    unpacked_ell = rt.Mis2Options(packed=False, worklists=False)
    assert default_mis2_engine(g, rt.Mis2Options(worklists=False)) \
        == "cuda_compacted"
    assert default_mis2_engine(g, unpacked_ell) == "compacted"
    assert default_mis2_engine(g) == ("cuda_hybrid" if lowered
                                      else "cuda_resident")


@pytest.mark.parametrize("engine,opts,match", [
    ("cuda_resident", dict(worklists=False), "worklist compaction"),
    ("cuda_resident", dict(packed=False), "packed tuples"),
    ("cuda_resident", dict(layout="csr_segment"), "packed tuples"),
    ("cuda_hybrid", dict(worklists=False), "worklist compaction"),
    ("cuda_hybrid", dict(layout="csr_segment"), "packed tuples"),
    ("compacted_resident", dict(worklists=False), "'compacted' driver"),
    ("cuda_compacted", dict(packed=False), "packed tuples"),
    ("cuda_compacted", dict(layout="csr_segment"), "ELL layout"),
])
def test_option_gates_raise(engine, opts, match):
    with pytest.raises(ValueError, match=match):
        rt.mis2(port_graph("laplace3d(8)"), engine=engine,
                options=rt.Mis2Options(**opts), backend=CPU)


def test_bad_layout_and_engine_list():
    with pytest.raises(ValueError, match="layout"):
        rt.Mis2Options(layout="coo")
    with pytest.raises(ValueError, match="cuda_compacted"):
        rt.mis2(port_graph("laplace3d(8)"), engine="pallas_dense",
                backend=CPU)
    assert set(rt.ABLATION_CHAIN) == set(REF_CHAIN)
    assert all(rt.ABLATION_CHAIN[k].__dict__ == {
        f: getattr(o, f) for f in rt.ABLATION_CHAIN[k].__dict__}
        for k, o in REF_CHAIN.items())


@pytest.mark.parametrize("engine", ["compacted", "cuda_compacted",
                                    "compacted_resident"])
def test_coarsen_with_the_new_engines_matches_reference(engine):
    a = rt.coarsen(port_graph("laplace3d(8)"), method="two_phase",
                   mis2_engine=engine, backend=CPU)
    want = ref_coarsen("laplace3d(8)", "two_phase")
    assert (a.digest, a.num_aggregates, a.iterations) == (
        want.digest, want.num_aggregates, want.iterations)
    assert a.engine == engine


def test_coarsen_takes_the_ablated_options_engine():
    opts = rt.ABLATION_CHAIN["baseline_bell"]
    a = rt.coarsen(port_graph("laplace3d(8)"), method="two_phase",
                   options=opts, backend=CPU)
    want = repro.coarsen(ref_graph("laplace3d(8)"), method="two_phase",
                         options=REF_CHAIN["baseline_bell"],
                         mis2_engine="compacted")
    assert a.engine == "compacted"
    assert (a.digest, a.num_aggregates, a.iterations) == (
        want.digest, want.num_aggregates, want.iterations)


@pytest.mark.parametrize("engine,ref_engine", [
    ("cuda_compacted", "pallas"), ("cuda_resident", "pallas_resident"),
    ("cuda_hybrid", "pallas_hybrid")])
def test_ell_row_movements_match_reference(engine, ref_engine):
    assert ops.ELL_ROW_TRAFFIC[engine] == ref_ops.ELL_ROW_TRAFFIC[ref_engine]
    assert ops.ell_row_movements(engine) == \
        ref_ops.ell_row_movements(ref_engine)
