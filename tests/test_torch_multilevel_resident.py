"""The port's ``resident`` multilevel engine (the per-level setup on the
graph's device) against the JAX package's ``host`` engine, bit for bit:
AMG level sizes, per-level ``A_l`` digests, P, R and diagonals; the device
prolongator against scipy's; the device Galerkin stages against the host
product and the reference's sorted device stages (run here in float64
with ``jax.enable_x64``); the coarse graph, the cluster labels, colors and
packed rows; and the ELL-built ``Graph`` each coarse level is."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.multilevel.galerkin import (
    _coo_rows_repack_device as ref_repack,
    _spgemm_stage1_device as ref_stage1,
    _spgemm_stage2_device as ref_stage2,
)
from repro.multilevel.prolongator import smoothed_prolongator_host
from repro_torch.api.backend import default_multilevel_engine
from repro_torch.graphs import handle
from repro_torch.graphs.csr import ELLMatrix, csr_from_coo, csr_to_ell_arrays
from repro_torch.graphs.ops import coarse_graph_from_labels
from repro_torch.multilevel import galerkin as gal
from repro_torch.multilevel.packing import (
    pack_clusters_device,
    pack_clusters_host,
)
from repro_torch.multilevel.prolongator import (
    _prolongator_device,
    _prolongator_pack_device,
)

from _torch_common import CPU, port_graph, ref_amg, ref_graph, ref_level_arrays

# the reference's host engine on laplace3d(16) (JAX on CPU), as in
# tests/test_torch_multilevel.py
L16_LEVELS = [(4096, 27136), (625, 17567), (27, 649)]
L16_DIGESTS = ["3079f70aeafb3316", "3b559532b398e5fc", "a8c5c06f3d2de1da"]

# graph -> coarse_size giving it more than one level
CASES = {"laplace3d(8)": 200, "elasticity3d(4)": 20}


def _resident(name: str, explicit: bool = True, coarse_size: int = 200):
    return rt.amg_setup(port_graph(name), engine="resident", backend=CPU,
                        coarse_dtype="float32", coarse_size=coarse_size,
                        explicit_restriction=explicit)


@pytest.mark.parametrize("explicit", [True, False],
                         ids=["R", "matrix_free"])
@pytest.mark.parametrize("name", list(CASES))
def test_resident_amg_equals_reference_host(name, explicit):
    want = ref_amg(name, coarse_size=CASES[name])
    got = _resident(name, explicit, CASES[name])
    assert got.engine == "resident" and got.num_levels > 1
    assert got.level_sizes == want.level_sizes
    assert got.level_digests == want.level_digests
    assert got.dispatches == 7 * (got.num_levels - 1)
    levels = got.hierarchy.levels
    for lvl, nxt, ref in zip(levels, levels[1:] + [None],
                             ref_level_arrays(want)):
        np.testing.assert_array_equal(lvl.diag.numpy(), ref["diag"])
        if nxt is None:
            assert lvl.p_ell is None and lvl.r_ell is None
            continue
        for x, y in zip(lvl.p_ell, ref["p"]):
            np.testing.assert_array_equal(x.numpy(), y)
        if explicit:
            for x, y in zip(lvl.r_ell, ref["r"]):
                np.testing.assert_array_equal(x.numpy(), y)
        else:
            assert lvl.r_ell is None and lvl.p_t.num_out == nxt.n


def test_resident_amg_anchor_laplace3d_16():
    got = _resident("laplace3d(16)")
    assert got.level_sizes == L16_LEVELS
    assert got.level_digests == L16_DIGESTS
    host = rt.amg_setup(port_graph("laplace3d(16)"), engine="host",
                        backend=CPU, coarse_dtype="float32")
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32))
    assert torch.equal(got.as_precond()(b), host.as_precond()(b))
    assert set(got.timings) == {"aggregate", "prolongator", "galerkin",
                                "pack"}


def test_device_prolongator_equals_scipy_bitwise():
    """laplace3d(12): where the reference's own device prolongator is off
    by 1-2 ulp (XLA contracts its smoothing into an FMA), the port's is
    bit for bit scipy's."""
    g = port_graph("laplace3d(12)")
    agg = rt.coarsen(g, backend=CPU)
    labels, nagg = agg.labels, agg.num_aggregates
    rr, rc, rv = smoothed_prolongator_host(ref_graph("laplace3d(12)")
                                           .csr_matrix, labels, nagg, 2 / 3)
    order = np.lexsort((rc, rr))
    p_cols, p_vals, p_mask, diag = _prolongator_device(
        g.ell_matrix, labels, nagg, 2 / 3)
    rows = np.nonzero(p_mask.numpy())[0]
    np.testing.assert_array_equal(rows, rr[order])
    np.testing.assert_array_equal(p_cols[p_mask].numpy(), rc[order])
    np.testing.assert_array_equal(p_vals[p_mask].numpy().view(np.int64),
                                  rv[order].view(np.int64))
    assert len(rv) == 6064
    p_ell, r_ell = _prolongator_pack_device(p_cols, p_vals, p_mask, nagg)
    assert torch.equal(p_ell.vals, p_vals.to(torch.float32))
    assert int(r_ell.mask.sum()) == len(rv)


def _random_case(seed: int, v: int, nagg: int, density: float):
    """A random symmetric-pattern CSR with empty rows and a rectangular P
    with singleton or empty aggregates (the reference's property case)."""
    rng = np.random.default_rng(seed)
    e = max(0, int(density * v * 4))
    r = rng.integers(0, v, e)
    c = rng.integers(0, v, e)
    vals = rng.standard_normal(e).astype(np.float32)
    a = csr_from_coo(np.concatenate([r, c]), np.concatenate([c, r]), v,
                     np.concatenate([vals, vals]))
    labels = rng.integers(0, nagg, v)
    extra = int(rng.integers(0, 4))
    pr = np.concatenate([np.arange(v), rng.integers(0, v, extra)])
    pc = np.concatenate([labels, rng.integers(0, nagg, extra)])
    pv = rng.standard_normal(len(pr))
    return a, pr, pc, pv


def _reference_device_stages(ell, p_cols, p_vals, nagg):
    """The reference's sorted device stages in float64: kept (keys, sums)."""
    v = ell[0].shape[0]
    k = max(1, v, nagg)
    with jax.enable_x64(True):
        a_vals64 = jnp.where(ell[2], jnp.asarray(ell[1]).astype(jnp.float64),
                             0.0)
        pc, pv = jnp.asarray(p_cols), jnp.asarray(p_vals)
        k1, s1, kp1, dq = ref_stage1(
            jnp.asarray(ell[0]), a_vals64, pc, pv, key_base=k)
        qc, qv = ref_repack(
            k1, s1, kp1, key_base=k, num_rows=v, width=int(dq))
        keys, sums, keep, _, _ = ref_stage2(
            pc, pv, qc, qv, key_base=k)
        keep = np.asarray(keep)
        return np.asarray(keys)[keep], np.asarray(sums)[keep]


@pytest.mark.parametrize("seed,v,nagg,density", [
    (0, 5, 1, 1.0), (1, 40, 7, 0.5), (2, 60, 20, 1.5), (3, 30, 30, 0.0),
    (4, 80, 3, 2.0)])
def test_device_galerkin_stages_equal_host_and_reference(seed, v, nagg,
                                                         density):
    a, pr, pc, pv = _random_case(seed, v, nagg, density)
    ell = csr_to_ell_arrays(a)
    p_cols, p_vals = gal._pad_p_rows(pr, pc, pv, v)
    hr, hc, hv = gal.galerkin_coo_host(*ell, p_cols, p_vals, nagg)
    k = max(1, v, nagg)
    p_mask = np.arange(p_cols.shape[1]) < np.bincount(pr, minlength=v)[:,
                                                                        None]
    a_t = ELLMatrix(*(torch.from_numpy(x) for x in ell))
    p_t = tuple(torch.from_numpy(x) for x in (p_cols, p_vals, p_mask))
    q = gal._coo_rows_repack_device(
        *gal._spgemm_stage1_device(*a_t, *p_t, k), k, v)
    keys, sums = gal._spgemm_stage2_device(*p_t, *q, k)
    np.testing.assert_array_equal(keys.numpy() // k, hr)
    np.testing.assert_array_equal(keys.numpy() % k, hc)
    np.testing.assert_array_equal(sums.numpy().view(np.int64),
                                  hv.view(np.int64))
    if a.num_entries:      # the reference's galerkin() stops before its
        #                    stages on an empty matrix, which they refuse
        rk, rs = _reference_device_stages(ell, p_cols, p_vals, nagg)
        np.testing.assert_array_equal(keys.numpy(), rk)
        np.testing.assert_array_equal(sums.numpy().view(np.int64),
                                      rs.view(np.int64))
    got = gal.galerkin(a, pr, pc, pv, nagg, device="cpu")
    counts = np.bincount(hr, minlength=max(1, nagg))
    np.testing.assert_array_equal(np.diff(got.indptr), counts)
    np.testing.assert_array_equal(got.indices, hc)
    np.testing.assert_array_equal(got.values, hv.astype(np.float32))
    if nagg > 1:
        ac = gal._coo_to_ell_device(keys, sums, k, nagg)
        want = csr_to_ell_arrays(got)
        for x, y in zip(ac, want):
            np.testing.assert_array_equal(x.numpy(), y)


@pytest.mark.parametrize("name,levels", [("laplace3d(8)", 1),
                                         ("laplace3d(8)", 2),
                                         ("elasticity3d(4)", 1)])
def test_resident_cluster_gs_equals_reference_host(name, levels):
    want = repro.cluster_gs_setup(ref_graph(name), engine="host",
                                  coarsen_levels=levels,
                                  mis2_engine="compacted_resident")
    got = rt.cluster_gs_setup(port_graph(name), engine="resident",
                              coarsen_levels=levels, backend=CPU)
    assert got.engine == "resident"
    assert (got.digest, got.colors_digest, got.num_colors,
            got.num_clusters) == (want.digest, want.colors_digest,
                                  want.num_colors, want.num_clusters)
    rows_got = got.preconditioner.color_rows
    rows_want = want.preconditioner.color_rows
    assert len(rows_got) == len(rows_want)
    for x, y in zip(rows_got, rows_want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_device_coarse_graph_and_packing_equal_host():
    g = port_graph("laplace3d(12)")
    labels = rt.coarsen(g, backend=CPU).labels
    nagg = int(labels.max()) + 1
    v = g.num_vertices
    keys = gal._coarse_graph_keys_device(
        *g.ell, torch.from_numpy(labels.astype(np.int64)), v)
    coarse = rt.Graph(gal._coarse_graph_ell_device(keys, v, nagg))
    want = coarse_graph_from_labels(g.csr, labels, nagg)
    want_ell = rt.Graph(want, device="cpu").ell
    for x, y in zip(coarse.ell, want_ell):
        assert torch.equal(x, y)
    colors = rt.color(coarse, backend=CPU)
    got_rows = pack_clusters_device(labels, colors.colors, colors.num_colors,
                                    v, "cpu")
    want_rows = pack_clusters_host(labels, colors.colors, colors.num_colors,
                                   v, "cpu")
    assert len(got_rows) == len(want_rows) == colors.num_colors
    for x, y in zip(got_rows, want_rows):
        assert torch.equal(x, y)


def test_ell_built_graph_reports_sizes_without_csr():
    m = port_graph("elasticity3d(4)").ell_matrix
    g = rt.Graph(m)
    assert g.device == torch.device("cpu") and g.has_values
    want = rt.Graph(rt.graphs.elasticity3d(4), device="cpu")
    assert (g.num_vertices, g.num_entries, g.max_degree,
            g.ell_bytes_estimate()) == (
        want.num_vertices, want.num_entries, want.max_degree,
        want.ell_bytes_estimate())
    np.testing.assert_array_equal(g.degrees, want.degrees)
    assert "ell_to_csr" not in g.conversions and g.ell_matrix is m
    np.testing.assert_array_equal(g.csr.indices, want.csr.indices)
    assert g.conversions["ell_to_csr"] == 1


def test_resident_setup_never_converts_a_coarse_level_to_csr(monkeypatch):
    def refuse(_):
        raise AssertionError("a coarse level was converted to CSR")

    monkeypatch.setattr(handle, "ell_to_csr_graph", refuse)
    s = _resident("laplace3d(12)")
    assert s.num_levels == 3
    c = rt.cluster_gs_setup(port_graph("laplace3d(8)"), engine="resident",
                            coarsen_levels=2, backend=CPU)
    assert c.num_clusters > 0


def test_engine_rule_follows_the_graph_device():
    lap = rt.graphs.laplace3d(4)
    assert default_multilevel_engine(rt.Graph(lap, device="cpu")) == "host"
    assert default_multilevel_engine(rt.Graph(lap, device="cuda")) == \
        "resident"
    s = rt.amg_setup(port_graph("laplace3d(8)"), backend=CPU)
    assert s.engine == "host" and s.dispatches == 0
    c = rt.cluster_gs_setup(port_graph("laplace3d(8)"), backend=CPU)
    assert c.engine == "host"
    assert "resident" in rt.list_engines("multilevel")["multilevel"]
