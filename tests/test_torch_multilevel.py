"""The port's multilevel setup against the JAX package's ``host`` engine:
AMG level sizes and per-level ``A_l`` digests bit for bit, equal P, R and
diagonals, the Galerkin product against the scipy oracle, and cluster-GS
labels, coarse colors and packed rows."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.graphs import csr as ref_csr
from repro.multilevel.galerkin import galerkin_coo_host as ref_galerkin
from repro_torch.graphs import ops as gops
from repro_torch.graphs.csr import csr_from_coo, csr_to_ell_arrays
from repro_torch.multilevel import hierarchy_from_arrays
from repro_torch.multilevel.galerkin import _pad_p_rows, galerkin_coo_host

from _torch_common import (
    CPU,
    port_graph,
    ref_amg,
    ref_graph,
    ref_level_arrays,
)

# the reference's host engine on laplace3d(16) (JAX on CPU): levels and
# per-level A_l digests
L16_LEVELS = [(4096, 27136), (625, 17567), (27, 649)]
L16_DIGESTS = ["3079f70aeafb3316", "3b559532b398e5fc", "a8c5c06f3d2de1da"]


@pytest.fixture(scope="module")
def port_amg():
    return {name: rt.amg_setup(port_graph(name), backend=CPU,
                               coarse_dtype="float32")
            for name in ("laplace3d(8)", "laplace3d(16)")}


def test_amg_levels_match_reference(port_amg):
    want = ref_amg("laplace3d(8)")
    got = port_amg["laplace3d(8)"]
    assert got.level_sizes == want.level_sizes == [(512, 3200), (82, 1687)]
    assert got.level_digests == want.level_digests
    assert got.engine == "host" and got.num_levels == want.num_levels


def test_amg_anchor_laplace3d_16(port_amg):
    got = port_amg["laplace3d(16)"]
    assert got.level_sizes == L16_LEVELS
    assert got.level_digests == L16_DIGESTS


def test_transfer_operators_and_diagonals_equal_reference(port_amg):
    ref_levels = ref_level_arrays(ref_amg("laplace3d(8)"))
    for lvl, want in zip(port_amg["laplace3d(8)"].hierarchy.levels,
                         ref_levels):
        np.testing.assert_array_equal(lvl.diag.numpy(), want["diag"])
        for key, m in (("p", lvl.p_ell), ("r", lvl.r_ell)):
            if key not in want:
                assert m is None
                continue
            for x, y in zip(m, want[key]):
                np.testing.assert_array_equal(x.numpy(), y)


def test_hierarchy_from_arrays_keeps_digests():
    want = ref_amg("laplace3d(8)")
    h = hierarchy_from_arrays(ref_level_arrays(want), device="cpu")
    assert h.level_digests() == want.level_digests
    assert [lv.n for lv in h.levels] == [n for n, _ in want.level_sizes]


def test_matrix_free_restriction_drops_r():
    s = rt.amg_setup(port_graph("laplace3d(8)"), backend=CPU,
                     explicit_restriction=False)
    lv0, lv1 = s.hierarchy.levels
    assert lv0.r_ell is None and lv0.p_t.num_out == lv1.n
    assert s.level_digests == ref_amg("laplace3d(8)").level_digests


def test_dense_coarse_cap_falls_back_to_jacobi():
    s = rt.amg_setup(port_graph("laplace3d(8)"), backend=CPU, max_levels=1,
                     dense_coarse_cap=100)
    assert s.hierarchy.coarse_kind == "jacobi" and s.num_levels == 1
    b = torch.ones(512)
    assert torch.isfinite(s.as_precond()(b)).all()


def test_setup_timings_and_default_engine(port_amg):
    got = port_amg["laplace3d(16)"]
    assert set(got.timings) == {"aggregate", "prolongator", "galerkin",
                                "pack"}
    assert got.hierarchy.coarse_dtype == "float32"
    cpu64 = rt.amg_setup(port_graph("laplace3d(8)"), backend=CPU)
    assert cpu64.hierarchy.coarse_dtype == "float64"   # the CPU default
    with pytest.raises(ValueError, match="multilevel"):
        rt.amg_setup(port_graph("laplace3d(8)"), engine="device",
                     backend=CPU)
    resident = rt.amg_setup(port_graph("laplace3d(8)"), engine="resident",
                            backend=CPU)
    assert resident.level_digests == cpu64.level_digests


def _random_case(seed: int, v: int, nagg: int, density: float):
    """The reference's property-test case: a random symmetric-pattern CSR
    with empty rows and a rectangular P with singleton or empty
    aggregates."""
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


def _dense(rows, cols, vals, n):
    out = np.zeros((n, n))
    np.add.at(out, (rows, cols), vals)
    return out


@pytest.mark.parametrize("seed,v,nagg,density", [
    (0, 5, 1, 1.0), (1, 40, 7, 0.5), (2, 60, 20, 1.5), (3, 30, 30, 0.0)])
def test_galerkin_matches_scipy_oracle_and_reference(seed, v, nagg,
                                                     density):
    a, pr, pc, pv = _random_case(seed, v, nagg, density)
    ell = csr_to_ell_arrays(a)
    p_cols, p_vals = _pad_p_rows(pr, pc, pv, v)
    rows, cols, vals = galerkin_coo_host(*ell, p_cols, p_vals, nagg)
    oracle = gops.galerkin_coarse_matrix(a, pr, pc, pv, nagg)
    o_rows = np.repeat(np.arange(nagg), np.diff(oracle.indptr))
    np.testing.assert_allclose(
        _dense(rows, cols, vals.astype(np.float32), nagg),
        _dense(o_rows, oracle.indices, oracle.values, nagg),
        rtol=1e-5, atol=1e-6)
    want = ref_galerkin(ref_csr.ELLMatrix(*ell), p_cols, p_vals, nagg)
    for x, y in zip((rows, cols, vals), want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,levels", [("laplace3d(8)", 1),
                                         ("laplace3d(8)", 2)])
def test_cluster_gs_setup_matches_reference(name, levels):
    want = repro.cluster_gs_setup(ref_graph(name), engine="host",
                                  coarsen_levels=levels,
                                  mis2_engine="compacted_resident")
    got = rt.cluster_gs_setup(port_graph(name), coarsen_levels=levels,
                              backend=CPU)
    assert (got.digest, got.colors_digest, got.num_colors,
            got.num_clusters) == (want.digest, want.colors_digest,
                                  want.num_colors, want.num_clusters)
    assert set(got.timings) == {"aggregate", "color", "pack"}
    rows_got = got.preconditioner.color_rows
    rows_want = want.preconditioner.color_rows
    assert len(rows_got) == len(rows_want)
    for x, y in zip(rows_got, rows_want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_cluster_gs_anchor_laplace3d_8():
    got = rt.cluster_gs_setup(port_graph("laplace3d(8)"), backend=CPU)
    assert (got.num_colors, got.num_clusters, got.digest) == (
        7, 82, "dfda3c0aa9776009")


def test_coarse_graph_from_labels_matches_reference():
    g = port_graph("laplace3d(12)")
    labels = rt.coarsen(g, backend=CPU).labels
    nagg = int(labels.max()) + 1
    got = gops.coarse_graph_from_labels(g.csr, labels, nagg)
    want = repro.graphs.coarse_graph_from_labels(ref_graph("laplace3d(12)")
                                                 .csr, labels, nagg)
    np.testing.assert_array_equal(got.indptr, np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))


def test_extract_diagonal_and_scipy_view():
    a = port_graph("elasticity3d(4)").csr_matrix
    d = gops.extract_diagonal(a, "cpu")
    np.testing.assert_array_equal(d.numpy(),
                                  gops.matrix_to_scipy(a).diagonal()
                                  .astype(np.float32))


def test_small_matrix_is_one_dense_level():
    """V <= coarse_size: no aggregation, the coarsest level is the matrix
    itself and one V-cycle is its LU solve."""
    g = port_graph("laplace3d(4)")
    s = rt.amg_setup(g, backend=CPU)
    assert s.level_sizes == [(64, g.num_entries)]
    assert s.hierarchy.coarse_kind == "lu"
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(64)
                         .astype(np.float32))
    x = s.as_precond()(b)
    np.testing.assert_allclose(
        gops.matrix_to_scipy(g.csr_matrix) @ x.numpy(), b.numpy(),
        rtol=1e-4, atol=1e-4)
