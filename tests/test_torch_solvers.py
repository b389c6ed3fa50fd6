"""The port's solve phase against the JAX package's: the V-cycle on one
hierarchy carried across from the reference (relative 2-norm difference at
most 1e-4: the SpMV sums run in another order), the multicolor GS apply on
the reference's own cluster rows (at most 1e-5), and preconditioned CG and
GMRES iteration counts equal to the reference's (within one) on
laplace3d(16) with ``b = default_rng(0).standard_normal(V)``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.solvers.amg import v_cycle as ref_v_cycle
from repro_torch.graphs.ops import spmv_ell
from repro_torch.multilevel import hierarchy_from_arrays
from repro_torch.solvers import cg, gmres, setup_point_gs, v_cycle
from repro_torch.solvers.multicolor_gs import MulticolorGSPreconditioner

from _torch_common import (
    CPU,
    port_graph,
    ref_amg,
    ref_graph,
    ref_level_arrays,
    rhs,
)

# the reference's iteration counts on laplace3d(16), tol 1e-6 (JAX on CPU)
CG_AMG_ITERS = 7
CG_CLUSTER_GS_ITERS = 22


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def l16():
    g = port_graph("laplace3d(16)")
    return g, torch.from_numpy(rhs(g.num_vertices))


@pytest.mark.parametrize("explicit", [True, False], ids=["R", "matrix-free"])
def test_v_cycle_on_reference_hierarchy(explicit):
    ref = ref_amg("laplace3d(8)", explicit_restriction=explicit)
    h = hierarchy_from_arrays(ref_level_arrays(ref), device="cpu",
                              coarse_dtype="float32",
                              explicit_restriction=explicit)
    b = rhs(512, seed=3)
    want = np.asarray(ref_v_cycle(ref.hierarchy, jnp.asarray(b)))
    got = v_cycle(h, torch.from_numpy(b))
    assert _rel(got, want) <= 1e-4


def test_matrix_free_v_cycle_equals_explicit_bitwise():
    arrays = ref_level_arrays(ref_amg("laplace3d(8)"))
    b = torch.from_numpy(rhs(512, seed=4))
    with_r = hierarchy_from_arrays(arrays, device="cpu")
    free = hierarchy_from_arrays(arrays, device="cpu",
                                 explicit_restriction=False)
    assert torch.equal(v_cycle(with_r, b), v_cycle(free, b))


@pytest.mark.parametrize("explicit", [True, False], ids=["R", "matrix-free"])
@pytest.mark.parametrize("coarse_dtype", ["float32", "float64"])
def test_amg_cg_iterations_match_reference(l16, explicit, coarse_dtype):
    g, b = l16
    s = rt.amg_setup(g, backend=CPU, coarse_dtype=coarse_dtype,
                     explicit_restriction=explicit)
    r = cg(lambda x: spmv_ell(g.ell_matrix, x), b,
           precond=s.as_precond(), tol=1e-6)
    assert r.converged and abs(r.iterations - CG_AMG_ITERS) <= 1
    assert len(r.residual_history) == r.iterations


def test_cluster_gs_cg_iterations_match_reference(l16):
    g, b = l16
    gs = rt.cluster_gs_setup(g, backend=CPU)
    assert gs.num_colors == 9
    r = cg(lambda x: spmv_ell(g.ell_matrix, x), b, precond=gs.as_precond(),
           tol=1e-6)
    assert r.converged and abs(r.iterations - CG_CLUSTER_GS_ITERS) <= 1


def test_gs_apply_on_reference_rows():
    want_pre = repro.cluster_gs_setup(ref_graph("laplace3d(4)"),
                                      engine="host",
                                      mis2_engine="compacted_resident")\
        .preconditioner
    g = port_graph("laplace3d(4)")
    pre = MulticolorGSPreconditioner(
        g.ell_matrix, torch.from_numpy(np.array(want_pre.diag)),
        tuple(torch.from_numpy(np.array(r)) for r in want_pre.color_rows),
        want_pre.num_colors, want_pre.num_clusters, 0.0, "cluster")
    b = rhs(64, seed=5)
    for sweeps, symmetric in ((1, True), (1, False)):
        want = np.asarray(want_pre.apply(jnp.asarray(b), sweeps, symmetric))
        got = pre.apply(torch.from_numpy(b), sweeps, symmetric)
        assert _rel(got, want) <= 1e-5


def test_gs_sweep_is_exact_gauss_seidel():
    """One forward sweep over one cluster holding every row, in order, is
    sequential Gauss-Seidel."""
    g = port_graph("laplace3d(4)")
    a = g.csr_matrix
    dense = np.zeros((64, 64))
    rows = np.repeat(np.arange(64), np.diff(a.indptr))
    dense[rows, a.indices] = a.values
    b = rhs(64, seed=1)
    x = np.zeros(64)
    for i in range(64):
        x[i] = (b[i] - dense[i] @ x + dense[i, i] * x[i]) / dense[i, i]
    pre = MulticolorGSPreconditioner(
        g.ell_matrix, torch.from_numpy(np.diag(dense).astype(np.float32)),
        (torch.arange(64, dtype=torch.int32)[None, :],), 1, 1, 0.0,
        "cluster")
    got = pre.apply(torch.from_numpy(b), sweeps=1, symmetric=False)
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-4, atol=1e-5)
    assert pre.num_steps == 64


def test_point_gs_preconditions_cg(l16):
    g, b = l16
    pre = setup_point_gs(g)
    assert pre.kind == "point" and pre.num_clusters == g.num_vertices
    plain = cg(lambda x: spmv_ell(g.ell_matrix, x), b, tol=1e-6)
    r = cg(lambda x: spmv_ell(g.ell_matrix, x), b, precond=pre.as_precond(),
           tol=1e-6)
    assert r.converged and r.iterations < plain.iterations


@pytest.mark.parametrize("which", ["amg", "cluster_gs"])
def test_gmres_converges_like_cg(l16, which):
    g, b = l16
    s = rt.amg_setup(g, backend=CPU) if which == "amg" else \
        rt.cluster_gs_setup(g, backend=CPU)
    mv = lambda x: spmv_ell(g.ell_matrix, x)   # noqa: E731
    r = gmres(mv, b, precond=s.as_precond(), tol=1e-6)
    c = cg(mv, b, precond=s.as_precond(), tol=1e-6)
    assert r.converged and r.iterations <= c.iterations + 2
    res = b - mv(torch.from_numpy(r.x))
    assert float(torch.linalg.norm(res)) <= 1e-6 * float(torch.linalg.norm(b))


def test_zero_rhs():
    mv = lambda x: x   # noqa: E731
    for solve in (cg, gmres):
        r = solve(mv, torch.zeros(5))
        assert r.converged and r.iterations == 0 and not r.x.any()
