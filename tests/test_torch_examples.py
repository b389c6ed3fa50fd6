"""The port's examples (``examples/torch/*.py``) on the CPU at small sizes:
each ``main([... "--device", "cpu"])`` runs through its own asserts, and
the digests and sizes it returns equal the JAX package's facade at the
same size (the CG / GMRES iterations within one of the reference's).  The
reference examples themselves are not run."""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import repro
from repro.graphs import csr as ref_csr
from repro.graphs import generators as ref_gen
from repro.graphs.ops import spmv_ell as ref_spmv_ell
from repro.solvers import cg as ref_cg
from repro.solvers import gmres as ref_gmres
from repro.solvers import setup_point_gs as ref_setup_point_gs

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def run(name: str, *argv: str) -> dict:
    return _example(name).main([*argv, "--device", "cpu"])


def _rhs(v: int):
    return jnp.asarray(np.random.default_rng(0).standard_normal(v).astype(
        np.float32))


def test_quickstart_matches_reference():
    out = run("quickstart", "6")
    g = repro.Graph(ref_gen.laplace3d(6))
    r = repro.mis2(g, options=repro.Mis2Options(priority="xorshift_star"))
    assert out["mis2"] == [r.size, r.iterations, r.digest]
    agg = repro.coarsen(g, method="two_phase")
    assert out["coarsen"] == [agg.num_aggregates, agg.iterations, agg.digest]
    fleet = [repro.Graph(ref_gen.laplace3d(2).graph),
             repro.Graph(ref_gen.laplace3d(2).graph),
             repro.Graph(ref_gen.random_uniform_graph(60, 5.0, seed=1)),
             repro.Graph(ref_gen.random_uniform_graph(120, 6.0, seed=2))]
    br = repro.mis2_batch(fleet)
    assert out["batch_digests"] == br.digests
    assert out["bucket_shapes"] == [list(s) for s in br.bucket_shapes]
    assert out["V"] == g.num_vertices and out["E"] == g.num_entries
    assert "cuda_resident" in out["engines"]
    assert out["provenance"]["platform"] == "cpu"


def _expert_graph_ref(num_experts=60, seed=0):
    """The example's co-activation graph, built with the reference's CSR."""
    mod = _example("partition_demo")
    g = mod.expert_coactivation_graph(num_experts, seed)
    return ref_csr.CSRGraph(g.indptr, g.indices)


def test_partition_demo_matches_reference():
    out = run("partition_demo", "--n", "8")
    mesh = repro.partition(repro.Graph(ref_gen.laplace3d(8).graph), 16)
    assert out["mesh"] == [mesh.digest, mesh.edge_cut, mesh.levels]
    assert out["mesh_part_sizes"] == np.bincount(
        mesh.parts, minlength=16).tolist()
    experts = repro.partition(repro.Graph(_expert_graph_ref()), 4,
                              coarse_target=16)
    assert out["experts"] == [experts.digest, experts.edge_cut,
                              experts.levels]
    assert out["expert_groups"] == np.bincount(experts.parts,
                                               minlength=4).tolist()


def test_amg_solve_matches_reference():
    out = run("amg_solve", "--n", "8")
    a = repro.Graph(ref_gen.laplace3d(8))
    ell = a.ell_matrix
    b = _rhs(a.num_vertices)
    mv = lambda x: ref_spmv_ell(ell, x)  # noqa: E731
    plain = ref_cg(mv, b, tol=1e-10, maxiter=3000)
    assert abs(out["plain_cg_iterations"] - plain.iterations) <= 1
    for agg in ("serial", "basic", "two_phase"):
        h = repro.amg(a, aggregation=agg)
        got = out["amg"][agg]
        assert got["level_digests"] == h.level_digests, agg
        assert got["level_sizes"] == [v for v, _ in h.level_sizes], agg
        res = ref_cg(mv, b, precond=h.as_precond(), tol=1e-10, maxiter=300)
        assert abs(got["iterations"] - res.iterations) <= 1, agg


def test_cluster_gs_precond_matches_reference():
    out = run("cluster_gs_precond", "--n", "8")
    a = repro.Graph(ref_gen.laplace3d(8))
    setup = repro.cluster_gs_setup(a)
    assert out["cluster_labels_digest"] == setup.digest
    assert (out["cluster"]["num_colors"], out["cluster"]["num_clusters"]) == (
        setup.num_colors, setup.num_clusters)
    point = ref_setup_point_gs(a)
    assert (out["point"]["num_colors"], out["point"]["num_clusters"]) == (
        point.num_colors, point.num_clusters)
    ell = a.ell_matrix
    b = _rhs(a.num_vertices)
    mv = lambda x: ref_spmv_ell(ell, x)  # noqa: E731
    for kind, pre in (("point", point),
                      ("cluster", setup.preconditioner)):
        res = ref_gmres(mv, b, precond=pre.as_precond(sweeps=1,
                                                      symmetric=True),
                        tol=1e-6, maxiter=800)
        assert abs(out[kind]["iterations"] - res.iterations) <= 1, kind


@pytest.mark.parametrize("name,argv", [
    ("quickstart", ("6",)), ("partition_demo", ("--n", "8")),
    ("amg_solve", ("--n", "8")), ("cluster_gs_precond", ("--n", "8"))])
def test_example_defaults_to_the_card(monkeypatch, name, argv):
    """Without ``--device`` the example asks for ``cuda``: with no card it
    raises, and never falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(list(argv))
