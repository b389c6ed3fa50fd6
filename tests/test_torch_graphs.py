"""The port's graph containers, generators and ``Graph`` handle against the
JAX package: equal arrays and equal digests."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro
from repro.graphs import csr as ref_csr
from repro.graphs import generators as ref_gen
from repro_torch import Graph
from repro_torch.graphs import csr as port_csr
from repro_torch.graphs import generators as port_gen
from repro_torch.graphs import handle as port_handle

GENERATORS = [
    ("laplace3d", (5,), {}),
    ("laplace3d", (4, 5, 6), {}),
    ("elasticity3d", (3,), {}),
    ("elasticity3d", (4,), {"dof": 2}),
    ("random_uniform_graph", (300, 6.0), {"seed": 3}),
    ("random_uniform_graph", (200, 4.0), {"seed": 1,
                                          "with_self_loops": False}),
    ("random_skewed_graph", (400, 5.0), {"seed": 2}),
    ("path_graph", (17,), {}),
]


def _host(x):
    return np.asarray(x)


@pytest.mark.parametrize("fn,args,kw", GENERATORS,
                         ids=[f"{g[0]}{g[1]}" for g in GENERATORS])
def test_generator_arrays_and_digest(fn, args, kw):
    ref = getattr(ref_gen, fn)(*args, **kw)
    port = getattr(port_gen, fn)(*args, **kw)
    assert type(port).__name__ == type(ref).__name__
    for a, b in zip(port, ref):
        b = _host(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert Graph(port).digest == repro.Graph(ref).digest


def test_paper_suite_small_digests():
    ref = ref_gen.paper_suite("small")
    port = port_gen.paper_suite("small")
    assert list(port) == list(ref)
    for name in ref:
        assert Graph(port[name]).digest == repro.Graph(ref[name]).digest


@pytest.mark.parametrize("width", [None, 12])
def test_csr_to_ell_graph_and_matrix(width):
    ref_m = ref_gen.random_uniform_graph(150, 5.0, seed=4)
    port_m = port_gen.random_uniform_graph(150, 5.0, seed=4)
    ref_ell = ref_csr.csr_to_ell_graph(ref_m, width)
    ell = port_csr.csr_to_ell_graph(port_m, width, device="cpu")
    assert ell.neighbors.dtype == torch.int32 and ell.mask.dtype == torch.bool
    np.testing.assert_array_equal(ell.neighbors.numpy(),
                                  _host(ref_ell.neighbors))
    np.testing.assert_array_equal(ell.mask.numpy(), _host(ref_ell.mask))
    ref_mat = ref_csr.csr_to_ell_matrix(ref_gen.laplace3d(4), width)
    mat = port_csr.csr_to_ell_matrix(port_gen.laplace3d(4), width,
                                     device="cpu")
    for a, b in zip(mat, ref_mat):
        np.testing.assert_array_equal(a.numpy(), _host(b))


def test_ell_width_below_max_degree_raises():
    with pytest.raises(ValueError, match="ELL width"):
        port_csr.csr_to_ell_graph(port_gen.laplace3d(3), 3, device="cpu")


def test_pad_ell_graph_matches_reference():
    ref = ref_csr.pad_ell_graph(
        ref_csr.csr_to_ell_graph(ref_gen.path_graph(9)), 12, 5)
    port = port_csr.pad_ell_graph(
        port_csr.csr_to_ell_graph(port_gen.path_graph(9), device="cpu"),
        12, 5)
    np.testing.assert_array_equal(port.neighbors.numpy(),
                                  _host(ref.neighbors))
    np.testing.assert_array_equal(port.mask.numpy(), _host(ref.mask))
    with pytest.raises(ValueError):
        port_csr.pad_ell_graph(port, 4, 5)


def test_csr_from_coo_sums_duplicates_like_reference():
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 30, 400)
    cols = rng.integers(0, 30, 400)
    vals = rng.standard_normal(400)
    ref = ref_csr.csr_from_coo(rows, cols, 30, vals)
    port = port_csr.csr_from_coo(rows, cols, 30, vals)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, _host(b))
    ref_g = ref_csr.csr_from_coo(rows, cols, 30)
    port_g = port_csr.csr_from_coo(rows, cols, 30)
    for a, b in zip(port_g, ref_g):
        np.testing.assert_array_equal(a, _host(b))


def test_ensure_self_loops_matches_reference():
    ref = ref_csr.ensure_self_loops(
        ref_gen.random_uniform_graph(80, 3.0, seed=5, with_self_loops=False))
    port = port_csr.ensure_self_loops(
        port_gen.random_uniform_graph(80, 3.0, seed=5, with_self_loops=False))
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, _host(b))


@pytest.mark.parametrize("values", [True, False])
def test_from_reference_carries_digest(values):
    ref = repro.Graph(ref_gen.elasticity3d(3) if values
                      else ref_gen.random_uniform_graph(90, 4.0, seed=2))
    csr = ref.csr_matrix if values else ref.csr
    g = Graph.from_reference(*[_host(a) for a in csr], device="cpu")
    assert g.has_values is values
    assert g.digest == ref.digest
    assert (g.num_vertices, g.num_entries, g.max_degree) == (
        ref.num_vertices, ref.num_entries, ref.max_degree)


def test_handle_caches_conversions_on_its_device():
    g = Graph(port_gen.laplace3d(4), device="cpu")
    assert g.ell is g.ell and g.ell_matrix is g.ell_matrix
    _ = g.digest, g.digest
    assert g.conversions == {"degrees": 1, "csr_to_ell": 1,
                             "csr_to_ell_matrix": 1, "digest": 1}
    assert g.ell.neighbors.device.type == "cpu"
    assert g.place("cpu") is g and g.conversions["csr_to_ell"] == 1
    with pytest.raises(ValueError, match="structure only"):
        _ = Graph(port_gen.path_graph(4), device="cpu").csr_matrix


def test_ell_budget_refuses_before_allocating(monkeypatch):
    g = Graph(port_gen.laplace3d(4), device="cpu")
    estimate = port_handle.ell_bytes_estimate(64, 7)
    assert estimate == 64 * 7 * port_handle.ELL_BYTES_PER_SLOT
    monkeypatch.setattr(port_handle, "ELL_BYTE_LIMIT", estimate - 1)
    with pytest.raises(port_handle.LayoutOverflowError) as err:
        _ = g.ell
    assert err.value.estimate == estimate
    assert "csr_to_ell" not in g.conversions
