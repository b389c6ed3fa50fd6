"""The port's multilevel partition (``rt.partition``) against the JAX
package's: equal parts digest, edge cut, levels and per-level history on
the CPU (the fused kernels' twins stand in for the coarsening's MIS-2)."""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch as rt
from repro.graphs.csr import CSRGraph as RefCSRGraph
from repro_torch.core import partition as port_part
from repro_torch.graphs import handle as port_handle

from _torch_common import (
    CPU,
    GRAPHS,
    PARTITIONS,
    port_graph,
    ref_graph,
    ref_partition,
)

# the module (``repro.core`` exports a deprecated function of its name)
ref_part = importlib.import_module("repro.core.partition")


@pytest.mark.parametrize("case", list(PARTITIONS))
def test_partition_matches_reference(case):
    name, parts, target, _ = PARTITIONS[case]
    r = rt.partition(port_graph(name), parts, coarse_target=target,
                     backend=CPU)
    assert (r.digest, r.edge_cut, r.levels, r.history, r.converged) == \
        ref_partition(case)
    assert r.parts.dtype == np.int32 and r.num_parts == parts
    assert r.iterations == r.levels
    assert set(np.unique(r.parts)) <= set(range(parts))


def test_partition_of_a_graph_without_entries():
    """No coarsening, no edges: the greedy split alone, as the reference
    gives it ([0 0 1 1 0] on five vertices)."""
    ref = repro.partition(repro.Graph(RefCSRGraph(
        jnp.zeros(6, jnp.int32), jnp.zeros(0, jnp.int32))), 2)
    port = rt.partition(rt.Graph(rt.graphs.CSRGraph(
        np.zeros(6, np.int32), np.zeros(0, np.int32)), device="cpu"), 2,
        backend=CPU)
    np.testing.assert_array_equal(port.parts, [0, 0, 1, 1, 0])
    assert (port.digest, port.edge_cut, port.levels, port.history) == (
        ref.digest, ref.edge_cut, ref.levels, ref.history)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_edge_cut_matches_reference(name):
    v = ref_graph(name).num_vertices
    parts = np.random.default_rng(5).integers(0, 5, size=v).astype(np.int32)
    assert port_part.edge_cut(port_graph(name), parts) == \
        ref_part.edge_cut(ref_graph(name), parts)


def test_greedy_and_refine_match_reference_on_a_coarse_graph():
    """The coarsest-level steps on one graph: the greedy split (host, the
    reference's code) and one refinement whose counts and gains come from
    the port's device tensors."""
    name = "uniform(2000,6)"
    ref_g, port_g = ref_graph(name), port_graph(name)
    w = np.random.default_rng(3).integers(1, 4, size=ref_g.num_vertices)
    ref_parts = ref_part._greedy_coarse_partition(ref_g.csr, 6, w)
    parts = port_part._greedy_coarse_partition(port_g.csr, 6, w)
    np.testing.assert_array_equal(parts, ref_parts)
    np.testing.assert_array_equal(
        port_part._refine(port_g, parts.copy(), 6, w),
        ref_part._refine(ref_g, ref_parts.copy(), 6, w))


def test_partition_past_the_ell_budget_raises(monkeypatch):
    """Both packages refuse a graph whose padded ELL passes the budget."""
    from repro.graphs import hybrid as ref_hybrid

    monkeypatch.setattr(port_handle, "ELL_BYTE_LIMIT", 1000)
    monkeypatch.setattr(ref_hybrid, "ELL_BYTE_LIMIT", 1000)
    with pytest.raises(port_handle.LayoutOverflowError):
        rt.partition(port_graph("laplace3d(8)"), 4, backend=CPU)
    with pytest.raises(ref_hybrid.LayoutOverflowError):
        repro.partition(repro.Graph(repro.graphs.laplace3d(8)), 4)


def test_partition_engine_registry():
    assert rt.list_engines()["partition"] == ["multilevel"]
    with pytest.raises(ValueError, match="unknown 'partition' engine"):
        rt.partition(port_graph("laplace3d(8)"), 4, engine="metis",
                     backend=CPU)
