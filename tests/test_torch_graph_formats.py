"""The port's remaining graph formats and helpers against the JAX package's:
the degree-bucketed and padded ELL, ``Graph.from_coo`` and ``stats``,
``symmetrize`` / ``degrees`` / ``graph_power2`` / ``er_laplacian`` (equal
arrays), the closed-neighbourhood reductions (equal), and the segment-sum
CSR SpMV (rtol 1e-6: a float32 sum of at most D terms, in another order)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.graphs import csr as ref_csr
from repro.graphs import generators as ref_gen
from repro.graphs import ops as ref_ops
from repro_torch.graphs import csr as port_csr
from repro_torch.graphs import generators as port_gen
from repro_torch.graphs import handle as port_handle
from repro_torch.graphs import ops as port_ops

from _torch_common import GRAPHS, port_graph, ref_graph

#: the parity graphs plus a skewed one whose rows fill every default bucket
FORMAT_GRAPHS = {**{n: n for n in GRAPHS}, "skewed(3000,6)": None}


def _graphs(name: str):
    if name == "skewed(3000,6)":
        return (repro.Graph(ref_gen.random_skewed_graph(3000, 6.0, seed=9)),
                rt.Graph(port_gen.random_skewed_graph(3000, 6.0, seed=9),
                         device="cpu"))
    return ref_graph(name), port_graph(name)


def _eq(port: torch.Tensor | np.ndarray, ref) -> None:
    a = port.numpy() if isinstance(port, torch.Tensor) else port
    b = np.asarray(ref)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("boundaries", [(8, 32, 128), (4, 6), (2,)])
@pytest.mark.parametrize("name", list(FORMAT_GRAPHS))
def test_bucketed_ell_matches_reference(name, boundaries):
    ref_g, g = _graphs(name)
    ref = ref_g.bucketed(boundaries)
    port = g.bucketed(boundaries)
    assert len(port.rows) == len(ref.rows) > 0
    for r, pg, rr, rg in zip(port.rows, port.graphs, ref.rows, ref.graphs):
        _eq(r, rr)
        _eq(pg.neighbors, rg.neighbors)
        _eq(pg.mask, rg.mask)
    assert port.num_vertices == ref.num_vertices
    assert port.padding_ratio == ref.padding_ratio
    assert g.bucketed(boundaries) is port          # cached per boundaries
    assert g.conversions["csr_to_bucketed_ell"] == 1


@pytest.mark.parametrize("extra", [(0, 0), (5, 0), (0, 3), (17, 4)])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_padded_ell_matches_reference(name, extra):
    ref_g, g = _graphs(name)
    rows, width = ref_g.num_vertices + extra[0], ref_g.ell.width + extra[1]
    ref = ref_g.padded_ell(rows, width)
    port = g.padded_ell(rows, width)
    _eq(port.neighbors, ref.neighbors)
    _eq(port.mask, ref.mask)
    assert g.padded_ell(rows, width) is port
    assert g.conversions["pad_ell"] == 1


def test_padded_ell_budget_is_checked_before_building(monkeypatch):
    g = port_graph("laplace3d(8)")
    monkeypatch.setattr(port_handle, "ELL_BYTE_LIMIT", 10_000)
    with pytest.raises(port_handle.LayoutOverflowError):
        g.padded_ell(4000, 7)
    assert "csr_to_ell" not in g.conversions      # refused before .ell
    assert "pad_ell" not in g.conversions


@pytest.mark.parametrize("with_vals", [False, True])
def test_from_coo_matches_reference(with_vals):
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 90, size=600)
    cols = rng.integers(0, 90, size=600)          # duplicates included
    vals = rng.standard_normal(600) if with_vals else None
    ref = repro.Graph.from_coo(rows, cols, 90, vals)
    port = rt.Graph.from_coo(rows, cols, 90, vals, device="cpu")
    _eq(port.csr.indptr, ref.csr.indptr)
    _eq(port.csr.indices, ref.csr.indices)
    if with_vals:
        _eq(port.csr_matrix.values, ref.csr_matrix.values)
    assert port.digest == ref.digest
    assert port.device == torch.device("cpu")


@pytest.mark.parametrize("name", list(FORMAT_GRAPHS))
def test_stats_match_reference(name):
    ref_g, g = _graphs(name)
    ref = dict(ref_g.stats())
    port = g.stats()
    # the reference's cache also holds the formats the parity runs built
    ref_formats, formats = ref.pop("cached_formats"), port.pop("cached_formats")
    assert port == ref
    assert set(formats) <= set(ref_formats) | {"degrees"}
    fresh_ref = repro.Graph(ref_g.csr_matrix if ref_g.has_values
                            else ref_g.csr).stats()
    fresh = rt.Graph(g.csr_matrix if g.has_values else g.csr,
                     device="cpu").stats()
    assert fresh == fresh_ref


def test_ell_seeded_stats_and_coercions():
    ell = port_graph("laplace3d(8)").ell
    g = rt.Graph(ell)
    ref = repro.Graph(ref_graph("laplace3d(8)").ell).stats()
    stats = g.stats()
    for key in ("num_vertices", "num_entries", "max_degree", "avg_degree",
                "has_values"):
        assert stats[key] == ref[key]
    assert "num_entries" not in stats["cached_formats"]
    assert "ell_to_csr" not in g.conversions       # sizes from the mask
    assert rt.graphs.as_ell_graph(ell) is ell
    assert rt.graphs.as_ell_graph(g) is g.ell
    csr = rt.graphs.as_csr_graph(g)
    assert rt.graphs.as_csr_graph(csr) is csr
    _eq(csr.indices, ref_graph("laplace3d(8)").csr.indices)


def test_conversion_timings_follow_the_counts():
    g = port_graph("laplace3d(12)")
    g.ell
    g.ell_matrix
    g.bucketed()
    g.padded_ell(g.num_vertices + 1, 9)
    g.digest
    timings = g.conversion_timings
    assert set(timings) == set(g.conversions)
    assert all(t >= 0.0 for t in timings.values())
    before = dict(timings)
    g.ell
    g.bucketed()
    assert g.conversion_timings == before          # cache hits: no time


def test_place_moves_every_cached_device_format():
    g = port_graph("laplace3d(8)")
    g.ell
    g.padded_ell(600, 9)
    g.bucketed((4,))
    g.place("meta")
    moved = [g.ell.neighbors, g.padded_ell(600, 9).mask,
             *g.bucketed((4,)).rows,
             *(x for b in g.bucketed((4,)).graphs for x in b)]
    assert all(t.device.type == "meta" for t in moved)
    assert g.conversions["pad_ell"] == 1


@pytest.mark.parametrize("name", list(GRAPHS))
def test_symmetrize_and_degrees_match_reference(name):
    # a non-symmetric CSR: the upper triangle of the graph
    csr = port_graph(name).csr
    rows = np.repeat(np.arange(csr.num_vertices), np.diff(csr.indptr))
    keep = rows <= csr.indices
    upper = port_csr.csr_from_coo(rows[keep], csr.indices[keep],
                                  csr.num_vertices)
    ref_upper = ref_csr.CSRGraph(jnp.asarray(upper.indptr),
                                 jnp.asarray(upper.indices))
    sym, ref_sym = port_csr.symmetrize(upper), ref_csr.symmetrize(ref_upper)
    _eq(sym.indptr, ref_sym.indptr)
    _eq(sym.indices, ref_sym.indices)
    _eq(port_csr.degrees(upper), ref_csr.degrees(ref_upper))
    _eq(sym.indices, csr.indices)                  # back to the graph


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_power2_matches_reference(name):
    sq = port_ops.graph_power2(port_graph(name).csr)
    ref = ref_ops.graph_power2(ref_graph(name).csr)
    _eq(sq.indptr, ref.indptr)
    _eq(sq.indices, ref.indices)


@pytest.mark.parametrize("args", [(200, 4.0, 0), (1500, 7.5, 3)])
def test_er_laplacian_matches_reference(args):
    ref = ref_gen.er_laplacian(*args)
    port = port_gen.er_laplacian(*args)
    for a, b in zip(port, ref):
        _eq(a, b)
    assert rt.Graph(port, device="cpu").digest == repro.Graph(ref).digest


@pytest.mark.parametrize("name", list(GRAPHS))
def test_neighbor_reductions_match_reference(name):
    ref_ell, ell = ref_graph(name).ell, port_graph(name).ell
    v = ell.num_vertices
    rng = np.random.default_rng(6)
    t = rng.integers(0, 2**32, size=v, dtype=np.uint32)
    m = t.copy()
    m[rng.random(v) < 0.3] = 7
    tw, mw = (torch.from_numpy(x.astype(np.int64)) for x in (t, m))
    _eq(port_ops.neighbor_min(ell, tw).numpy().astype(np.uint32),
        ref_ops.neighbor_min(ref_ell, jnp.asarray(t)))
    _eq(port_ops.neighbor_all_eq(ell, mw, tw),
        ref_ops.neighbor_all_eq(ref_ell, jnp.asarray(m), jnp.asarray(t)))
    _eq(port_ops.neighbor_any_eq(ell, mw, 7),
        ref_ops.neighbor_any_eq(ref_ell, jnp.asarray(m), jnp.uint32(7)))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_spmv_csr_segment_matches_reference(name):
    m = port_graph(name).csr_matrix if port_graph(name).has_values else \
        port_gen.er_laplacian(2000, 6.0, seed=7)
    ref_m = ref_csr.CSRMatrix(*(jnp.asarray(a) for a in m))
    x = np.random.default_rng(1).standard_normal(m.num_rows).astype(
        np.float32)
    y = port_ops.spmv_csr_segment(m, torch.from_numpy(x))
    ref = np.asarray(ref_ops.spmv_csr_segment(ref_m, jnp.asarray(x)))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-6, atol=0)
