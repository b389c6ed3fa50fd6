"""The port's Luby coloring against the JAX package's ``luby`` engine: equal
colors (determinism digest), color counts and round counts, on the CPU
through the hash-pack twin."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro_torch.core import coloring
from repro_torch.kernels.luby import ref as luby_ref

from _torch_common import CPU, port_graph, ref_graph

NAMES = ["laplace3d(8)", "laplace3d(12)", "elasticity3d(4)",
         "uniform(2000,6)"]


@pytest.fixture(scope="module")
def ref_colorings():
    return {name: repro.color(ref_graph(name)) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_color_matches_reference(ref_colorings, name):
    want = ref_colorings[name]
    got = rt.color(port_graph(name), backend=CPU)
    assert (got.digest, got.num_colors, got.rounds, got.converged) == (
        want.digest, want.num_colors, want.rounds, want.converged)
    assert coloring.check_coloring(port_graph(name), got.colors)
    assert got.host_syncs == got.rounds


def test_color_anchor_laplace3d_8():
    r = rt.color(port_graph("laplace3d(8)"), backend=CPU)
    assert (r.num_colors, r.digest) == (5, "3f45a9cfe50afa1e")


def test_round_limit_gives_partial_coloring_like_reference():
    want = repro.color(ref_graph("uniform(2000,6)"), max_rounds=2)
    got = rt.color(port_graph("uniform(2000,6)"), max_rounds=2, backend=CPU)
    assert not got.converged and (got.colors < 0).any()
    assert (got.digest, got.rounds) == (want.digest, want.rounds)


@pytest.mark.parametrize("bit", range(32))
def test_lowest_set_bit_equals_integer_ctz(bit):
    """The float32-exponent trick against an integer count of trailing
    zeros, for a single bit and for that bit under every higher bit."""
    single = torch.tensor([1 << bit], dtype=torch.int64)
    above = torch.tensor([(0xFFFFFFFF >> bit) << bit], dtype=torch.int64)
    assert luby_ref.lowest_set_bit(single).item() == bit
    assert luby_ref.lowest_set_bit(above).item() == bit


def test_smallest_free_color_spills_into_high_word():
    lo = torch.tensor([0xFFFFFFFF, 0xFFFFFFFF, 0x7], dtype=torch.int64)
    hi = torch.tensor([0x0, 0x3, 0x0], dtype=torch.int64)
    np.testing.assert_array_equal(
        luby_ref.smallest_free_color(lo, hi).numpy(), [32, 34, 3])


def test_check_coloring_rejects_a_clash():
    g = port_graph("laplace3d(8)")
    colors = rt.color(g, backend=CPU).colors.copy()
    assert coloring.check_coloring(g, colors)
    nbr = g.csr.indices[g.csr.indptr[0]:g.csr.indptr[1]]
    colors[nbr[nbr != 0][0]] = colors[0]
    assert not coloring.check_coloring(g, colors)


# graphs with no entries: the reference gives every vertex color 0 in one
# round (its digests, recorded)
EMPTY = {5: "fbbe405d2943be32", 1: "349ec62966086377"}


@pytest.mark.parametrize("engine", ["luby", "luby_hybrid"])
@pytest.mark.parametrize("v", list(EMPTY))
def test_color_of_a_graph_with_no_entries_matches_reference(v, engine):
    from repro.graphs.csr import csr_from_coo as ref_csr_from_coo
    from repro_torch.graphs.csr import csr_from_coo

    empty = np.zeros(0, dtype=np.int64)
    want = repro.color(repro.Graph(ref_csr_from_coo(empty, empty, v)),
                       engine=engine)
    got = rt.color(rt.Graph(csr_from_coo(empty, empty, v), device="cpu"),
                   engine=engine, backend=CPU)
    assert (got.digest, got.num_colors, got.rounds) == (
        want.digest, want.num_colors, want.rounds)
    assert got.digest == EMPTY[v] and (got.colors == 0).all()
