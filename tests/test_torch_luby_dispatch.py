"""The one-dispatch Luby coloring loops of the port, on the CPU.

``kernels.luby.ref.luby_fixed_point_ref`` and ``luby_fixed_point_hybrid_ref``
(the twins of the persistent kernel behind ``luby`` and ``luby_hybrid``)
against the JAX package's jitted ``_color_fixed_point`` and
``_color_fixed_point_hybrid``: equal colors and rounds, exactly (all
integers), at ``max_rounds`` 1, 2, 3 and uncapped, on the small graphs of
``tests/_torch_common.py`` (laplace3d(8), ER(600), ``powerlaw_graph(900, 8,
seed=4)``, whose heavy rows go through the spill) and on a clique of 70
vertices, where the last six find all 64 colors forbidden and hold the
reference's -95.  The facade's ``host_syncs`` (the twin's reads) and the
wrappers' argument checks.  The kernel itself is held against the twins on
the card in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.core.coloring import _color_fixed_point, _color_fixed_point_hybrid
from repro.graphs.csr import csr_from_coo as ref_csr_from_coo
from repro_torch.graphs.csr import csr_from_coo
from repro_torch.kernels.luby import ops, ref

from _torch_common import CPU, port_hybrid_graph, ref_hybrid_graph

GRAPHS = ("laplace3d", "er_random", "powerlaw", "clique70")
ROUNDS = (1, 2, 3, 256)


def _clique(n: int, csr):
    i, j = np.meshgrid(np.arange(n), np.arange(n))
    keep = i != j
    return csr(i[keep], j[keep], n)


@functools.lru_cache(maxsize=None)
def _ref_graph(name: str):
    if name == "clique70":
        return repro.Graph(_clique(70, ref_csr_from_coo))
    return ref_hybrid_graph(name)


@functools.lru_cache(maxsize=None)
def _port_graph(name: str):
    if name == "clique70":
        return rt.Graph(_clique(70, csr_from_coo), device="cpu")
    return port_hybrid_graph(name)


@functools.lru_cache(maxsize=None)
def _reference(name: str, hybrid: bool, max_rounds: int):
    """The reference's colors and rounds from its jitted loop."""
    g = _ref_graph(name)
    if hybrid:
        h = g.hybrid()
        colors, rounds = _color_fixed_point_hybrid(
            h.slices, h.spill_rows, h.spill_seg, h.spill_cols,
            g.num_vertices, max_rounds)
    else:
        colors, rounds = _color_fixed_point(g.ell.neighbors, g.ell.mask,
                                            max_rounds)
    return np.asarray(colors), int(rounds)


def _twin(name: str, hybrid: bool, max_rounds: int):
    g = _port_graph(name)
    if hybrid:
        h = g.hybrid()
        colors, rounds = ref.luby_fixed_point_hybrid_ref(
            [(sl.rows, sl.neighbors, sl.mask) for sl in h.slices],
            (h.spill_rows, h.spill_seg, h.spill_cols), h.num_vertices,
            max_rounds=max_rounds)
    else:
        colors, rounds = ref.luby_fixed_point_ref(g.ell.neighbors, g.ell.mask,
                                                  max_rounds=max_rounds)
    return colors.numpy(), int(rounds.item())


@pytest.mark.parametrize("max_rounds", ROUNDS)
@pytest.mark.parametrize("hybrid", [False, True], ids=["luby", "luby_hybrid"])
@pytest.mark.parametrize("name", GRAPHS)
def test_twin_equals_the_reference(name, hybrid, max_rounds):
    want, want_rounds = _reference(name, hybrid, max_rounds)
    got, rounds = _twin(name, hybrid, max_rounds)
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds == (min(max_rounds, rounds) or 1)


@pytest.mark.parametrize("hybrid", [False, True], ids=["luby", "luby_hybrid"])
def test_all_64_colors_forbidden_hold_minus_95(hybrid):
    """On the clique of 70 the first 64 vertices to win take colors 0-63;
    every later winner finds all 64 forbidden and is written -95, as the
    reference's float32-exponent lowest set bit gives, and stays
    uncolored: the loop runs to its cap."""
    colors, rounds = _twin("clique70", hybrid, 256)
    assert rounds == 256
    assert sorted(colors[colors >= 0].tolist()) == list(range(64))
    assert (colors[colors < 0] == -95).sum() == 6


@pytest.mark.parametrize("engine", ["luby", "luby_hybrid"])
@pytest.mark.parametrize("max_rounds", [1, 3, 256])
def test_facade_counts_the_twins_reads(engine, max_rounds):
    """On the CPU the twin reads one flag a round past the first, none
    where the cap stopped the loop; the card reads none (tests of the
    kernel in ``tests/test_torch_cuda.py``)."""
    r = rt.color(_port_graph("powerlaw"), engine=engine,
                 max_rounds=max_rounds, backend=CPU)
    want = r.rounds if r.rounds < max_rounds else r.rounds - 1
    assert r.host_syncs == want
    assert r.rounds == _reference("powerlaw", engine == "luby_hybrid",
                                  max_rounds)[1]


def test_wrappers_check_their_arguments():
    g = _port_graph("powerlaw")
    ell, h = g.ell, g.hybrid()
    slabs = [(sl.rows, sl.neighbors, sl.mask) for sl in h.slices]
    spill = (h.spill_rows, h.spill_seg, h.spill_cols)
    v = h.num_vertices
    with pytest.raises(ValueError, match="negative"):
        ops.luby_fixed_point(ell.neighbors, ell.mask, max_rounds=-1)
    with pytest.raises(TypeError, match="mask"):
        ops.luby_fixed_point(ell.neighbors, ell.mask.to(torch.uint8),
                             max_rounds=4)
    with pytest.raises(ValueError, match="one"):
        ops.luby_fixed_point(ell.neighbors, ell.mask[:, 1:].contiguous(),
                             max_rounds=4)
    with pytest.raises(TypeError, match="neighbors"):
        ops.luby_fixed_point(ell.neighbors.to(torch.int64), ell.mask,
                             max_rounds=4)
    with pytest.raises(ValueError, match="disagree"):
        ops.luby_fixed_point_hybrid(
            [(slabs[0][0][1:], slabs[0][1], slabs[0][2])], spill, v,
            max_rounds=4)
    with pytest.raises(ValueError, match="differ in length"):
        ops.luby_fixed_point_hybrid(slabs, (spill[0], spill[1][1:], spill[2]),
                                    v, max_rounds=4)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.luby_fixed_point(ell.neighbors.to("meta"), ell.mask.to("meta"),
                             max_rounds=4)
    before = ops.LAUNCHES["luby_fixed_point"]
    colors, rounds = ops.luby_fixed_point_hybrid(slabs, spill, v,
                                                 max_rounds=256)
    assert ops.LAUNCHES["luby_fixed_point"] == before   # a twin call
    assert colors.dtype == torch.int32 and rounds.tolist() == [
        _reference("powerlaw", True, 256)[1]]
