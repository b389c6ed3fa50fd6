"""The coarsening's one-dispatch label joins of the port, on the CPU.

``kernels.joins.ref`` (the twins of the ``root_join``, ``phase2_join`` and
``phase3_fixed_point`` kernels) against the JAX package's jitted joins over
the padded ELL (``_join_adjacent_root``, ``_cleanup_join_resident``,
``_phase2_join_resident``, ``_phase3_resident``) and over the hybrid layout
(``_hybrid_join_jit``, ``_cleanup_join_resident_hybrid``,
``_phase2_join_resident_hybrid``, ``_phase3_resident_hybrid``): equal
labels, phase marks, secondary roots and aggregate counts, exactly (all
integers), on laplace3d(8), ER(600), ``powerlaw_graph(900, 8, seed=4)``
(heavy rows through the spill) and a star of 60 leaves, from the states a
two-phase coarsening reaches and from seeded ones.  The wrappers take the
twins on the CPU and check their arguments; the kernels themselves are
held against the twins on the card in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.joins import ops, ref

from _torch_common import join_inputs, port_join_graph, ref_join

GRAPHS = ("laplace3d", "er_random", "powerlaw", "star60")
LAYOUTS = ("ell", "hybrid")
STATES = ("coarsening", "seeded")


def _layout(name: str, layout: str) -> ref.Layout:
    g = port_join_graph(name)
    if layout == "ell":
        return ref.ell_layout(*g.ell)
    return ref.hybrid_layout(g.hybrid())


def _inputs(name: str, state: str) -> dict:
    return {k: torch.tensor(v) for k, v in join_inputs(name, state).items()}


def _equal(got, want) -> None:
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


cases = pytest.mark.parametrize(
    "name,layout,state", [(n, lay, s) for n in GRAPHS for lay in LAYOUTS
                          for s in STATES])


@cases
@pytest.mark.parametrize("cleanup_rounds", [0, 4])
def test_root_join_twin_equals_reference(name, layout, state,
                                         cleanup_rounds):
    x = _inputs(name, state)
    labels, phase, aux = ref.root_join_ref(
        _layout(name, layout), x["roots"], cleanup_rounds=cleanup_rounds)
    want = ref_join(name, layout, "root_cleanup" if cleanup_rounds else
                    "root", state)
    _equal((labels, phase), want)
    assert aux.tolist() == [int(x["roots"].sum()), int((want[0] < 0).sum())]


@cases
def test_cleanup_join_twin_equals_reference(name, layout, state):
    x = _inputs(name, state)
    got = ref.cleanup_join_ref(_layout(name, layout), x["labels1"],
                               x["phase1"])
    _equal(got, ref_join(name, layout, "cleanup", state))


@pytest.mark.parametrize(
    "name,layout,state,min_secondary",
    [(n, lay, s, ms) for n in GRAPHS for lay in LAYOUTS for s in STATES
     for ms in ((1, 2, 3) if lay == "ell" else (2,))])
def test_phase2_join_twin_equals_reference(name, layout, state,
                                           min_secondary):
    x = _inputs(name, state)
    labels, phase, roots2, nagg = ref.phase2_join_ref(
        _layout(name, layout), x["labels1"], x["phase1"], x["in_set2"],
        x["nagg"].view(1).to(torch.int32), min_secondary=min_secondary)
    want = ref_join(name, layout, "phase2", state, min_secondary)
    _equal((labels, phase, roots2), want[:3])
    assert nagg.tolist() == [want[3]]


@cases
def test_phase3_twin_equals_reference(name, layout, state):
    x = _inputs(name, state)
    got = ref.phase3_fixed_point_ref(_layout(name, layout), x["labels2"],
                                     x["phase2"])
    _equal(got, ref_join(name, layout, "phase3", state))


def test_states_reach_the_spill_and_leave_rows_unlabeled():
    """The cases exercise what the kernels must get right: heavy rows in
    the spill, unlabeled before phase 3 in the seeded states, and rows
    that phase 3 joins in the coarsening states."""
    hyb = port_join_graph("powerlaw").hybrid()
    assert hyb.num_spill_rows > 0
    heavy = hyb.spill_rows.long()
    assert bool((_inputs("powerlaw", "seeded")["labels2"][heavy] < 0).any())
    joined = []
    for name in GRAPHS:
        x = _inputs(name, "coarsening")
        got, _ = ref.phase3_fixed_point_ref(_layout(name, "ell"),
                                            x["labels2"], x["phase2"])
        joined.append(int((got >= 0).sum() - (x["labels2"] >= 0).sum()))
    assert all(n > 0 for n in joined[:3]), joined


def test_wrappers_take_the_twins_on_the_cpu():
    layout = _layout("powerlaw", "hybrid")
    x = _inputs("powerlaw", "coarsening")
    nagg = x["nagg"].view(1).to(torch.int32)
    before = dict(ops.LAUNCHES)
    calls = {
        "root_join": lambda: ops.root_join(layout, x["roots"],
                                           cleanup_rounds=4),
        "cleanup_join": lambda: ops.cleanup_join(layout, x["labels1"],
                                                 x["phase1"]),
        "phase2_join": lambda: ops.phase2_join(
            layout, x["labels1"], x["phase1"], x["in_set2"], nagg,
            min_secondary=2),
        "phase3_fixed_point": lambda: ops.phase3_fixed_point(
            layout, x["labels2"], x["phase2"]),
    }
    twins = {
        "root_join": lambda: ref.root_join_ref(layout, x["roots"],
                                               cleanup_rounds=4),
        "cleanup_join": lambda: ref.cleanup_join_ref(layout, x["labels1"],
                                                     x["phase1"]),
        "phase2_join": lambda: ref.phase2_join_ref(
            layout, x["labels1"], x["phase1"], x["in_set2"], nagg,
            min_secondary=2),
        "phase3_fixed_point": lambda: ref.phase3_fixed_point_ref(
            layout, x["labels2"], x["phase2"]),
    }
    for name, call in calls.items():
        _equal(call(), twins[name]())
    assert ops.LAUNCHES == before       # twin calls are not launches


def test_wrappers_check_their_arguments():
    layout = _layout("powerlaw", "hybrid")
    ell = _layout("powerlaw", "ell")
    x = _inputs("powerlaw", "coarsening")
    nagg = x["nagg"].view(1).to(torch.int32)
    with pytest.raises(TypeError, match="roots"):
        ops.root_join(layout, x["roots"].to(torch.uint8))
    with pytest.raises(ValueError, match="negative"):
        ops.root_join(layout, x["roots"], cleanup_rounds=-1)
    with pytest.raises(ValueError, match="shape"):
        ops.root_join(layout, x["roots"][1:])
    with pytest.raises(TypeError, match="phase"):
        ops.cleanup_join(layout, x["labels1"], x["phase1"].to(torch.int32))
    with pytest.raises(TypeError, match="labels"):
        ops.phase3_fixed_point(layout, x["labels2"].to(torch.int64),
                               x["phase2"])
    with pytest.raises(ValueError, match="contiguous"):
        ops.phase3_fixed_point(
            ell, torch.stack([x["labels2"]] * 2, dim=1)[:, 0], x["phase2"])
    with pytest.raises(TypeError, match="neighbors"):
        ops.phase3_fixed_point(
            ref.ell_layout(ell.maps[0][1].to(torch.int64), ell.maps[0][2]),
            x["labels2"], x["phase2"])
    with pytest.raises(ValueError, match="disagree"):
        ops.cleanup_join(ref.Layout(
            ((layout.maps[0][0][1:],) + layout.maps[0][1:],)
            + layout.maps[1:], layout.spill, layout.v),
            x["labels1"], x["phase1"])
    with pytest.raises(ValueError, match="differ in length"):
        ops.cleanup_join(ref.Layout(
            layout.maps, (layout.spill[0], layout.spill[1][1:],
                          layout.spill[2]), layout.v),
            x["labels1"], x["phase1"])
    with pytest.raises(TypeError, match="nagg"):
        ops.phase2_join(layout, x["labels1"], x["phase1"], x["in_set2"],
                        nagg.to(torch.int64), min_secondary=2)
    with pytest.raises(ValueError, match="nagg has shape"):
        ops.phase2_join(layout, x["labels1"], x["phase1"], x["in_set2"],
                        nagg.repeat(2), min_secondary=2)
    with pytest.raises(ValueError, match="unsupported device"):
        meta = ref.ell_layout(*(t.to("meta") for t in ell.maps[0][1:]))
        ops.phase3_fixed_point(meta, x["labels2"].to("meta"),
                               x["phase2"].to("meta"))
