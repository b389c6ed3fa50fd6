"""The port's distributed engines (``repro_torch.core.dist``) against the
JAX package's single-device engines.

One child process (``tests/_torch_dist_worker.py``) runs a gloo world of
four CPU ranks: process groups of 1, 2 and 4 ranks and a (2, 2)
``DeviceMesh``, at V = 1000, 1022 (pads across a power of two) and 997
(not divisible), both MIS-2 variants, the sharded two-phase coarsening,
the adversarial ``id_bits`` case and the collective accounting; every rank
reports, and every rank is held to the reference's ``dense`` / ``two_phase``
results, computed here in-process on one device.  The plumbing (a group of
one rank with no process group initialized, the model, the engine table,
the inner-engine check) runs in-process.
"""
from __future__ import annotations

import functools
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro
import repro_torch as rt
from repro.graphs import generators as ref_gen
from repro_torch.core import dist as core_dist

from _torch_common import CPU

REPO = Path(__file__).resolve().parents[1]
SIZES = (1000, 1022, 997)
ENGINES = ("distributed", "distributed_single_gather")
GROUPS = ("P=1", "P=2", "P=4")


@pytest.fixture(scope="module")
def world():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "tests" / "_torch_dist_worker.py")],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.rsplit("RESULT:", 1)[1])


def _ref_graph(v: int):
    if v == 1000:
        return repro.Graph(ref_gen.laplace3d(10))
    return repro.Graph(ref_gen.random_uniform_graph(v, 6.0, seed=v))


@functools.lru_cache(maxsize=None)
def ref_dense(v: int):
    return repro.mis2(_ref_graph(v), engine="dense")


@functools.lru_cache(maxsize=None)
def ref_two_phase(v: int):
    a = repro.coarsen(_ref_graph(v), method="two_phase", mis2_engine="dense")
    dd = repro.api.result.determinism_digest
    return {"digest": a.digest, "roots": dd(a.roots), "phase": dd(a.phase),
            "num_aggregates": a.num_aggregates}


def _ranks(world, group: str, size: int) -> list:
    ranks = world[group]
    assert len(ranks) == int(group.split("=")[1])
    return [r[str(size)] for r in ranks]


@pytest.mark.parametrize("v", SIZES)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("group", GROUPS)
def test_digest_and_iterations_match_dense(world, group, engine, v):
    """Bit-identical to the reference's single-device dense engine on
    every rank, for every group size (V = 1022 pads across 1024 on four
    ranks: the padded count must not reach ``id_bits``)."""
    want = ref_dense(v)
    for case in _ranks(world, group, v):
        got = case[engine]
        assert got["digest"] == want.digest
        assert got["iterations"] == want.iterations
        assert got["converged"] and want.converged
        assert got["host_syncs"] == got["iterations"] + 1
        assert got["provenance_digest"] == got["digest"]


@pytest.mark.parametrize("v", SIZES)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("group", GROUPS)
def test_collective_bytes_equal_the_model(world, group, engine, v):
    """The gather wrapper's count of T and M result bytes equals the
    model times the rounds, and the registry's ``dist.collective_bytes``."""
    p = int(group.split("=")[1])
    single = engine == "distributed_single_gather"
    model = core_dist.collective_bytes_per_iteration(v, p, single)
    for case in _ranks(world, group, v):
        got = case[engine]
        col = got["collectives"]
        total = model["result_bytes_per_iteration"] * got["iterations"]
        assert col["result_bytes_total"] == total
        assert got["counted_bytes"] == total == col["counted_result_bytes"]
        assert got["registry_bytes"] == total
        assert got["registry_rounds"] == got["iterations"]
        assert col["num_devices"] == p
        assert col["gathers_per_iteration"] == (1 if single else 2)
        assert col["wire_bytes_per_device"] == pytest.approx(
            model["wire_bytes_per_device_per_iteration"] * got["iterations"])


COARSENINGS = [(g, label) for g in GROUPS
               for label in ("two_phase_distributed",
                             "two_phase_inner_distributed")] + [
    ("P=4", "two_phase_distributed_single")]


@pytest.mark.parametrize("v", SIZES)
@pytest.mark.parametrize("group,label", COARSENINGS)
def test_distributed_coarsening_matches_two_phase(world, group, label, v):
    """Labels, roots and phase equal the reference's single-device
    ``two_phase``: the sharded method (both schedules) and ``two_phase``
    with the distributed inner fixed point."""
    want = ref_two_phase(v)
    for case in _ranks(world, group, v):
        got = case[label]
        for k in ("digest", "roots", "phase", "num_aggregates"):
            assert got[k] == want[k], k


def test_mesh_flattens_row_major(world):
    want = ref_dense(997)
    for rank in world["mesh(2,2)"]:
        assert rank["group_size"] == 4
        for e in ENGINES:
            assert rank[e]["digest"] == want.digest
            assert rank[e]["collectives"]["num_devices"] == 4


@pytest.mark.parametrize("engine", ENGINES)
def test_padded_v_id_bits_regression(world, engine, monkeypatch):
    """V = 6 pads to 8 on four ranks; packing with the padded count's
    ``id_bits`` (4, not 3) flips the adversarial set."""
    import jax.numpy as jnp
    from repro.core import hashing

    monkeypatch.setitem(hashing.PRIORITY_FNS, "adversarial",
                        lambda it, vids: jnp.where(vids == 0, jnp.uint32(8),
                                                   jnp.uint32(0)))
    path = repro.Graph.from_coo(np.array([0, 1, 1, 2, 2, 3, 3, 4, 4, 5]),
                                np.array([1, 0, 2, 1, 3, 2, 4, 3, 5, 4]), 6)
    want = repro.mis2(path, engine="dense",
                      options=repro.Mis2Options(priority="adversarial"))
    for rank in world["P=4"]:
        got = rank["adversarial"][engine]
        assert got["digest"] == want.digest
        assert got["iterations"] == want.iterations
        assert got["collectives"]["num_devices"] == 4


# ---------------------------------------------------------------------------
# in-process: one rank, no process group
# ---------------------------------------------------------------------------

def test_engines_registered():
    engines = rt.list_engines()
    for e in ENGINES:
        assert e in engines["mis2"]
    assert "two_phase_distributed" in engines["aggregation"]


def test_no_group_is_one_rank():
    assert rt.Backend(device="cpu").resolve_group() == (None, 1, 0)
    g = rt.Graph(rt.graphs.random_uniform_graph(301, 5.0, seed=7),
                 device="cpu")
    dense = rt.mis2(g, engine="dense", backend=CPU)
    for e in ENGINES:
        r = rt.mis2(g, engine=e, backend=CPU)
        assert (r.digest, r.iterations) == (dense.digest, dense.iterations)
        assert r.collectives["num_devices"] == 1
        assert r.collectives["wire_bytes_per_device"] == 0
    a1 = rt.coarsen(g, method="two_phase", mis2_engine="dense", backend=CPU)
    a2 = rt.coarsen(g, method="two_phase_distributed", backend=CPU)
    assert a1.digest == a2.digest and a2.engine == "distributed"


def test_two_phase_distributed_refuses_other_inner_engines():
    g = rt.Graph(rt.graphs.laplace3d(4), device="cpu")
    with pytest.raises(ValueError, match="distributed MIS-2"):
        rt.coarsen(g, method="two_phase_distributed",
                   mis2_engine="cuda_resident", backend=CPU)


def test_collective_model():
    two = core_dist.collective_bytes_per_iteration(1000, 8)
    single = core_dist.collective_bytes_per_iteration(1000, 8, True)
    assert two["result_bytes_per_iteration"] == 2 * 4000
    assert two["wire_bytes_per_device_per_iteration"] == pytest.approx(
        2 * 4000 * 7 / 8)
    assert single["result_bytes_per_iteration"] == 4000
    padded = core_dist.collective_bytes_per_iteration(1022, 8)
    assert padded["result_bytes_per_iteration"] == 2 * 4096
    ref = importlib.import_module(
        "repro.core.dist").collective_bytes_per_iteration
    for v, p, sg in ((1000, 8, False), (1022, 4, True), (997, 3, False)):
        assert core_dist.collective_bytes_per_iteration(v, p, sg) == \
            ref(v, p, single_gather=sg)


def test_padding_adds_isolated_inactive_rows():
    ell = rt.Graph(rt.graphs.laplace3d(3), device="cpu").ell
    padded, v = core_dist.pad_graph_for_mesh(ell, 4)
    assert v == 27 and padded.num_vertices == 28
    assert padded.neighbors[27].tolist() == [27] * ell.width
    assert not padded.mask[27].any()
    same, _ = core_dist.pad_graph_for_mesh(ell, 3)
    assert same is ell
