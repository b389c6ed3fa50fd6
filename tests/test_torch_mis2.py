"""MIS-2 of the port (``dense`` and ``cuda_resident`` on the CPU, where the
kernels' twins stand in) against the JAX package: equal digests, sizes and
iteration counts."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.mis2 import compact_worklist

from _torch_common import (
    CPU,
    GRAPHS,
    active_mask,
    port_graph,
    ref_mis2,
)

ENGINES = ["dense", "cuda_resident"]


def _same(r, ref):
    assert (r.digest, r.size, r.iterations, r.converged) == (
        ref.digest, ref.size, ref.iterations, ref.converged)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_mis2_digest_matches_reference(name, engine):
    r = rt.mis2(port_graph(name), engine=engine, backend=CPU)
    _same(r, ref_mis2(name))
    assert r.engine == engine


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("priority", ["xorshift", "fixed"])
def test_mis2_priorities_match_reference(priority, engine):
    r = rt.mis2(port_graph("laplace3d(8)"), engine=engine, backend=CPU,
                options=rt.Mis2Options(priority=priority))
    _same(r, ref_mis2("laplace3d(8)", priority))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["uniform(2000,6)", "elasticity3d(4)"])
def test_mis2_active_mask_matches_reference(name, engine):
    active = active_mask(name, seed=3)
    r = rt.mis2(port_graph(name), active=active, engine=engine, backend=CPU)
    _same(r, ref_mis2(name, active_seed=3))
    assert not (r.in_set & ~active).any()


@pytest.mark.parametrize("engine", ENGINES)
def test_mis2_max_iters_cut_matches_reference(engine):
    r = rt.mis2(port_graph("laplace3d(12)"), engine=engine, backend=CPU,
                options=rt.Mis2Options(max_iters=2))
    ref = ref_mis2("laplace3d(12)", max_iters=2)
    _same(r, ref)
    assert not r.converged and r.iterations == 2


def test_default_engine_is_cuda_resident_with_one_sync_per_round():
    r = rt.mis2(port_graph("laplace3d(8)"), backend=CPU)
    assert r.engine == "cuda_resident"
    assert r.host_syncs == r.iterations + 1
    assert rt.mis2(port_graph("laplace3d(8)"), engine="dense",
                   backend=CPU).host_syncs == r.iterations + 1


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_compact_worklist_is_flatnonzero_with_sentinels(frac):
    mask = np.random.default_rng(1).random(257) < frac
    wl, count = compact_worklist(torch.from_numpy(mask))
    live = np.flatnonzero(mask)
    assert wl.dtype == torch.int32 and count.tolist() == [len(live)]
    np.testing.assert_array_equal(wl[:len(live)].numpy(), live)
    assert (wl[len(live):] == 257).all()


def test_bad_options_and_engine_raise():
    with pytest.raises(ValueError, match="priority"):
        rt.Mis2Options(priority="lcg")
    with pytest.raises(ValueError, match="engine"):
        rt.mis2(port_graph("laplace3d(8)"), engine="pallas_dense",
                backend=CPU)
    with pytest.raises(ValueError, match="active"):
        rt.mis2(port_graph("laplace3d(8)"), active=np.ones(3, bool),
                backend=CPU)


EMPTY_RAISES = ["dense", "compacted", "cuda_compacted", "compacted_resident",
                "cuda_resident", "distributed", "distributed_single_gather"]
EMPTY_ANSWERS = ["cuda_hybrid", "dense_batched"]


def _empty_graph():
    none = np.array([], dtype=np.int64)
    return rt.Graph.from_coo(none, none, 3, device="cpu")


@pytest.mark.parametrize("engine", EMPTY_RAISES)
def test_graph_with_no_entries_raises_value_error(engine):
    """A graph with no entries has no closed neighbourhood to take the min
    over: ``ValueError``, as the reference's engines raise (numpy's min
    over a zero-size array)."""
    with pytest.raises(ValueError, match="no entries"):
        rt.mis2(_empty_graph(), engine=engine, backend=CPU)
    if engine in ("compacted", "compacted_resident"):   # the COO layout
        with pytest.raises(ValueError, match="no entries"):
            rt.mis2(_empty_graph(), engine=engine, backend=CPU,
                    options=rt.Mis2Options(layout="csr_segment"))


@pytest.mark.parametrize("engine", EMPTY_ANSWERS)
def test_graph_with_no_entries_is_answered_where_the_reference_answers(
        engine):
    """The reference's ``pallas_hybrid`` and ``dense_batched`` answer (each
    isolated vertex IN); so do their counterparts."""
    import repro

    none = np.array([], dtype=np.int64)
    want = repro.mis2(repro.Graph.from_coo(none, none, 3),
                      engine="pallas_hybrid" if engine == "cuda_hybrid"
                      else engine)
    r = rt.mis2(_empty_graph(), engine=engine, backend=CPU)
    assert r.digest == want.digest and r.payload.all()
