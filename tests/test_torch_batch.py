"""The port's batched pipelines (``rt.mis2_batch`` / ``color_batch`` /
``coarsen_batch`` / ``amg_setup_batch``, the ``dense_batched`` engine,
``GraphBatch``) against the JAX package's batched calls and the port's own
single-graph calls, on the CPU, on the reference test's ``mixed_graphs()``
fleet (``tests/test_batch.py``): equal digests, iterations or rounds,
``converged``, roots, phases and bucket shapes; and the batched coloring's
round priorities (the twin of the batched hash-pack kernel) against the
reference's per-member ``_round_priorities``.  The kernel itself is held
against the twin on the card in ``test_torch_cuda.py``."""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import coloring as ref_coloring
from repro.graphs import generators as ref_gen
from repro.graphs.csr import CSRGraph as RefCSRGraph
import repro_torch as rt
from repro_torch.batch import GraphBatch, bucket_shape
from repro_torch.core.tuples import id_bits
from repro_torch.kernels.hash_priority import ops as hash_ops
from repro_torch.kernels.luby import ops as luby_ops

from _torch_common import CPU

#: ``tests/test_batch.py``'s ``mixed_graphs()``: laplace3d and random
#: graphs of 64-1,200 vertices spanning several buckets
FLEET = [
    ("laplace3d", (5,)), ("laplace3d", (6,)), ("laplace3d", (8,)),
    ("random_uniform_graph", (300, 4.0, 3)),
    ("random_uniform_graph", (500, 5.0, 1)),
    ("random_uniform_graph", (800, 6.0, 5)),
    ("random_uniform_graph", (1200, 6.0, 7)),
    ("laplace3d", (4,)),
]
PRIORITIES = ["fixed", "xorshift", "xorshift_star"]
#: the reference test's matrices and levels (tests/test_multilevel.py)
LEVEL_KW = dict(coarse_size=24, max_levels=6)


def _ref_structure(fn: str, args: tuple):
    if fn == "laplace3d":
        return ref_gen.laplace3d(*args).graph
    n, deg, seed = args
    return ref_gen.random_uniform_graph(n, deg, seed=seed)


@functools.lru_cache(maxsize=None)
def ref_fleet() -> tuple:
    return tuple(repro.Graph(_ref_structure(fn, args)) for fn, args in FLEET)


def port_fleet() -> list:
    """The port's graphs of the same CSR (equal ``digest``), on the CPU."""
    return [rt.Graph.from_reference(g.csr.indptr, g.csr.indices,
                                    device="cpu") for g in ref_fleet()]


@functools.lru_cache(maxsize=None)
def ref_batch(kind: str, arg=None, max_iters: int = 128):
    """The reference's batched call on the fleet, cached for the module:
    ``kind`` is ``mis2`` (``arg`` the priority), ``color`` (``arg`` the
    round limit) or ``coarsen`` (``arg`` the method)."""
    if kind == "mis2":
        return repro.mis2_batch(list(ref_fleet()), options=repro.Mis2Options(
            priority=arg, max_iters=max_iters))
    if kind == "color":
        return repro.color_batch(list(ref_fleet()), max_rounds=arg)
    return repro.coarsen_batch(list(ref_fleet()), method=arg)


@pytest.fixture(scope="module")
def fleet():
    return port_fleet()


@pytest.fixture(scope="module")
def batch(fleet):
    return GraphBatch(fleet)


def _mis2_key(r):
    return r.digest, r.iterations, r.converged


def test_fleet_digests_and_buckets_equal_reference(fleet, batch):
    assert [g.digest for g in fleet] == [g.digest for g in ref_fleet()]
    ref_shapes = repro.GraphBatch(list(ref_fleet())).bucket_shapes
    assert batch.bucket_shapes == ref_shapes and batch.num_buckets >= 2
    for rows, width, _ in batch.bucket_shapes:
        assert rows & (rows - 1) == 0 and width & (width - 1) == 0


@pytest.mark.parametrize("priority", PRIORITIES)
def test_mis2_batch_matches_reference_and_single(fleet, batch, priority):
    opts = rt.Mis2Options(priority=priority)
    br = rt.mis2_batch(batch, options=opts, backend=CPU)
    ref = ref_batch("mis2", priority)
    assert br.engine == "dense_batched" and len(br) == len(fleet)
    assert br.bucket_shapes == ref.bucket_shapes
    for g, r, want in zip(fleet, br, ref):
        single = rt.mis2(g, options=opts, engine="dense", backend=CPU)
        assert _mis2_key(r) == _mis2_key(want) == _mis2_key(single)
        assert r.converged and r.engine == "dense_batched"


def test_mis2_batch_capped_member_keeps_its_state(fleet, batch):
    """max_iters = 5: the members that need more rounds stop unconverged
    at 5 while their bucket mates finish earlier, each as the reference's
    vmapped loop and the single-graph call leave it."""
    opts = rt.Mis2Options(max_iters=5)
    br = rt.mis2_batch(batch, options=opts, backend=CPU)
    ref = ref_batch("mis2", "xorshift_star", max_iters=5)
    assert {r.converged for r in br} == {True, False}
    for g, r, want in zip(fleet, br, ref):
        single = rt.mis2(g, options=opts, engine="dense", backend=CPU)
        assert _mis2_key(r) == _mis2_key(want) == _mis2_key(single)


@pytest.mark.parametrize("max_rounds", [256, 9])
def test_color_batch_matches_reference_and_single(fleet, batch, max_rounds):
    cb = rt.color_batch(batch, max_rounds=max_rounds, backend=CPU)
    ref = ref_batch("color", max_rounds)
    assert cb.engine == "luby_batched"
    if max_rounds == 9:
        assert {r.converged for r in cb} == {True, False}
    for g, r, want in zip(fleet, cb, ref):
        single = rt.color(g, max_rounds=max_rounds, backend=CPU)
        key = (r.digest, r.rounds, r.num_colors, r.converged)
        assert key == (want.digest, want.rounds, want.num_colors,
                       want.converged)
        assert key == (single.digest, single.rounds, single.num_colors,
                       single.converged)


@pytest.mark.parametrize("method", ["two_phase", "basic", "serial"])
def test_coarsen_batch_matches_reference_and_single(fleet, batch, method):
    ab = rt.coarsen_batch(batch, method=method, backend=CPU)
    ref = ref_batch("coarsen", method)
    assert ab.engine == f"{method}_batched"
    assert ab.bucket_shapes == ref.bucket_shapes
    for g, r, want in zip(fleet, ab, ref):
        single = rt.coarsen(g, method=method, backend=CPU)
        for other in (want, single):
            assert (r.digest, r.num_aggregates, r.iterations,
                    r.converged) == (other.digest, other.num_aggregates,
                                     other.iterations, other.converged)
            assert (r.roots == other.roots).all()
            assert (r.phase == other.phase).all()


def test_batch_invariant_to_composition(fleet):
    full = rt.mis2_batch(fleet, backend=CPU)
    small = rt.mis2_batch([fleet[6], fleet[0], fleet[3]], backend=CPU)
    solo = rt.mis2_batch([fleet[6]], backend=CPU)
    assert small.digests == [full[6].digest, full[0].digest, full[3].digest]
    assert solo[0].digest == full[6].digest
    colors = rt.color_batch([fleet[5], fleet[1]], backend=CPU)
    assert colors.digests == [rt.color(fleet[5], backend=CPU).digest,
                              rt.color(fleet[1], backend=CPU).digest]


def test_dense_batched_engine_with_active_mask():
    assert "dense_batched" in rt.list_engines("mis2")["mis2"]
    ref_g = repro.Graph(ref_gen.laplace3d(6).graph)
    g = rt.Graph.from_reference(ref_g.csr.indptr, ref_g.csr.indices,
                                device="cpu")
    active = np.arange(g.num_vertices) % 3 != 0
    r = rt.mis2(g, active=active, engine="dense_batched", backend=CPU)
    want = repro.mis2(ref_g, active=active, engine="dense_batched")
    single = rt.mis2(g, active=active, engine="dense", backend=CPU)
    assert _mis2_key(r) == _mis2_key(want) == _mis2_key(single)
    assert r.engine == "dense_batched"
    with pytest.raises(ValueError, match="active"):
        rt.mis2(g, active=active[:-1], engine="dense_batched", backend=CPU)


def test_graph_with_no_entries_answered_as_the_reference():
    """A 3-vertex graph with no entries: the single-graph engines raise in
    both packages, the batched path (bucket width ``max(1, 0)``) answers."""
    indptr, indices = np.zeros(4, np.int32), np.zeros(0, np.int32)
    ref_g = repro.Graph(RefCSRGraph(jnp.asarray(indptr),
                                    jnp.asarray(indices)))
    g = rt.Graph.from_reference(indptr, indices, device="cpu")
    assert bucket_shape(g) == (4, 1)
    r = rt.mis2_batch([g], backend=CPU)[0]
    want = repro.mis2_batch([ref_g])[0]
    assert _mis2_key(r) == _mis2_key(want) and r.size == 3
    assert _mis2_key(rt.mis2(g, engine="dense_batched", backend=CPU)) == \
        _mis2_key(want)
    c = rt.color_batch([g], backend=CPU)[0]
    cw = repro.color_batch([ref_g])[0]
    assert (c.digest, c.rounds, c.num_colors) == (cw.digest, cw.rounds,
                                                  cw.num_colors)


@functools.lru_cache(maxsize=None)
def ref_matrices() -> tuple:
    return (repro.Graph(ref_gen.laplace3d(8)),
            repro.Graph(ref_gen.er_laplacian(600, 6.0, seed=3)))


@functools.lru_cache(maxsize=None)
def ref_amg_batch() -> list:
    batch = repro.amg_setup_batch(list(ref_matrices()), engine="host",
                                  **LEVEL_KW)
    return [(r.level_digests, r.level_sizes) for r in batch]


@pytest.mark.parametrize("engine", ["host", "resident"])
def test_amg_setup_batch_matches_reference_and_single(engine):
    mats = [rt.Graph.from_reference(m.csr_matrix.indptr, m.csr_matrix.indices,
                                    m.csr_matrix.values, device="cpu")
            for m in ref_matrices()]
    batch = rt.amg_setup_batch(mats, engine=engine, backend=CPU, **LEVEL_KW)
    assert batch.engine == f"{engine}_batched" and len(batch) == 2
    for m, got, want in zip(mats, batch, ref_amg_batch()):
        single = rt.amg_setup(m, engine=engine, backend=CPU, **LEVEL_KW)
        assert (got.level_digests, got.level_sizes) == want
        assert (single.level_digests, single.level_sizes) == want
        assert got.dispatches == single.dispatches
        assert got.provenance is batch.provenance


def test_amg_setup_batch_default_engine_on_the_cpu():
    m = rt.Graph(rt.graphs.laplace3d(6), device="cpu")
    r = rt.amg_setup_batch([m], backend=CPU, **LEVEL_KW)
    assert r.engine == "host_batched" and r[0].engine == "host"


@pytest.mark.parametrize("rows,bits", [(1, [2, 9]), (4, [3]),
                                       (128, [8, 1, 31]), (512, [10, 10])])
@pytest.mark.parametrize("rnd", [0, 7, 2**31 - 1])
def test_round_priorities_batched_twin_equals_reference(rows, bits, rnd):
    it = torch.tensor([rnd], dtype=torch.int32)
    before = dict(hash_ops.LAUNCHES)
    got = hash_ops.round_priorities_batched(
        rows, it, torch.tensor(bits, dtype=torch.int32))
    assert hash_ops.LAUNCHES == before          # the twin launches nothing
    assert got.dtype == torch.int64 and got.shape == (rows * len(bits),)
    want = np.concatenate([np.asarray(ref_coloring._round_priorities(
        rows, jnp.uint32(rnd), jnp.uint32(b))) for b in bits])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_round_priorities_batched_validates_arguments():
    it = torch.zeros(1, dtype=torch.int32)
    bits = torch.tensor([5, 6], dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        hash_ops.round_priorities_batched(6, it, bits)
    with pytest.raises(TypeError, match="bits"):
        hash_ops.round_priorities_batched(8, it, bits.long())
    with pytest.raises(ValueError, match="one element"):
        hash_ops.round_priorities_batched(8, torch.zeros(2, dtype=torch.int32),
                                          bits)
    with pytest.raises(ValueError, match="out of range"):
        hash_ops.round_priorities_batched(
            2**30, it, torch.tensor([5, 6], dtype=torch.int32))


def test_one_batched_priorities_call_a_luby_round(monkeypatch, fleet):
    """The batched coloring is one ``luby_fixed_point_batched`` call a
    bucket (one launch on the card); on the CPU its twin takes one batched
    priorities call a round, each with the bucket's member bits."""
    loops, calls = [], []
    real_loop = luby_ops.luby_fixed_point_batched
    real = hash_ops.round_priorities_batched
    monkeypatch.setattr(luby_ops, "luby_fixed_point_batched",
                        lambda *a, **k: loops.append(a) or real_loop(*a, **k))
    monkeypatch.setattr(hash_ops, "round_priorities_batched",
                        lambda *a: calls.append(a) or real(*a))
    batch = GraphBatch(fleet[:3])             # one member a bucket
    cb = rt.color_batch(batch, backend=CPU)
    assert batch.num_buckets == 3
    assert [a[4] for a in loops] == [b.rows for b in batch.buckets]
    assert len(calls) == sum(r.rounds for r in cb)
    for bucket in batch.buckets:
        (gi,) = bucket.indices
        mine = [bits for rows, _, bits in calls if rows == bucket.rows]
        assert len(mine) == cb[gi].rounds
        assert all(bits.tolist() == [id_bits(fleet[gi].num_vertices)]
                   for bits in mine)


def test_container_caches_and_coerces(fleet):
    g = fleet[0]
    shape = bucket_shape(g)
    assert shape == (128, 8)                  # V = 125, max degree 7
    GraphBatch([g])
    count = g.conversions["pad_ell"]
    b = GraphBatch([g])                      # re-batching hits the cache
    assert g.conversions["pad_ell"] == count
    assert GraphBatch(b).buckets is b.buckets
    assert rt.as_graph_batch(b) is b
    bare = rt.mis2_batch([rt.graphs.laplace3d(3).graph], backend=CPU)
    assert len(bare) == 1 and bare[0].converged    # a container coerces
    with pytest.raises(ValueError, match="at least one"):
        GraphBatch([])
    stats = GraphBatch(fleet).stats()
    assert stats["num_graphs"] == len(fleet) and stats["padding_ratio"] > 1
    with pytest.raises(ValueError, match="two_phase"):
        rt.coarsen_batch(fleet, method="nope", backend=CPU)


def test_batch_result_protocol_and_shared_provenance(batch):
    br = rt.mis2_batch(batch, backend=CPU)
    assert isinstance(br, rt.BatchResult)
    assert br.num_graphs == len(batch) and br.num_buckets == batch.num_buckets
    assert br.converged and br.wall_time_s > 0 and br.graphs_per_second > 0
    assert [r.digest for r in br] == br.digests
    assert type(br[0].payload) is np.ndarray
    p = br.provenance
    assert (p.kind, p.engine, p.backend) == ("mis2_batch", "dense_batched",
                                             "cpu")
    assert p.span["name"] == "api.mis2_batch"
    assert all(r.provenance is p for r in br)
    serial = rt.coarsen_batch(batch.graphs[:2], method="serial", backend=CPU)
    assert serial.bucket_shapes == [] and serial.engine == "serial_batched"
    assert serial[0].provenance is serial.provenance


def test_batch_entries_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = rt.Graph(rt.graphs.laplace3d(3))
    for entry in (rt.mis2_batch, rt.color_batch, rt.coarsen_batch,
                  rt.amg_setup_batch):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry([g])
    assert "csr_to_ell" not in g.conversions
