"""The batched fixed points of the port as one call each (one cooperative
launch a bucket on the card), held on the CPU, where each call runs its
plain-torch twin, against the JAX package:

* ``ops.resident_fixed_point_batched`` (the batched MIS-2) against the
  reference's vmapped ``_mis2_bucket_run``, bucket by bucket: T and each
  member's rounds, with and without an active mask, capped at 1, 2 and 6
  rounds (a member stopped by the cap while its mates finish earlier) and
  uncapped;
* ``luby_ops.luby_fixed_point_batched`` against the reference's
  ``_color_batch_impl``: each member's colors and rounds (its done round,
  or the bucket's rounds where it did not finish), at 1, 2, 6 rounds and
  uncapped;
* ``ops.resident_fixed_point_seeded`` (the streaming repair) against the
  reference's ``mis2_repair_fixed_point`` from a seeded T: T and rounds.

The kernels themselves are held against the twins on the card in
``test_torch_cuda.py``."""
from __future__ import annotations

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.batch import pipeline as ref_pipeline
from repro.graphs import generators as ref_gen
from repro_torch.core.tuples import id_bits
from repro_torch.kernels.luby import ops as luby_ops
from repro_torch.kernels.minprop_ell import ops

from _torch_common import HYBRID_GRAPHS, port_hybrid_graph, ref_hybrid_graph

ref_mis2 = importlib.import_module("repro.core.mis2")

#: three buckets of one, two and three members: laplace3d(3) (32 x 8), two
#: laplace3d(5) (128 x 8) and three random graphs (256 x 16)
FLEET = [("laplace3d", (3,)), ("random", (220, 4.0, 1)), ("laplace3d", (5,)),
         ("random", (240, 5.0, 2)), ("random", (200, 3.0, 3)),
         ("laplace3d", (5,))]
CAPS = [1, 2, 6, 128]


def _structure(kind: str, args: tuple):
    if kind == "laplace3d":
        return ref_gen.laplace3d(*args).graph
    n, deg, seed = args
    return ref_gen.random_uniform_graph(n, deg, seed=seed)


@functools.lru_cache(maxsize=None)
def ref_batch():
    return repro.GraphBatch([repro.Graph(_structure(k, a)) for k, a in FLEET])


@functools.lru_cache(maxsize=None)
def port_batch():
    return rt.GraphBatch([
        rt.Graph.from_reference(g.csr.indptr, g.csr.indices, device="cpu")
        for g in ref_batch().graphs])


def _actives(masked: bool) -> list:
    """Each member's active mask (None: every vertex)."""
    rng = np.random.default_rng(5)
    return [rng.random(g.num_vertices) < 0.7 if masked else None
            for g in ref_batch().graphs]


@functools.lru_cache(maxsize=None)
def ref_mis2_bucket(i: int, masked: bool, max_iters: int):
    bucket = ref_batch().buckets[i]
    act = ref_pipeline._bucket_actives(bucket, _actives(masked))
    t, its = ref_pipeline._mis2_bucket_run(bucket.neighbors, act,
                                           bucket.id_bits, "xorshift_star",
                                           max_iters)
    return np.asarray(act), np.asarray(t), np.asarray(its)


def test_fleet_buckets_equal_the_references():
    assert port_batch().bucket_shapes == ref_batch().bucket_shapes
    assert [b.size for b in port_batch().buckets] == [1, 2, 3]


@pytest.mark.parametrize("max_iters", CAPS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("i", [0, 1, 2])
def test_batched_mis2_twin_matches_reference(i, masked, max_iters):
    act, t_ref, its_ref = ref_mis2_bucket(i, masked, max_iters)
    bucket = port_batch().buckets[i]
    n = bucket.size * bucket.rows
    t, stats, its = ops.resident_fixed_point_batched(
        torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32),
        torch.from_numpy(act.reshape(-1).copy()),
        bucket.flat_neighbors32.view(-1),
        priority="xorshift_star", bits=bucket.id_bits, rows=bucket.rows,
        max_iters=max_iters)
    np.testing.assert_array_equal(
        t.numpy().view(np.uint32).reshape(bucket.size, bucket.rows), t_ref)
    np.testing.assert_array_equal(its.numpy(), its_ref)
    assert stats.tolist()[0] == its_ref.max()


def test_a_capped_member_stops_while_its_mates_finish():
    """At 6 rounds the random bucket holds a member the cap stopped beside
    mates that finished earlier (the twin is held to both above)."""
    act, t_ref, its_ref = ref_mis2_bucket(2, False, 6)
    live = [bool(((t_ref[j] != 0) & (t_ref[j] != 0xFFFFFFFF)
                  & act[j]).any()) for j in range(len(its_ref))]
    assert any(live) and not all(live)
    assert min(its_ref) < 6 == max(its_ref)


@functools.lru_cache(maxsize=None)
def ref_colors(max_rounds: int):
    return ref_pipeline._color_batch_impl(ref_batch(), max_rounds)


@pytest.mark.parametrize("max_rounds", CAPS)
@pytest.mark.parametrize("i", [0, 1, 2])
def test_batched_luby_twin_matches_reference(i, max_rounds):
    want = ref_colors(max_rounds)
    bucket = port_batch().buckets[i]
    n = bucket.size * bucket.rows
    colors, done, rounds = luby_ops.luby_fixed_point_batched(
        bucket.flat_neighbors32, bucket.mask.view(n, bucket.width),
        bucket.row_valid.view(-1), bucket.id_bits, bucket.rows,
        max_rounds=max_rounds)
    c = colors.view(bucket.size, bucket.rows).numpy()
    for j, gi in enumerate(bucket.indices):
        v = int(bucket.num_vertices[j])
        np.testing.assert_array_equal(c[j, :v], want[gi].colors)
        assert (c[j, v:] == 0).all()                 # padding stays 0
        if want[gi].converged:
            assert int(done[j]) == want[gi].rounds
        else:
            assert int(done[j]) == -1 and int(rounds) == want[gi].rounds
    assert int(rounds) <= max(max_rounds, 1)


def test_batched_luby_capped_fleet_leaves_members_unfinished():
    done = ref_colors(6)
    assert {r.converged for r in done} == {True, False}


@pytest.mark.parametrize("max_iters", [1, 128])
@pytest.mark.parametrize("name", list(HYBRID_GRAPHS))
def test_seeded_twin_matches_reference_repair(name, max_iters):
    """Freeze the fixed-priority solution, reseed a random region with the
    undecided 1, and repair: the same T and rounds."""
    ref_nb = ref_hybrid_graph(name).ell.neighbors
    nb = port_hybrid_graph(name).ell.neighbors
    v = nb.shape[0]
    b = id_bits(v)
    base, _ = ref_mis2.mis2_repair_fixed_point(ref_nb, jnp.ones(v, jnp.uint32),
                                               jnp.uint32(b))
    region = np.random.default_rng(17).random(v) < 0.3
    seed = np.where(region, np.uint32(1), np.asarray(base)).astype(np.uint32)
    t_ref, it_ref = ref_mis2.mis2_repair_fixed_point(
        ref_nb, jnp.asarray(seed), jnp.uint32(b), max_iters=max_iters)
    t, stats = ops.resident_fixed_point_seeded(
        torch.from_numpy(seed.view(np.int32).copy()),
        torch.empty(v, dtype=torch.int32), nb.reshape(-1), priority="fixed",
        b=b, max_iters=max_iters)
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  np.asarray(t_ref))
    assert stats.tolist()[0] == int(it_ref)


def test_batched_and_seeded_wrappers_check_their_arguments():
    bucket = port_batch().buckets[1]
    n = bucket.size * bucket.rows
    state = dict(t=torch.empty(n, dtype=torch.int32),
                 m=torch.empty(n, dtype=torch.int32),
                 active=bucket.row_valid.view(-1),
                 nbrs_flat=bucket.flat_neighbors32.view(-1))
    kw = dict(priority="xorshift_star", bits=bucket.id_bits,
              rows=bucket.rows, max_iters=4)
    with pytest.raises(ValueError, match="power of two"):
        ops.resident_fixed_point_batched(**state, **{**kw, "rows": 3})
    with pytest.raises(TypeError, match="bits"):
        ops.resident_fixed_point_batched(
            **state, **{**kw, "bits": bucket.id_bits.long()})
    with pytest.raises(ValueError, match="members"):
        ops.resident_fixed_point_batched(
            **state, **{**kw, "rows": bucket.rows // 2})
    with pytest.raises(ValueError, match="negative"):
        ops.resident_fixed_point_batched(**state, **{**kw, "max_iters": -1})
    with pytest.raises(ValueError, match="members"):
        luby_ops.luby_fixed_point_batched(
            bucket.flat_neighbors32, bucket.mask.view(n, bucket.width),
            bucket.row_valid.view(-1), bucket.id_bits, bucket.rows * 2,
            max_rounds=4)
    with pytest.raises(TypeError, match="int32"):
        ops.resident_fixed_point_seeded(
            state["t"].long(), state["m"], state["nbrs_flat"],
            priority="fixed", b=9, max_iters=4)
