"""The batched coarsening's label joins on the join kernels' wrappers
(``batch/pipeline.py:_coarsen_bucket``): each bucket runs one
``root_join`` (with the Alg. 2 cleanup for ``basic``), one
``phase2_join`` and one ``phase3_fixed_point`` (``two_phase``) over its
block-diagonal ELL, and every member equals the JAX package's
``coarsen_batch`` and the port's single-graph ``coarsen``: labels, roots,
phase marks, aggregates, iterations and ``converged``.

The fleet has padded buckets (laplace3d(5) and a union of cliques in
``[128, 8]``, a path and random graphs), a member that phase 1 labels
whole (the cliques: nothing left for phase 2), and is run at
``min_secondary_neighbors`` 1, 2 and 3.  On the CPU the wrappers run the
kernels' twins; the card case holds the kernels against the twins on the
states a padded bucket reaches (the module imports the JAX package only
inside the reference calls, so that the card case runs where torch alone
is installed: ``pytest --noconftest -m gpu tests/test_torch_batch_joins.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.batch import pipeline
from repro_torch.kernels.joins import ops as join_ops
from repro_torch.kernels.joins import ref as join_ref

CPU = rt.Backend(device="cpu")

#: ``K`` disjoint ``C``-cliques (self loops included): MIS-2 takes one root
#: a clique, whose neighbours are the whole clique
CLIQUES = (25, 5)
FLEET = [
    ("laplace3d", (5,)), ("cliques", CLIQUES), ("path", (100,)),
    ("random", (300, 4.0, 3)), ("laplace3d", (6,)),
    ("random", (200, 5.0, 11)), ("random", (120, 3.0, 2)),
]
CASES = [("two_phase", 1), ("two_phase", 2), ("two_phase", 3),
         ("basic", 2)]


def _cliques(k: int, c: int) -> tuple:
    base = np.arange(k)[:, None, None] * c
    i = (base + np.arange(c)[None, :, None] + 0 * np.arange(c)).ravel()
    j = (base + 0 * np.arange(c)[:, None] + np.arange(c)).ravel()
    return i, j, k * c


def _structure(gen, csr_from_coo, kind: str, args: tuple):
    """A fleet member from the port's or the reference's generators (equal
    CSR arrays)."""
    if kind == "laplace3d":
        return gen.laplace3d(*args).graph
    if kind == "path":
        return gen.path_graph(*args)
    if kind == "cliques":
        return csr_from_coo(*_cliques(*args))
    n, deg, seed = args
    return gen.random_uniform_graph(n, deg, seed=seed)


def port_fleet(device="cpu") -> list:
    return [rt.Graph(_structure(rt.graphs, rt.graphs.csr_from_coo, k, a),
                     device=device) for k, a in FLEET]


@functools.lru_cache(maxsize=None)
def ref_batch(method: str, min_secondary: int):
    import repro
    from repro.graphs import csr as ref_csr
    from repro.graphs import generators as ref_gen

    fleet = [repro.Graph(_structure(ref_gen, ref_csr.csr_from_coo, k, a))
             for k, a in FLEET]
    return repro.coarsen_batch(fleet, method=method,
                               min_secondary_neighbors=min_secondary)


@pytest.fixture(scope="module")
def batch():
    return rt.GraphBatch(port_fleet())


def _spy(monkeypatch) -> list:
    """Record each join wrapper call of the pipeline: ``(name, kwargs)``."""
    seen = []
    for name in ("root_join", "cleanup_join", "phase2_join",
                 "phase3_fixed_point"):
        inner = getattr(join_ops, name)

        def call(*args, _name=name, _inner=inner, **kw):
            seen.append((_name, kw))
            return _inner(*args, **kw)

        monkeypatch.setattr(join_ops, name, call)
    return seen


def test_fleet_has_padding_and_a_member_done_in_phase_1(batch):
    padded = [b for b in batch.buckets
              if (b.num_vertices < b.rows).any() and b.size > 1]
    assert padded, batch.bucket_shapes
    want = ref_batch("two_phase", 2)[1]
    assert (want.phase == 1).all() and want.num_aggregates == CLIQUES[0]


@pytest.mark.parametrize("method,min_secondary", CASES)
def test_members_equal_reference_and_single(batch, method, min_secondary):
    got = rt.coarsen_batch(batch, method=method,
                           min_secondary_neighbors=min_secondary,
                           backend=CPU)
    want = ref_batch(method, min_secondary)
    assert got.bucket_shapes == want.bucket_shapes
    assert got.engine == f"{method}_batched"
    for g, r, w in zip(batch.graphs, got, want):
        single = rt.coarsen(g, method=method,
                            min_secondary_neighbors=min_secondary,
                            backend=CPU)
        for other in (w, single):
            assert (r.digest, r.num_aggregates, r.iterations,
                    r.converged) == (other.digest, other.num_aggregates,
                                     other.iterations, other.converged)
            assert np.array_equal(r.labels, other.labels)
            assert np.array_equal(r.roots, other.roots)
            assert np.array_equal(r.phase, other.phase)


@pytest.mark.parametrize("method", ["two_phase", "basic"])
def test_one_launch_of_each_join_a_bucket(monkeypatch, batch, method):
    seen = _spy(monkeypatch)
    solves = []
    inner = pipeline._fixed_point

    def fixed_point(bucket, active, options):
        solves.append(bucket.shape)
        return inner(bucket, active, options)

    monkeypatch.setattr(pipeline, "_fixed_point", fixed_point)
    rt.coarsen_batch(batch, method=method, backend=CPU)
    nb = batch.num_buckets
    names = [name for name, _ in seen]
    if method == "two_phase":
        assert len(solves) == 2 * nb
        assert names == ["root_join", "phase2_join",
                         "phase3_fixed_point"] * nb
        assert all(kw.get("cleanup_rounds") == 0 for name, kw in seen
                   if name == "root_join")
    else:
        assert len(solves) == nb
        assert names == ["root_join"] * nb
        assert all(kw["cleanup_rounds"] == join_ref.JOIN_ROUNDS
                   for _, kw in seen)


def test_pipeline_has_no_rowwise_joins():
    import inspect

    src = inspect.getsource(pipeline._coarsen_bucket)
    for name in ("join_rows", "count_unagg", "_member_root_labels",
                 "cleanup_join"):
        assert name not in src
    assert not hasattr(pipeline, "_member_root_labels")


def test_bucket_of_one_member_equals_its_fleet_bucket(batch):
    """A member's result does not depend on its bucket mates (the ids of
    the members before it shift its own only by their counts)."""
    full = rt.coarsen_batch(batch, method="two_phase", backend=CPU)
    for i in (1, 4, 6):
        solo = rt.coarsen_batch([batch.graphs[i]], method="two_phase",
                                backend=CPU)
        assert solo[0].digest == full[i].digest
        assert np.array_equal(solo[0].phase, full[i].phase)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["two_phase", "basic"])
def test_join_kernels_match_twins_on_padded_bucket(monkeypatch, cuda_device,
                                                   method):
    """On the card: each join of a padded bucket's coarsening against its
    twin on the same inputs, every output bitwise, one launch a call."""
    fleet = port_fleet(cuda_device)
    calls = []
    for name in ("root_join", "phase2_join", "phase3_fixed_point"):
        inner = getattr(join_ops, name)

        def call(*args, _name=name, _inner=inner, **kw):
            calls.append((_name, tuple(a.clone() if torch.is_tensor(a)
                                       else a for a in args), kw))
            return _inner(*args, **kw)

        monkeypatch.setattr(join_ops, name, call)
    got = rt.coarsen_batch(fleet, method=method)
    monkeypatch.undo()
    for g, r in zip(fleet, got):
        single = rt.coarsen(g, method=method)
        assert (r.digest, r.num_aggregates, r.iterations) == (
            single.digest, single.num_aggregates, single.iterations)
        assert np.array_equal(r.phase, single.phase)
    assert calls
    for name, args, kw in calls:
        before = join_ops.LAUNCHES[name]
        out = getattr(join_ops, name)(*args, **kw)
        twin = getattr(join_ref, name + "_ref")(*args, **kw)
        torch.cuda.synchronize()
        assert join_ops.LAUNCHES[name] == before + 1
        assert all(torch.equal(x, y) for x, y in zip(out, twin)), name
