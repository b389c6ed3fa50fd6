"""``repro_torch.serve`` against the direct facade calls and the JAX
package's ``repro.serve`` (the reference's ``tests/test_serve.py`` and
``tests/test_serve_resilience.py``, adapted to the port and run on the CPU).

Every served response is held to the direct facade call's digest; a small
mixed stream is held to the reference ``Server``'s digests on the same
stream.  The policy pieces (admission with a manual clock, the batcher's
deadline-or-full rule, cache parity sampling, the persistent tier's atomic
commit, torn sweep and corrupt drop, exact fault counts, the digest
ledger) are the reference's tests on the port's copies.  The port's own
rule — a CUDA kernel's build or launch error is never degraded to a
fallback engine — has its tests at the end.
"""
from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch import obs
from repro_torch.graphs import er_laplacian, laplace3d, random_uniform_graph
from repro_torch.kernels._build import KernelBuildError, KernelLaunchError
from repro_torch.serve import (
    AdmissionController,
    Batcher,
    CacheParityError,
    DeadlineExceeded,
    DigestMismatch,
    EngineFailure,
    Fault,
    FaultPlan,
    InjectedFault,
    LayoutInfeasible,
    PendingRequest,
    QuotaConfig,
    QuotaExceeded,
    ResultCache,
    RetryPolicy,
    ServeError,
    Server,
    ServerClosed,
    ServerConfig,
    ServerOverloaded,
    StreamSession,
    TokenBucket,
    warm_buckets_for,
)
from repro_torch.serve.persist import PersistTier, entry_name

from _torch_common import CPU

Mis2Options = rt.Mis2Options


def G(structure):
    return rt.Graph(structure, device="cpu")


def srv_(**kw) -> Server:
    return Server(ServerConfig(backend=CPU, **kw))


def direct_mis2(g, **kw):
    return rt.mis2(g, backend=CPU, **kw)


def _graph(seed=0, n=80, deg=4.0):
    return G(random_uniform_graph(n, deg, seed=seed))


def _fleet():
    """Mixed-size workload: three bucket shapes, structure + matrix."""
    return [G(laplace3d(4)), G(laplace3d(5)),
            G(random_uniform_graph(200, 5.0, seed=1)),
            G(random_uniform_graph(150, 4.0, seed=2)),
            G(random_uniform_graph(60, 3.0, seed=3))]


@pytest.fixture(scope="module")
def fleet():
    return _fleet()


# ---------------------------------------------------------------------------
# served digest == direct facade digest
# ---------------------------------------------------------------------------

def test_served_mis2_digest_matches_facade_mixed_workload(fleet):
    srv = srv_(max_batch=4, warm_buckets=warm_buckets_for(fleet))
    futs = [srv.submit("mis2", g) for g in fleet]
    assert srv.flush() > 0
    for g, fut in zip(fleet, futs):
        served = fut.result()
        assert served.digest == direct_mis2(g).digest
        assert served.provenance.digest == served.digest
    assert srv.server_stats()["batched_graphs"] > 0


def test_served_color_coarsen_digest_matches_facade(fleet):
    srv = srv_(max_batch=4)
    color_futs = [srv.submit("color", g) for g in fleet]
    coarsen_futs = [srv.submit("coarsen", g) for g in fleet]
    srv.flush()
    for g, fut in zip(fleet, color_futs):
        r = fut.result()
        assert r.digest == rt.color(g, backend=CPU).digest
        assert r.provenance.digest == r.digest
    for g, fut in zip(fleet, coarsen_futs):
        r = fut.result()
        assert r.digest == rt.coarsen(g, backend=CPU).digest
        assert r.provenance.digest == r.digest


def test_served_amg_setup_digest_matches_facade():
    m = G(er_laplacian(300, 6.0, seed=4))
    srv = srv_()
    served = srv.request("amg_setup", m, coarse_size=50)
    direct = rt.amg_setup(G(er_laplacian(300, 6.0, seed=4)), coarse_size=50,
                          backend=CPU)
    assert served.digest == direct.digest
    assert served.level_digests == direct.level_digests


def test_single_fast_path_digest_matches_facade(fleet):
    g = fleet[2]
    srv = srv_(single_fast_path=True)
    served = srv.request("mis2", g)
    assert srv.server_stats()["single_dispatches"] == 1
    assert served.digest == direct_mis2(g).digest


def test_explicit_engine_honored_digest(fleet):
    g = fleet[0]
    srv = srv_()
    served = srv.request("mis2", g, engine="dense")
    assert served.engine == "dense"
    assert served.digest == direct_mis2(g, engine="dense").digest


def test_served_stream_matches_reference_server():
    """A small mixed stream through the port's server and the reference's:
    equal digests, request by request."""
    import repro
    import repro.serve as ref_serve
    from repro.graphs import generators as ref_gen

    specs = [("laplace3d", (5,), {}),
             ("random_uniform_graph", (120, 4.0), {"seed": 1}),
             ("random_uniform_graph", (90, 5.0), {"seed": 2})]
    kinds = ("mis2", "color", "coarsen")
    port = [G(getattr(rt.graphs, f)(*a, **k)) for f, a, k in specs]
    ref = [repro.Graph(getattr(ref_gen, f)(*a, **k)) for f, a, k in specs]
    p_srv = srv_(max_batch=4, cache_bytes=0)
    r_srv = ref_serve.Server(ref_serve.ServerConfig(max_batch=4,
                                                    cache_bytes=0))
    p_futs = [p_srv.submit(k, g) for k in kinds for g in port]
    r_futs = [r_srv.submit(k, g) for k in kinds for g in ref]
    p_srv.flush()
    r_srv.flush()
    got = [f.result().digest for f in p_futs]
    want = [f.result().digest for f in r_futs]
    assert got == want
    assert p_srv.server_stats()["fallbacks"] == 0


# ---------------------------------------------------------------------------
# cache: bitwise hits, parity assertions, byte-budget LRU
# ---------------------------------------------------------------------------

def test_cache_hit_returns_same_payload_bitwise(fleet):
    g = fleet[1]
    srv = srv_()
    first = srv.request("mis2", g)
    clone = G(laplace3d(5))         # same structure, same canonical digest
    fut = srv.submit("mis2", clone)
    assert fut.done(), "identical resubmission must hit the cache"
    hit = fut.result()
    assert hit.digest == first.digest
    assert hit.payload.tobytes() == first.payload.tobytes()
    stats = srv.server_stats()["cache"]
    assert stats["hits"] == 1 and stats["misses"] >= 1


def test_cache_parity_mode_recomputes_and_asserts(fleet):
    g = fleet[0]
    srv = srv_(parity_fraction=1.0)
    srv.request("mis2", g)
    srv.request("mis2", g)          # hit -> parity recompute
    stats = srv.server_stats()["cache"]
    assert stats["parity_checks"] == 1
    assert stats["parity_failures"] == 0


def test_cache_parity_sampling_is_error_diffusion():
    cache = ResultCache(max_bytes=1 << 20, parity_fraction=0.25)

    class R:
        digest = "d"
        payload = np.zeros(4)

    cache.insert(("k",), R())
    for _ in range(8):
        cache.lookup(("k",), recompute=R)
    assert cache.stats.parity_checks == 2 and cache.stats.hits == 8


def test_cache_parity_failure_raises():
    cache = ResultCache(max_bytes=1 << 20, parity_fraction=1.0)

    class FakeResult:
        def __init__(self, digest):
            self.digest = digest
            self.payload = np.zeros(4)

    cache.insert(("k",), FakeResult("aaaa"))
    with pytest.raises(CacheParityError):
        cache.lookup(("k",), recompute=lambda: FakeResult("bbbb"))
    assert cache.stats.parity_failures == 1


def test_cache_eviction_respects_byte_budget():
    cache = ResultCache(max_bytes=2000)

    class R:
        def __init__(self, i):
            self.digest = f"{i:016x}"
            self.payload = np.zeros(100, dtype=np.float64)  # 800 B each

    for i in range(5):
        cache.insert(("g", i), R(i))
    assert cache.stats.bytes_used <= 2000
    assert cache.stats.evictions >= 3
    assert cache.lookup(("g", 0)) is None       # LRU: oldest evicted
    assert cache.lookup(("g", 4)) is not None   # newest survives


def test_cache_counts_tensor_bytes_of_an_amg_hierarchy():
    from repro_torch.serve.cache import _result_nbytes

    s = rt.amg_setup(G(er_laplacian(120, 5.0, seed=6)), backend=CPU)
    lvl = s.hierarchy.levels[0]
    cols = lvl.a_ell.cols
    assert _result_nbytes(s) > 256 + cols.numel() * cols.element_size()


def test_cache_disabled_by_zero_budget(fleet):
    srv = srv_(cache_bytes=0)
    srv.request("mis2", fleet[0])
    fut = srv.submit("mis2", fleet[0])
    assert not fut.done()           # no cache -> queued, not resolved
    srv.flush()
    assert fut.result().digest == direct_mis2(fleet[0]).digest


# ---------------------------------------------------------------------------
# batcher: deadline-or-full dispatch with a manual clock
# ---------------------------------------------------------------------------

def _req_g(g, kind="mis2"):
    return PendingRequest(kind=kind, graph=G(g),
                          params={"options": Mis2Options()}, engine=None,
                          backend=None, cache_key=(kind, id(g)))


def _req(kind="mis2", key=("k",), deadline=None):
    return PendingRequest(kind=kind, graph=None, params={"p": key},
                          engine=None, backend=None, cache_key=key,
                          future=Future(), deadline=deadline)


def test_batcher_full_group_dispatches_immediately():
    b = Batcher(max_batch=3, max_delay_s=10.0)
    for _ in range(3):
        b.add(_req_g(laplace3d(3)), now=0.0)
    groups = b.due(now=0.0)
    assert len(groups) == 1 and len(groups[0][1]) == 3
    assert len(b) == 0


def test_batcher_partial_group_waits_for_deadline():
    b = Batcher(max_batch=8, max_delay_s=0.5)
    b.add(_req_g(laplace3d(3)), now=0.0)
    b.add(_req_g(laplace3d(3)), now=0.1)
    assert b.due(now=0.2) == []                 # budget not exhausted
    assert b.next_deadline(now=0.2) == pytest.approx(0.3)
    groups = b.due(now=0.5)                     # oldest waited 0.5s
    assert len(groups) == 1 and len(groups[0][1]) == 2


def test_batcher_force_flush_dispatches_everything():
    b = Batcher(max_batch=8, max_delay_s=100.0)
    b.add(_req_g(laplace3d(3)), now=0.0)
    b.add(_req_g(laplace3d(3), kind="color"), now=0.0)
    groups = b.due(now=0.0, force=True)
    assert len(groups) == 2                     # kinds never coalesce
    assert len(b) == 0


def test_batcher_zero_delay_dispatches_immediately():
    b = Batcher(max_batch=8, max_delay_s=0.0)
    b.add(_req(key=("a",)), now=100.0)
    groups = b.due(now=100.0)
    assert len(groups) == 1 and len(b) == 0


def test_batcher_force_flush_pops_every_group():
    b = Batcher(max_batch=8, max_delay_s=10.0)
    b.add(_req(key=("a",)), now=0.0)
    b.add(_req(kind="color", key=("b",)), now=0.0)
    b.add(_req(kind="coarsen", key=("c",)), now=0.0)
    assert b.due(now=0.1) == []
    groups = b.due(now=0.1, force=True)
    assert len(groups) == 3 and len(b) == 0


def test_batcher_next_deadline_orders_batching_and_request_deadlines():
    b = Batcher(max_batch=8, max_delay_s=5.0)
    assert b.next_deadline(now=0.0) is None
    b.add(_req(key=("a",)), now=0.0)
    assert b.next_deadline(now=0.0) == pytest.approx(5.0)
    b.add(_req(kind="color", key=("b",), deadline=2.0), now=0.0)
    assert b.next_deadline(now=0.0) == pytest.approx(2.0)
    assert b.next_deadline(now=1.5) == pytest.approx(0.5)
    assert b.next_deadline(now=3.0) == 0.0


def test_batcher_pop_expired_evicts_only_expired_requests():
    b = Batcher(max_batch=8, max_delay_s=100.0)
    live = _req(key=("a",), deadline=50.0)
    dead = _req(key=("a",), deadline=1.0)
    never = _req(kind="color", key=("b",))
    for r in (live, dead, never):
        b.add(r, now=0.0)
    assert b.pop_expired(now=2.0) == [dead]
    assert len(b) == 2
    popped = [r for _, reqs in b.due(now=2.0, force=True) for r in reqs]
    assert live in popped and never in popped and dead not in popped


# ---------------------------------------------------------------------------
# engine resolution and the warm registry
# ---------------------------------------------------------------------------

def test_server_resolves_engine_per_request(fleet):
    srv = srv_()
    req = PendingRequest(kind="mis2", graph=fleet[0],
                         params={"options": Mis2Options()}, engine=None,
                         backend=None, cache_key=())
    assert srv._resolve_engine(req) == "cuda_resident"
    req.params = {"options": Mis2Options(worklists=False)}
    assert srv._resolve_engine(req) == "cuda_compacted"
    req.engine = "dense"
    assert srv._resolve_engine(req) == "dense"
    req = PendingRequest(kind="amg_setup", graph=fleet[0], params={},
                         engine=None, backend=None, cache_key=())
    assert srv._resolve_engine(req) == "host"       # a CPU graph


def test_warm_registry_configured_shapes_cost_no_runtime_compiles(fleet):
    cfg = ServerConfig(max_batch=4, warm_buckets=warm_buckets_for(fleet),
                       backend=CPU)
    srv = Server(cfg)
    comp = srv.server_stats()["compiles"]
    assert comp["startup_aot"] == len(cfg.warm_buckets)
    for g in fleet:
        srv.submit("mis2", g)
    srv.flush()
    comp = srv.server_stats()["compiles"]
    assert comp["runtime_cold"] == 0
    assert comp["nvcc_since_warm"] == 0


def test_warm_registry_counts_cold_shapes_once():
    srv = srv_(max_batch=2, warm_buckets=(), dedup=False)
    g = G(laplace3d(4))
    for _ in range(2):
        srv.submit("mis2", g)
        srv.submit("mis2", G(laplace3d(4)))
        srv.flush()
        srv.cache.clear()
    assert srv.server_stats()["compiles"]["runtime_cold"] == 1
    srv.reset_window()
    assert srv.server_stats()["compiles"]["runtime_cold_window"] == 0


# ---------------------------------------------------------------------------
# streaming: incremental-repair digest == from-scratch digest
# ---------------------------------------------------------------------------

def _random_delta(session, rng, n=3):
    v = session.graph.num_vertices
    adds = rng.integers(0, v, size=(n, 2))
    adds = adds[adds[:, 0] != adds[:, 1]]
    rows, cols = session._keys // v, session._keys % v
    offd = np.flatnonzero(rows != cols)
    pick = rng.choice(offd, size=min(n, len(offd)), replace=False)
    return adds, np.stack([rows[pick], cols[pick]], axis=1)


@pytest.mark.parametrize("maker", [
    lambda: laplace3d(6),
    lambda: random_uniform_graph(300, 5.0, seed=11),
], ids=["laplace3d", "er"])
def test_incremental_repair_digest_matches_scratch(maker):
    rng = np.random.default_rng(5)
    session = StreamSession(maker(), check_fraction=1.0, backend=CPU)
    v = session.graph.num_vertices
    localized = 0
    for _ in range(3):
        adds, removes = _random_delta(session, rng)
        repaired = session.apply_delta(adds, removes)
        scratch = direct_mis2(session.graph, engine="dense",
                              options=Mis2Options(priority="fixed"))
        assert repaired.digest == scratch.digest
        assert repaired.provenance.digest == repaired.digest
        st = session.last_repair
        assert st.mode == "repair" and st.checked
        localized += st.reactivated < v
    assert localized >= 1, "repair never localized below full recompute"


def test_stream_edge_set_matches_csr_from_coo():
    """The merged key set gives the CSR that rebuilding from the edge list
    gives (self-loops kept, removals of missing edges ignored)."""
    from repro_torch.graphs.csr import csr_from_coo, ensure_self_loops

    session = StreamSession(laplace3d(4), backend=CPU)
    adds = [(0, 9), (3, 40), (5, 5)]
    removes = [(0, 1), (2, 2), (7, 60)]
    session.apply_delta(adds, removes)
    v = session.graph.num_vertices
    base = ensure_self_loops(G(laplace3d(4)).csr)
    rows = np.repeat(np.arange(v), np.diff(base.indptr))
    edges = set(zip(rows.tolist(), base.indices.tolist()))
    for u, w in adds:
        edges |= {(u, w), (w, u)}
    for u, w in removes:
        if u != w:
            edges -= {(u, w), (w, u)}
    r, c = map(np.asarray, zip(*sorted(edges)))
    want = csr_from_coo(r, c, v)
    got = session.graph.csr
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)


def test_streaming_nonfixed_priority_falls_back_to_recompute():
    session = StreamSession(laplace3d(4), options=Mis2Options(), backend=CPU)
    r = session.apply_delta([[0, 7]], None)
    assert session.last_repair.mode == "recompute"
    assert r.digest == direct_mis2(session.graph).digest


def test_server_open_stream_uses_config_check_fraction():
    srv = srv_(delta_check_fraction=1.0)
    session = srv.open_stream(laplace3d(4))
    session.apply_delta([[0, 9]], None)
    assert session.last_repair.checked


# ---------------------------------------------------------------------------
# threaded pump, dedup, graph digest plumbing
# ---------------------------------------------------------------------------

def test_threaded_server_serves_without_explicit_flush(fleet):
    with srv_(max_batch=4, max_delay_s=0.005) as srv:
        futs = [srv.submit("mis2", g) for g in fleet]
        results = [f.result(timeout=60) for f in futs]
    for g, r in zip(fleet, results):
        assert r.digest == direct_mis2(g).digest


def test_graph_digest_canonical_and_cached():
    g1, g2, g3 = G(laplace3d(4)), G(laplace3d(4)), G(laplace3d(5))
    assert g1.digest == g2.digest != g3.digest
    _ = g1.digest
    assert g1.conversions.get("digest") == 1
    assert G(laplace3d(4).graph).digest != g1.digest


def test_dedup_coalesces_same_key_submits_onto_one_future():
    g = _graph(1)
    clones = [G(g.csr) for _ in range(5)]
    srv = srv_()
    with obs.capture() as cap:
        futs = [srv.submit("mis2", c) for c in [g] + clones]
        srv.flush()
    assert all(f is futs[0] for f in futs)
    assert {f.result(timeout=30).digest for f in futs} == {
        direct_mis2(g).digest}
    assert srv.stats.dedup_hits == len(clones)
    assert srv.stats.single_dispatches + srv.stats.batched_graphs == 1
    assert cap.value("serve.dedup_hits") == len(clones)


def test_dedup_distinguishes_engine_and_options():
    g = G(laplace3d(4))
    srv = srv_()
    f1 = srv.submit("mis2", g)
    f2 = srv.submit("mis2", g, engine="dense")
    f3 = srv.submit("color", g)
    srv.flush()
    assert len({id(f) for f in (f1, f2, f3)}) == 3
    assert srv.stats.dedup_hits == 0
    assert f1.result().digest == f2.result().digest


def test_dedup_disabled_computes_separately():
    g = _graph(2)
    srv = srv_(dedup=False, cache_bytes=0, single_fast_path=True, max_batch=1)
    f1 = srv.submit("mis2", g)
    f2 = srv.submit("mis2", G(g.csr))
    srv.flush()
    assert f1 is not f2 and srv.stats.dedup_hits == 0
    assert srv.stats.single_dispatches == 2
    assert f1.result().digest == f2.result().digest


def test_dedup_key_released_after_completion():
    g = _graph(3)
    srv = srv_(cache_bytes=0)
    f1 = srv.submit("mis2", g)
    srv.flush()
    f2 = srv.submit("mis2", g)
    srv.flush()
    assert f1 is not f2
    assert f2.result().digest == f1.result().digest
    assert srv.server_stats()["inflight_keys"] == 0


# ---------------------------------------------------------------------------
# admission control: quota, bounded queue, deadline feasibility, layout
# ---------------------------------------------------------------------------

def test_token_bucket_refill_with_manual_clock():
    b = TokenBucket(rate=2.0, burst=4.0, now=0.0)
    assert all(b.try_take(0.0) for _ in range(4))
    assert not b.try_take(0.0)
    assert not b.try_take(0.4)
    assert b.try_take(0.5)
    assert b.try_take(10.0)
    assert sum(b.try_take(10.0) for _ in range(9)) == 3


def test_admission_controller_policies_with_injected_clock():
    clock = [0.0]
    ctl = AdmissionController(max_pending=2,
                              quota=QuotaConfig(rate=1.0, burst=2.0),
                              clock=lambda: clock[0])
    ctl.admit(caller="a", pending=0)
    ctl.admit(caller="a", pending=0)
    with pytest.raises(QuotaExceeded):
        ctl.admit(caller="a", pending=0)
    assert ctl.denials == {"a": 1}
    ctl.admit(caller="b", pending=0)
    clock[0] = 1.0
    ctl.admit(caller="a", pending=0)
    with pytest.raises(ServerOverloaded):
        ctl.admit(caller="c", pending=2)
    ctl.admit(caller="c", pending=2, joining=True)
    with pytest.raises(DeadlineExceeded):
        ctl.admit(caller="d", deadline_s=0.0)
    with pytest.raises(DeadlineExceeded):
        ctl.admit(caller="e", deadline_s=0.01, est_wait_s=1.0)
    ctl.admit(caller="f", deadline_s=2.0, est_wait_s=1.0)


def test_admission_bucket_recycling_is_lru_not_fifo(monkeypatch):
    from repro_torch.serve import admission

    monkeypatch.setattr(admission, "MAX_TRACKED_CALLERS", 2)
    ctl = AdmissionController(quota=QuotaConfig(rate=0.0, burst=1.0),
                              clock=lambda: 0.0)
    ctl.admit(caller="hot")
    ctl.admit(caller="b")
    with pytest.raises(QuotaExceeded):
        ctl.admit(caller="hot")
    ctl.admit(caller="c")
    with pytest.raises(QuotaExceeded):
        ctl.admit(caller="hot")


def test_server_sheds_overload_with_typed_error_and_counter():
    srv = srv_(max_pending=1, dedup=False)
    with obs.capture() as cap:
        f1 = srv.submit("mis2", _graph(4))
        f2 = srv.submit("mis2", _graph(5))
    with pytest.raises(ServerOverloaded) as ei:
        f2.result(timeout=5)
    assert ei.value.retryable
    assert cap.value("serve.shed", {"reason": "overloaded"}) == 1
    srv.flush()
    assert f1.result(timeout=30).converged


def test_server_quota_is_per_caller():
    srv = srv_(quota=QuotaConfig(rate=0.0, burst=1.0), dedup=False,
               cache_bytes=0)
    f_a1 = srv.submit("mis2", _graph(6), caller="alice")
    f_a2 = srv.submit("mis2", _graph(7), caller="alice")
    f_b = srv.submit("mis2", _graph(8), caller="bob")
    srv.flush()
    with pytest.raises(QuotaExceeded):
        f_a2.result(timeout=5)
    assert f_a1.result(timeout=30).converged
    assert f_b.result(timeout=30).converged
    assert srv.server_stats()["quota_denials"] == {"alice": 1}


def test_expired_deadline_is_shed_at_submit():
    srv = srv_()
    fut = srv.submit("mis2", _graph(9), deadline_s=0.0)
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=5)
    assert srv.stats.shed == 1 and len(srv.batcher) == 0


def test_cache_hits_bypass_admission():
    g = _graph(10)
    srv = srv_(quota=QuotaConfig(rate=0.0, burst=1.0))
    first = srv.request("mis2", g)
    assert srv.submit("mis2", g).result(timeout=5).digest == first.digest
    with pytest.raises(QuotaExceeded):
        srv.submit("mis2", _graph(11)).result(timeout=5)


def test_ell_bound_engine_on_a_huge_graph_is_shed_before_queueing(
        monkeypatch):
    """An explicit ELL-bound engine on a graph past ``ELL_BYTE_LIMIT`` is
    refused with ``LayoutInfeasible``; ``engine=None`` and the hybrid
    engines are admitted."""
    from repro_torch.serve import server as server_mod

    monkeypatch.setattr(server_mod, "ELL_BYTE_LIMIT", 100)
    g = _graph(12)
    srv = srv_(max_delay_s=100.0)
    with obs.capture() as cap:
        fut = srv.submit("mis2", g, engine="cuda_resident")
    with pytest.raises(LayoutInfeasible, match="cuda_hybrid"):
        fut.result(timeout=5)
    assert cap.value("serve.shed", {"reason": "layout"}) == 1
    assert len(srv.batcher) == 0
    srv.submit("mis2", g)
    srv.submit("mis2", g, engine="cuda_hybrid")
    srv.submit("color", g, engine="luby_hybrid")
    assert len(srv.batcher) == 3


def test_server_evicts_expired_request_before_dispatch():
    srv = srv_(max_delay_s=100.0)
    fut = srv.submit("mis2", _graph(12), deadline_s=0.001)
    time.sleep(0.01)
    with obs.capture() as cap:
        srv.pump()
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=5)
    assert srv.stats.expired == 1 and srv.stats.dispatches == 0
    assert cap.value("serve.shed", {"reason": "expired"}) == 1


# ---------------------------------------------------------------------------
# stop(): terminal, typed, race-free
# ---------------------------------------------------------------------------

def test_stop_fails_queued_futures_with_server_closed():
    srv = srv_(max_delay_s=100.0)
    futs = [srv.submit("mis2", _graph(s)) for s in (13, 14)]
    srv.stop()
    for fut in futs:
        with pytest.raises(ServerClosed):
            fut.result(timeout=5)
    with pytest.raises(ServerClosed):
        srv.submit("mis2", _graph(15)).result(timeout=5)
    with pytest.raises(ServerClosed):
        srv.request("mis2", _graph(16))
    with pytest.raises(ServerClosed):
        srv.open_stream(_graph(17))
    with pytest.raises(ServerClosed):
        srv.start()
    srv.stop()


def test_concurrent_submitters_racing_shutdown_never_hang():
    srv = srv_(max_delay_s=0.0, poll_interval_s=0.001)
    srv.start()
    graphs = [_graph(20 + s, n=40) for s in range(4)]
    futures, lock = [], threading.Lock()
    stop_submitting = threading.Event()

    def submitter(i):
        k = 0
        while not stop_submitting.is_set():
            fut = srv.submit("mis2", graphs[(i + k) % len(graphs)])
            with lock:
                futures.append(fut)
            k += 1
            time.sleep(0.001)

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    srv.stop()
    stop_submitting.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    referents = {direct_mis2(g).digest for g in graphs}
    served = closed = 0
    for fut in futures:
        try:
            res = fut.result(timeout=10)
        except ServerClosed:
            closed += 1
        else:
            assert res.digest in referents
            served += 1
    assert futures and served + closed == len(futures)


# ---------------------------------------------------------------------------
# fault injection: deterministic, retried, degraded — never wrong
# ---------------------------------------------------------------------------

def test_fault_plan_is_deterministic_per_seed():
    def firing_pattern(seed):
        plan = FaultPlan(seed=seed, sites={
            "engine": Fault("error", rate=0.4)})
        return [plan.should_fire("engine") is not None for _ in range(64)]

    a = firing_pattern(7)
    assert a == firing_pattern(7)
    assert firing_pattern(8) != a
    assert 0 < sum(a) < 64


def test_fault_plan_trace_equals_the_reference():
    from repro.serve import faults as ref_faults

    sites = {"engine": ("error", 0.4), "dispatch": ("slow", 0.3)}
    port = FaultPlan(seed=11, sites={k: Fault(kind, rate=r)
                                     for k, (kind, r) in sites.items()})
    ref = ref_faults.FaultPlan(seed=11, sites={
        k: ref_faults.Fault(kind, rate=r) for k, (kind, r) in sites.items()})
    for _ in range(50):
        for site in ("engine", "dispatch"):
            assert (port.should_fire(site) is None) == \
                (ref.should_fire(site) is None)
    assert port.fired == ref.fired


def test_fault_count_caps_firings():
    plan = FaultPlan(seed=0, sites={"engine": Fault("error", count=2)})
    fired = sum(plan.should_fire("engine") is not None for _ in range(10))
    assert fired == 2 and plan.fired["engine"] == 2


def test_transient_fault_retried_to_correct_digest():
    g = _graph(30)
    plan = FaultPlan(seed=1, sites={
        "engine": Fault("error", count=2, transient=True)})
    srv = srv_(faults=plan,
               retry=RetryPolicy(max_attempts=3, base_backoff_s=0.0))
    with obs.capture() as cap:
        res = srv.request("mis2", g)
    assert res.digest == direct_mis2(g).digest
    assert srv.stats.retries == 2
    assert cap.value("serve.retries", {"site": "engine"}) == 2
    assert cap.value("serve.faults.injected", {"site": "engine"}) == 2


def test_persistent_fault_degrades_to_fallback_engine():
    g = _graph(31)
    plan = FaultPlan(seed=1, sites={
        "engine": Fault("error", transient=False)})
    srv = srv_(faults=plan)
    with obs.capture() as cap:
        res = srv.request("mis2", g)
    assert res.digest == direct_mis2(g, engine="dense").digest
    assert res.engine == "dense"
    assert srv.stats.fallbacks == 1
    assert cap.value("serve.fallbacks", {"from": "auto", "to": "dense"}) == 1


def test_exhausted_retry_budget_falls_back():
    g = _graph(32)
    plan = FaultPlan(seed=1, sites={"engine": Fault("error", transient=True)})
    srv = srv_(faults=plan,
               retry=RetryPolicy(max_attempts=2, base_backoff_s=0.0))
    res = srv.request("mis2", g)
    assert res.digest == direct_mis2(g).digest
    assert srv.stats.retries == 1 and srv.stats.fallbacks == 1


def test_fallback_disabled_surfaces_injected_fault():
    plan = FaultPlan(seed=1, sites={
        "engine": Fault("error", transient=False)})
    srv = srv_(faults=plan, retry=RetryPolicy(fallback=False))
    fut = srv.submit("mis2", _graph(33))
    srv.flush()
    with pytest.raises(InjectedFault):
        fut.result(timeout=5)


def test_slow_fault_delays_but_serves_correctly():
    g = _graph(34)
    plan = FaultPlan(seed=1, sites={
        "dispatch": Fault("slow", count=1, delay_s=0.05)})
    srv = srv_(faults=plan)
    t0 = time.perf_counter()
    res = srv.request("mis2", g)
    assert time.perf_counter() - t0 >= 0.05
    assert res.digest == direct_mis2(g).digest


def test_streaming_repair_fault_degrades_to_exact_recompute():
    g = G(laplace3d(4))
    plan = FaultPlan(seed=2, sites={"repair": Fault("error", count=1)})
    srv = srv_(faults=plan)
    sess = srv.open_stream(g)
    with obs.capture() as cap:
        res = sess.apply_delta(edge_adds=[(0, 9)])
    assert sess.last_repair.degraded and sess.last_repair.mode == "recompute"
    assert cap.value("serve.fallbacks",
                     {"from": "repair", "to": "recompute"}) == 1
    assert res.digest == direct_mis2(sess.graph, engine="dense",
                                     options=sess.options).digest
    sess.apply_delta(edge_adds=[(1, 11)])
    assert sess.last_repair.mode == "repair"
    assert not sess.last_repair.degraded


def test_real_engine_exception_wrapped_as_engine_failure():
    srv = srv_(retry=RetryPolicy(fallback=False))
    boom = RuntimeError("engine exploded")

    def exploding(reqs):
        raise boom

    srv._compute = exploding
    fut = srv.submit("mis2", _graph(35))
    srv.flush()
    with pytest.raises(EngineFailure) as ei:
        fut.result(timeout=5)
    assert ei.value.__cause__ is boom


def test_no_fault_plan_means_no_fallbacks(fleet):
    srv = srv_(max_batch=4)
    for kind in ("mis2", "color", "coarsen"):
        for g in fleet:
            srv.submit(kind, g)
    srv.flush()
    st = srv.server_stats()
    assert (st["fallbacks"], st["retries"]) == (0, 0)


# ---------------------------------------------------------------------------
# the digest ledger: one key, one digest, forever
# ---------------------------------------------------------------------------

def test_digest_ledger_refuses_conflicting_digest():
    g = _graph(36)
    srv = srv_(cache_bytes=0)
    first = srv.request("mis2", g)
    key = next(iter(srv._ledger))
    srv._ledger[key] = "poisoned_digest!"
    fut = srv.submit("mis2", g)
    srv.flush()
    with pytest.raises(DigestMismatch):
        fut.result(timeout=5)
    assert first.converged


def test_digest_ledger_accepts_repeat_of_same_digest():
    g = _graph(37)
    srv = srv_(cache_bytes=0)
    a = srv.request("mis2", g)
    b = srv.request("mis2", g)
    assert a.digest == b.digest
    assert srv.server_stats()["ledger_keys"] == 1


def test_chaos_run_every_response_typed_or_digest_correct():
    graphs = [_graph(40 + s, n=60) for s in range(6)]
    referents = {g.digest: direct_mis2(g).digest for g in graphs}
    plan = FaultPlan(seed=9, sites={
        "engine": Fault("error", rate=0.3, transient=True),
        "dispatch": Fault("slow", rate=0.2, delay_s=0.002)})
    srv = srv_(max_pending=4, quota=QuotaConfig(rate=200.0, burst=8.0),
               default_deadline_s=30.0, faults=plan,
               retry=RetryPolicy(max_attempts=2, base_backoff_s=0.0),
               cache_bytes=0, dedup=False)
    futs = []
    for round_ in range(6):
        for i, g in enumerate(graphs):
            futs.append((g, srv.submit("mis2", g,
                                       caller=f"c{(round_ + i) % 3}")))
        srv.flush()
    srv.flush()
    served = shed = 0
    for g, fut in futs:
        assert fut.done()
        try:
            res = fut.result()
        except ServeError:
            shed += 1
        else:
            assert res.digest == referents[g.digest]
            served += 1
    assert served > 0 and served + shed == len(futs)
    stats = srv.server_stats()
    assert stats["retries"] + stats["fallbacks"] > 0


# ---------------------------------------------------------------------------
# persistent tier: atomic, digest-verified, restart-safe
# ---------------------------------------------------------------------------

def test_persist_roundtrip_survives_restart(tmp_path):
    d = str(tmp_path / "tier")
    g, gc = _graph(50), G(laplace3d(4))
    srv = srv_(persist_dir=d)
    ref_mis2 = srv.request("mis2", g)
    ref_color = srv.request("color", gc)
    ref_coarsen = srv.request("coarsen", gc)
    assert srv.persist.stats.writes == 3
    srv.stop()

    srv2 = srv_(persist_dir=d)
    got_mis2 = srv2.request("mis2", g)
    assert got_mis2.digest == ref_mis2.digest
    assert got_mis2.host_syncs == ref_mis2.host_syncs
    assert srv2.request("color", gc).digest == ref_color.digest
    got = srv2.request("coarsen", gc)
    assert got.digest == ref_coarsen.digest
    assert np.array_equal(got.roots, ref_coarsen.roots)
    assert got.num_aggregates == ref_coarsen.num_aggregates
    assert got.engine == ref_coarsen.engine
    assert srv2.persist.stats.hits == 3
    assert srv2.stats.dispatches == 0
    assert srv2.persist.stats.corrupt == 0


def test_persist_corrupt_entry_dropped_never_served(tmp_path):
    d = str(tmp_path / "tier")
    g = _graph(51)
    plan = FaultPlan(seed=3, sites={
        "persist_corrupt": Fault("corrupt", count=1)})
    srv = srv_(persist_dir=d, faults=plan)
    ref = srv.request("mis2", g)
    srv.stop()
    with obs.capture() as cap:
        srv2 = srv_(persist_dir=d)
        res = srv2.request("mis2", g)
    assert res.digest == ref.digest
    assert srv2.persist.stats.corrupt == 1 and srv2.persist.stats.hits == 0
    assert srv2.stats.dispatches == 1
    assert cap.value("serve.persist.corrupt") == 1
    assert len(srv2.persist) == 1


def test_persist_torn_write_leaves_no_entry_and_is_swept(tmp_path):
    d = str(tmp_path / "tier")
    g = _graph(52)
    plan = FaultPlan(seed=4, sites={"persist_write": Fault("error", count=1)})
    srv = srv_(persist_dir=d, faults=plan)
    ref = srv.request("mis2", g)
    assert srv.persist.stats.writes == 0
    assert any(n.endswith(".tmp") for n in os.listdir(d))
    srv.stop()
    srv2 = srv_(persist_dir=d)
    assert srv2.persist.stats.torn_cleaned == 1
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert srv2.request("mis2", g).digest == ref.digest
    assert srv2.stats.dispatches == 1


def test_persist_byte_budget_evicts_oldest(tmp_path):
    tier = PersistTier(str(tmp_path / "tier"))
    graphs = [_graph(60 + s, n=120) for s in range(4)]
    results = [direct_mis2(g) for g in graphs]
    keys = [("mis2", g.digest, "auto", ()) for g in graphs]
    entry_bytes = []
    for k, r in zip(keys, results):
        assert tier.store(k, r)
        entry_bytes.append(tier.stats.bytes_used - sum(entry_bytes))
    budget = entry_bytes[-1] + entry_bytes[-2] + entry_bytes[-3] // 2
    tier2 = PersistTier(str(tmp_path / "tier2"), max_bytes=budget)
    for k, r in zip(keys, results):
        assert tier2.store(k, r)
        time.sleep(0.01)
    assert tier2.stats.evictions >= 1
    assert tier2.stats.bytes_used <= budget
    assert tier2.load(keys[-1]).digest == results[-1].digest
    assert tier2.load(keys[0]) is None
    assert tier2.stats.corrupt == 0


def test_persist_skips_amg_and_server_still_serves(tmp_path):
    m = G(er_laplacian(120, 5.0, seed=6))
    srv = srv_(persist_dir=str(tmp_path / "tier"))
    res = srv.request("amg_setup", m)
    assert res.num_levels >= 1
    assert srv.persist.stats.writes == 0 and len(srv.persist) == 0
    assert srv.submit("amg_setup", m).result(timeout=5).digest == res.digest


def test_persist_wrong_key_same_address_not_served(tmp_path):
    tier = PersistTier(str(tmp_path / "tier"))
    g = _graph(53)
    res = direct_mis2(g)
    key = ("mis2", g.digest, "auto", ())
    assert tier.store(key, res)
    assert tier.load(("mis2", g.digest, "dense", ())) is None
    assert tier.load(key).digest == res.digest


def _enospc(*a, **k):
    raise OSError(28, "No space left on device")


def test_persist_store_io_error_degrades_to_memory_only(tmp_path,
                                                        monkeypatch):
    g = _graph(70)
    srv = srv_(persist_dir=str(tmp_path / "tier"))
    monkeypatch.setattr("repro_torch.serve.persist.np.savez", _enospc)
    fut = srv.submit("mis2", g)
    srv.flush()
    res = fut.result(timeout=30)
    assert res.digest == direct_mis2(g).digest
    assert srv.persist.stats.io_errors == 1 and srv.persist.stats.writes == 0
    assert srv.submit("mis2", g).result(timeout=5).digest == res.digest


def test_pump_crash_fails_queued_futures_and_loop_survives():
    srv = srv_(max_delay_s=0.0, poll_interval_s=0.001, cache_bytes=0)
    crashed = {"n": 0}
    orig_due = srv.batcher.due

    def flaky_due(now, force=False):
        if crashed["n"] == 0 and len(srv.batcher):
            crashed["n"] += 1
            raise RuntimeError("boom outside dispatch fan-out")
        return orig_due(now, force=force)

    srv.batcher.due = flaky_due
    with srv:
        fut = srv.submit("mis2", _graph(73))
        with pytest.raises(EngineFailure):
            fut.result(timeout=30)
        g = _graph(74)
        res = srv.submit("mis2", g).result(timeout=30)
    assert crashed["n"] == 1
    assert res.digest == direct_mis2(g).digest


def test_persist_load_utime_race_is_a_miss(tmp_path, monkeypatch):
    tier = PersistTier(str(tmp_path / "tier"))
    g = _graph(75)
    key = ("mis2", g.digest, "auto", ())
    assert tier.store(key, direct_mis2(g))

    def vanished(*a, **k):
        raise FileNotFoundError("entry evicted by a sharing process")

    monkeypatch.setattr("repro_torch.serve.persist.os.utime", vanished)
    misses = tier.stats.misses
    assert tier.load(key) is None
    assert tier.stats.misses == misses + 1


def test_persist_tampered_toplevel_digest_is_corrupt(tmp_path):
    tier = PersistTier(str(tmp_path / "tier"))
    g = _graph(76)
    key = ("mis2", g.digest, "auto", ())
    assert tier.store(key, direct_mis2(g))
    mpath = os.path.join(tier.directory, entry_name(key), "manifest.json")
    with open(mpath) as fh:
        manifest = json.load(fh)
    manifest["digest"] = "0" * 16
    with open(mpath, "w") as fh:
        json.dump(manifest, fh)
    assert tier.load(key) is None
    assert tier.stats.corrupt == 1


def test_submit_not_blocked_by_slow_dispatch():
    plan = FaultPlan(seed=5, sites={
        "dispatch": Fault("slow", count=1, delay_s=0.5)})
    srv = srv_(faults=plan, max_delay_s=0.0, poll_interval_s=0.001)
    with srv:
        slow = srv.submit("mis2", _graph(77))
        time.sleep(0.1)
        g = _graph(78)
        t0 = time.perf_counter()
        fast = srv.submit("mis2", g)
        submit_latency = time.perf_counter() - t0
        assert slow.result(timeout=30).converged
        assert fast.result(timeout=30).digest == direct_mis2(g).digest
    assert submit_latency < 0.25


# ---------------------------------------------------------------------------
# the port's rule: a kernel error is never degraded to a fallback engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("err", [
    KernelBuildError("nvcc failed on minprop_ell.cu"),
    KernelLaunchError("resident_fixed_point: CUDA error 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
], ids=["build", "launch", "cuda_runtime", "oom"])
def test_kernel_error_resolves_engine_failure_without_fallback(
        err, monkeypatch):
    """The engine's kernel wrapper raises inside a served request: the
    request fails with ``EngineFailure`` whose cause is the kernel error,
    and no fallback engine answers in its place."""
    from repro_torch.kernels.minprop_ell import ops

    def broken(*a, **k):
        raise err

    monkeypatch.setattr(ops, "resident_fixed_point", broken)
    srv = srv_()
    with obs.capture() as cap:
        fut = srv.submit("mis2", _graph(80))
        srv.flush()
    with pytest.raises(EngineFailure) as ei:
        fut.result(timeout=5)
    assert ei.value.__cause__ is err
    assert srv.stats.fallbacks == 0
    assert cap.value("serve.fallbacks", {"from": "auto", "to": "dense"}) == 0


def test_other_engine_errors_still_fall_back(monkeypatch):
    from repro_torch.kernels.minprop_ell import ops

    def broken(*a, **k):
        raise RuntimeError("not a device fault")

    monkeypatch.setattr(ops, "resident_fixed_point", broken)
    g = _graph(81)
    srv = srv_()
    res = srv.request("mis2", g)
    assert res.engine == "dense" and srv.stats.fallbacks == 1
    assert res.digest == direct_mis2(g, engine="dense").digest


def test_engine_error_on_card_resolves_engine_failure(monkeypatch):
    """A request whose graph lies on the card never falls back on a real
    exception, of whatever kind: ``EngineFailure``, the exception as its
    cause (the card is stood in for by ``_on_card``)."""
    from repro_torch.kernels.minprop_ell import ops
    from repro_torch.serve import server as server_mod

    err = ValueError("a bug in a wrapper's argument preparation")

    def broken(*a, **k):
        raise err

    monkeypatch.setattr(ops, "resident_fixed_point", broken)
    monkeypatch.setattr(server_mod, "_on_card", lambda req: True)
    srv = srv_()
    fut = srv.submit("mis2", _graph(82))
    srv.flush()
    with pytest.raises(EngineFailure) as ei:
        fut.result(timeout=5)
    assert ei.value.__cause__ is err
    assert srv.stats.fallbacks == 0


@pytest.mark.parametrize("kind", ["mis2", "amg_setup"])
def test_injected_fault_on_card_falls_back_to_default_engine(kind,
                                                             monkeypatch):
    """On the card an injected persistent fault degrades to the default
    engine (the card's kernels), never to the host or dense referent."""
    from repro_torch.serve import server as server_mod

    monkeypatch.setattr(server_mod, "_on_card", lambda req: True)
    g = _graph(83) if kind == "mis2" else G(er_laplacian(120, 5.0, seed=6))
    plan = FaultPlan(seed=1, sites={
        "engine": Fault("error", transient=False)})
    srv = srv_(faults=plan)
    with obs.capture() as cap:
        res = srv.request(kind, g)
    want = getattr(rt, kind)(g, backend=CPU)
    assert srv.stats.fallbacks == 1
    assert cap.value("serve.fallbacks", {"from": "auto", "to": "default"}) == 1
    if kind == "mis2":
        assert res.engine == want.engine != "dense"
        assert res.digest == want.digest
    else:
        assert res.level_digests == want.level_digests


def test_explicit_engine_group_and_large_graphs_run_alone(monkeypatch):
    """An explicit-engine group runs each request on its engine; in an
    ``engine=None`` group a graph past ``BATCH_MAX_ELL_BYTES`` runs alone on
    the single-graph default engine, the rest batched."""
    from repro_torch.serve import server as server_mod

    small = [_graph(90 + s, n=40) for s in range(2)]
    big = _graph(95, n=300)
    cut = max(g.ell_bytes_estimate() for g in small)
    assert big.ell_bytes_estimate() > cut
    monkeypatch.setattr(server_mod, "BATCH_MAX_ELL_BYTES", cut)
    srv = srv_(max_batch=8, cache_bytes=0, dedup=False)
    f_auto = [srv.submit("mis2", g) for g in small + [big]]
    f_dense = [srv.submit("mis2", g, engine="dense") for g in small]
    srv.flush()
    got = [f.result() for f in f_auto]
    assert [r.engine for r in got] == ["dense_batched", "dense_batched",
                                       "cuda_resident"]
    assert all(f.result().engine == "dense" for f in f_dense)
    for g, r in zip(small + [big], got):
        assert r.digest == direct_mis2(g).digest
    st = srv.server_stats()
    assert (st["batched_graphs"], st["single_dispatches"]) == (2, 3)
