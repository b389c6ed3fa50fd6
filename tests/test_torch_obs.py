"""The port's observability layer (``repro_torch.obs``) on the CPU: the
registry's semantics on a copied subset of ``tests/test_obs.py``
(cardinality, capture deltas, the exporters, spans), a ``Provenance`` on
every facade result, and the counters under the reference's names:
``mis2.host_syncs`` equal to every engine's ``host_syncs`` and, for the
host-driven ``compacted`` engine, to the reference's own count on the same
graph; ``multilevel.*`` equal to the setups' counts; ``graph.conversions``
per conversion."""
from __future__ import annotations

import json
import re

import numpy as np
import pytest

import repro_torch as rt
from repro_torch import obs
from repro_torch.obs import CardinalityError, MetricsRegistry, Snapshot

from _torch_common import CPU, port_graph, port_hybrid_graph, ref_ablation

# ---------------------------------------------------------------------------
# registry semantics (cases of tests/test_obs.py)
# ---------------------------------------------------------------------------


def test_registry_counter_gauge_histogram():
    reg = MetricsRegistry()
    reg.counter("x.calls").inc()
    reg.counter("x.calls").inc(2)
    reg.gauge("x.level").set(7)
    reg.gauge("x.level").add(-2)
    h = reg.histogram("x.seconds", labels={"phase": "a"})
    h.observe(0.5)
    h.observe(1.5)
    snap = reg.snapshot()
    assert snap.value("x.calls") == 3
    assert snap.value("x.level") == 5
    assert snap.value("x.seconds", {"phase": "a"}) == 2.0
    assert snap.count("x.seconds", {"phase": "a"}) == 2
    assert h.stats["mean"] == 1.0
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x.calls")


def test_capture_is_delta_scoped_and_reset_keeps_handles():
    reg = MetricsRegistry()
    c = reg.counter("x.calls")
    c.inc(100)
    with reg.capture() as outer:
        c.inc()
        with reg.capture() as inner:
            c.inc(2)
        c.inc(4)
    assert (inner.value("x.calls"), outer.value("x.calls")) == (2, 7)
    reg.gauge("x.g").set(3)
    before = reg.snapshot()
    reg.counter("x.b").inc()
    d = reg.snapshot().delta(before)
    assert d.value("x.b") == 1 and d.value("x.g") == 3
    assert all(s.name != "x.calls" for s in d)      # unchanged: dropped
    reg.reset("x.c")
    c.inc()
    assert reg.snapshot().value("x.calls") == 1


@pytest.mark.parametrize("labels,match", [
    ({"digest": "a" * 64}, "span attrs"),
    ({"k": "has spaces"}, "bounded identifier"),
])
def test_label_cardinality_rejects_unbounded_values(labels, match):
    with pytest.raises(CardinalityError, match=match):
        MetricsRegistry().counter("x.c", labels=labels)


def test_label_cardinality_rejects_unboundedly_many_series():
    reg = MetricsRegistry()
    reg.counter("x.c", labels={"k": "a/b:c+d-e.f"}).inc()
    with pytest.raises(CardinalityError, match="label sets"):
        for i in range(reg.max_series_per_metric + 1):
            reg.counter("x.c", labels={"i": i}).inc()
    reg.counter("y.ok").inc()


_PROM_LINE = re.compile(
    r"^(# TYPE [a-zA-Z_][a-zA-Z0-9_]* (counter|gauge|summary)"
    r"|[a-zA-Z_][a-zA-Z0-9_]*(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})? -?[0-9.e+-]+)$")


def test_exporters_round_trip_and_parse():
    reg = MetricsRegistry()
    reg.counter("mis2.resident_dispatches").inc(3)
    reg.counter("x.c", labels={"k": "v"}).inc(2)
    reg.gauge("x.g").set(1.5)
    reg.histogram("span.seconds", labels={"span": "api.mis2"}).observe(0.25)
    snap = reg.snapshot()
    back = obs.from_json(obs.to_json(snap))
    assert isinstance(back, Snapshot)
    assert back.to_json() == snap.to_json() and back.flat() == snap.flat()
    lines = obs.to_prometheus(snap).strip().split("\n")
    assert all(_PROM_LINE.match(ln) for ln in lines), lines
    assert "repro_mis2_resident_dispatches 3" in lines
    assert 'repro_span_seconds_count{span="api.mis2"} 1' in lines


def test_span_nesting_and_metric_attribution():
    with obs.span("outer", job="t", arr=np.arange(3)) as outer:
        obs.metrics.counter("spantest.outer_work").inc()
        assert obs.current_span() is outer
        with obs.span("inner") as inner:
            obs.metrics.counter("spantest.inner_work").inc(2)
        inner.annotate(n=np.int64(7))
    assert obs.current_span() is None
    assert [c.name for c in outer.children] == ["inner"]
    assert outer.metrics["spantest.inner_work"] == 2
    assert isinstance(outer.attrs["arr"], str)
    assert isinstance(inner.attrs["n"], str)
    json.dumps(outer.to_dict())
    assert outer in obs.recent_spans(5)


# ---------------------------------------------------------------------------
# provenance on every facade result
# ---------------------------------------------------------------------------

def _calls():
    g = port_graph("laplace3d(8)")
    m = rt.Graph(rt.graphs.laplace3d(8), device="cpu")
    kw = dict(backend=CPU)
    return {
        "mis2": (lambda: rt.mis2(g, **kw), "cuda_resident"),
        "misk": (lambda: rt.misk(g, k=3, **kw), "dense"),
        "coarsen": (lambda: rt.coarsen(g, **kw), "two_phase"),
        "color": (lambda: rt.color(g, **kw), "luby"),
        "partition": (lambda: rt.partition(g, 4, **kw), "multilevel"),
        "amg_setup": (lambda: rt.amg_setup(m, coarse_size=24, **kw), "host"),
        "amg": (lambda: rt.amg(m, coarse_size=24, **kw), "host"),
        "cluster_gs_setup": (lambda: rt.cluster_gs_setup(m, **kw), "host"),
    }


@pytest.mark.parametrize("kind", list(_calls()))
def test_every_facade_result_carries_provenance(kind):
    call, engine = _calls()[kind]
    r = call()
    p = r.provenance
    assert (p.kind, p.engine, p.backend, p.digest) == (
        "amg_setup" if kind == "amg" else kind, engine, "cpu", r.digest)
    assert p.span["name"] == f"api.{p.kind}" and p.wall_time_s > 0
    assert rt.obs.Provenance.from_json(p.to_json()).as_dict() == p.as_dict()


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------

MIS2_ENGINES = {            # engine -> resident dispatches a solve
    "dense": 0, "compacted": 0, "cuda_compacted": 0,
    "compacted_resident": 1, "cuda_resident": 1, "cuda_hybrid": 1,
    "dense_batched": 0,
}


@pytest.mark.parametrize("engine", list(MIS2_ENGINES))
def test_host_syncs_equal_the_provenance_delta(engine):
    g = port_hybrid_graph("powerlaw") if engine == "cuda_hybrid" \
        else port_graph("laplace3d(8)")
    g.ell_bytes_estimate()
    with obs.capture() as cap:
        r = rt.mis2(g, engine=engine, backend=CPU)
    m = r.provenance.metrics
    assert r.host_syncs > 0
    assert m.get("mis2.host_syncs") == cap.value("mis2.host_syncs") \
        == r.host_syncs
    assert m.get("mis2.resident_dispatches", 0) == MIS2_ENGINES[engine]


@pytest.mark.parametrize("call", ["color", "luby_hybrid", "misk_dense",
                                  "misk_resident"])
def test_coloring_and_misk_host_syncs_counted(call):
    g = port_graph("laplace3d(8)")
    if call.startswith("misk"):
        engine = call.split("_")[1]
        r = rt.misk(g, k=2, engine=engine, backend=CPU)
        want_dispatches = 1 if engine == "resident" else 0
    else:
        r = rt.color(g, engine="luby" if call == "color" else call,
                     backend=CPU)
        want_dispatches = 0
    m = r.provenance.metrics
    assert m["mis2.host_syncs"] == r.host_syncs > 0
    assert m.get("mis2.resident_dispatches", 0) == want_dispatches


def test_compacted_host_syncs_equal_the_reference_count():
    ref, ref_syncs = ref_ablation("laplace3d(8)", "+simd_ell")
    with obs.capture() as cap:
        r = rt.mis2(port_graph("laplace3d(8)"), engine="compacted",
                    options=rt.ABLATION_CHAIN["+simd_ell"], backend=CPU)
    assert r.digest == ref.digest
    assert cap.value("mis2.host_syncs") == ref_syncs == 2 * r.iterations


def test_batch_host_syncs_are_one_read_a_round_per_bucket():
    gs = [port_graph("laplace3d(8)"), port_graph("laplace3d(12)")]
    br = rt.mis2_batch(gs, backend=CPU)
    assert br.num_buckets == 2
    assert br.provenance.metrics["mis2.host_syncs"] == sum(
        r.host_syncs for r in br) == sum(r.iterations + 1 for r in br)


@pytest.mark.parametrize("engine", ["host", "resident"])
def test_multilevel_counters_equal_the_setup_counts(engine):
    m = rt.Graph(rt.graphs.laplace3d(8), device="cpu")
    s = rt.amg_setup(m, engine=engine, coarse_size=24, backend=CPU)
    got = s.provenance.metrics
    coarse_levels = s.num_levels - 1
    if engine == "host":
        assert got["multilevel.host_syncs"] == 3 * coarse_levels
        assert "multilevel.resident_dispatches" not in got
    else:
        assert got["multilevel.resident_dispatches"] == s.dispatches \
            == 7 * coarse_levels
        assert "multilevel.host_syncs" not in got
    gs = rt.cluster_gs_setup(m, engine=engine, backend=CPU).provenance
    key = "multilevel.host_syncs" if engine == "host" \
        else "multilevel.resident_dispatches"
    assert gs.metrics[key] == (2 if engine == "host" else 4)


def test_graph_conversions_counted_once_per_conversion():
    with obs.capture() as cap:
        g = rt.Graph(rt.graphs.laplace3d(5).graph, device="cpu")
        _ = g.ell
        _ = g.ell                                  # cache hit
        _ = g.digest
    assert cap.value("graph.conversions", {"kind": "csr_to_ell"}) == 1
    assert cap.count("graph.conversion_seconds", {"kind": "csr_to_ell"}) == 1
    assert cap.value("graph.conversions", {"kind": "digest"}) == 1
    assert g.conversions == {kind: cap.value("graph.conversions",
                                             {"kind": kind})
                             for kind in g.conversions}
