"""``repro_torch.obs`` — the port's observability: metrics, spans,
exporters (a copy of the JAX package's ``repro.obs``, which imports no jax
but lies in the package the port may not import).

One registry for the whole process::

    from repro_torch import obs

    snap = obs.snapshot()                 # execution shape, one object
    snap.value("mis2.host_syncs")
    print(obs.to_prometheus(snap))        # scrape endpoint body

Context-scoped capture (the test-safe alternative to resetting global
counts)::

    with obs.capture() as cap:
        r = rt.mis2(g, engine="compacted_resident")
    assert cap.value("mis2.resident_dispatches") == 1
    assert cap.value("mis2.host_syncs") == r.host_syncs

Span tracing (nested wall time + metric deltas; the facade attaches the
root span to every ``Result`` as ``result.provenance``)::

    with obs.span("bench.fleet", graphs=20):
        ...
"""
from .export import from_json, to_json, to_prometheus
from .registry import (
    Capture,
    CardinalityError,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Sample,
    Snapshot,
    metrics,
)
from .spans import Provenance, Span, current_span, recent_spans, span


def snapshot() -> Snapshot:
    """Snapshot the process-wide registry."""
    return metrics.snapshot()


def capture() -> Capture:
    """Context-scoped delta capture over the process-wide registry."""
    return metrics.capture()


def reset(prefix=None) -> None:
    """Zero the process-wide registry (or one name prefix).  Prefer
    :func:`capture` in tests — reset is global and order-dependent."""
    metrics.reset(prefix)


__all__ = [
    "metrics", "snapshot", "capture", "reset",
    "MetricsRegistry", "Snapshot", "Sample", "Capture",
    "Counter", "Gauge", "Histogram", "CardinalityError",
    "span", "Span", "current_span", "recent_spans", "Provenance",
    "to_prometheus", "to_json", "from_json",
]
