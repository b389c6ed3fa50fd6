"""Typed process-wide metrics registry: counters, gauges, histograms (a
copy of the JAX package's ``repro.obs.registry``, which the port may not
import).

The port's drivers write their execution shape through here: host reads
inside the MIS-2 and coloring loops (``mis2.host_syncs``), whole-solve
resident dispatches (``mis2.resident_dispatches``), the multilevel setup's
host round-trips and stage calls (``multilevel.*``) and the ``Graph``
conversions (``graph.conversions`` / ``graph.conversion_seconds``), under
the reference's names, so one :func:`MetricsRegistry.snapshot` captures
them all with one schema and one time semantics (delta-since-snapshot).

Design constraints, in order:

* **Writes are cheap.**  A counter increment is a dict lookup plus a float
  add under an ``RLock``; handles are cached per ``(name, labels)`` so hot
  loops hold a bound handle and never re-resolve.
* **Cardinality is bounded.**  Label *names* come from code; label
  *values* must be short identifier-like tokens and each metric admits at
  most :data:`MAX_SERIES_PER_METRIC` distinct label sets.  Feeding an
  unbounded value (a raw graph digest, a request id) raises
  :class:`CardinalityError` instead of silently growing the registry —
  put unbounded identity in span attrs, never in metric labels.
* **Snapshots are values.**  :class:`Snapshot` is an immutable copy with
  ``delta``/``value``/``total`` arithmetic and a canonical JSON form, so
  tests diff snapshots instead of resetting global state under each
  other.
"""
from __future__ import annotations

import json
import re
import threading
from dataclasses import dataclass, field
from typing import Iterator, Optional

KINDS = ("counter", "gauge", "histogram")

MAX_SERIES_PER_METRIC = 64
_LABEL_VALUE_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.:+/-]{0,47}$")
_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_.]*$")


class CardinalityError(ValueError):
    """A metric label set would grow the registry without bound."""


def _labelkey(labels: Optional[dict]) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclass
class _Series:
    kind: str
    value: float = 0.0
    # histogram moments (running; no buckets — min/max/count/sum answer
    # every question the gates and benchmarks ask without bucket config)
    count: int = 0
    min: float = float("inf")
    max: float = float("-inf")

    def observe(self, x: float) -> None:
        self.count += 1
        self.value += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    def stats(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": self.count, "sum": self.value,
                "min": self.min, "max": self.max,
                "mean": self.value / self.count}

    def zero(self) -> None:
        self.value = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")


class _Handle:
    """A bound (name, labels) series; cached, safe to hold across resets."""

    __slots__ = ("_series", "_lock", "name", "labels")

    def __init__(self, series: _Series, lock: threading.RLock,
                 name: str, labels: tuple):
        self._series = series
        self._lock = lock
        self.name = name
        self.labels = labels

    @property
    def value(self) -> float:
        with self._lock:
            return self._series.value


class Counter(_Handle):
    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._series.value += n


class Gauge(_Handle):
    def set(self, v: float) -> None:
        with self._lock:
            self._series.value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._series.value += n


class Histogram(_Handle):
    def observe(self, x: float) -> None:
        with self._lock:
            self._series.observe(float(x))

    @property
    def stats(self) -> dict:
        with self._lock:
            return self._series.stats()


@dataclass(frozen=True)
class Sample:
    """One immutable series reading inside a :class:`Snapshot`."""

    name: str
    labels: tuple           # sorted ((k, v), ...) pairs
    kind: str
    value: float            # counter/gauge value; histogram sum
    count: int = 0          # histogram observation count
    min: float = 0.0
    max: float = 0.0

    def as_dict(self) -> dict:
        d = {"labels": dict(self.labels), "kind": self.kind,
             "value": self.value}
        if self.kind == "histogram":
            d["count"] = self.count
            if self.count:
                d.update(min=self.min, max=self.max,
                         mean=self.value / self.count)
        return d


class Snapshot:
    """An immutable point-in-time copy of the registry.

    ``snapshot.value(name, labels)`` reads one series (0 if absent),
    ``snapshot.total(name)`` sums a metric across label sets, and
    ``later.delta(earlier)`` subtracts counters/histograms (gauges keep
    their later reading) — the primitive every execution-shape gate is
    built on.  ``to_json``/``from_json`` round-trip exactly.
    """

    def __init__(self, samples: dict):
        self._samples: dict[tuple, Sample] = samples

    def __iter__(self) -> Iterator[Sample]:
        return iter(sorted(self._samples.values(),
                           key=lambda s: (s.name, s.labels)))

    def __len__(self) -> int:
        return len(self._samples)

    def value(self, name: str, labels: Optional[dict] = None,
              default: float = 0.0) -> float:
        s = self._samples.get((name, _labelkey(labels)))
        return s.value if s is not None else default

    def count(self, name: str, labels: Optional[dict] = None) -> int:
        s = self._samples.get((name, _labelkey(labels)))
        return s.count if s is not None else 0

    def total(self, name: str) -> float:
        return sum(s.value for s in self._samples.values()
                   if s.name == name)

    def delta(self, earlier: "Snapshot") -> "Snapshot":
        out: dict[tuple, Sample] = {}
        for key, s in self._samples.items():
            prev = earlier._samples.get(key)
            if s.kind == "gauge":
                d = s
            elif prev is None:
                d = s
            else:
                d = Sample(s.name, s.labels, s.kind,
                           s.value - prev.value, s.count - prev.count,
                           s.min, s.max)
            if d.value != 0.0 or d.count != 0:
                out[key] = d
        return Snapshot(out)

    def as_dict(self) -> dict:
        """Canonical nested form ``{metric: [sample, ...]}`` (sorted)."""
        out: dict[str, list] = {}
        for s in self:
            out.setdefault(s.name, []).append(s.as_dict())
        return out

    def flat(self) -> dict:
        """Compact one-level form ``{"name{k=v,...}": value}`` — counters
        and gauges map to their value, histograms to ``[count, sum]``.
        This is the form embedded in span records."""
        out = {}
        for s in self:
            key = s.name if not s.labels else (
                s.name + "{" + ",".join(f"{k}={v}" for k, v in s.labels)
                + "}")
            out[key] = [s.count, s.value] if s.kind == "histogram" \
                else s.value
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.as_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Snapshot":
        samples: dict[tuple, Sample] = {}
        for name, entries in json.loads(text).items():
            for e in entries:
                labels = _labelkey(e.get("labels"))
                samples[(name, labels)] = Sample(
                    name, labels, e["kind"], e["value"],
                    e.get("count", 0), e.get("min", 0.0), e.get("max", 0.0))
        return cls(samples)


class Capture:
    """Context-scoped metric capture: deltas since ``__enter__``.

    The registry-native replacement for the ``STATS.reset()`` footgun —
    two tests (or two threads) capturing concurrently cannot clobber each
    other because neither mutates shared state::

        with obs.capture() as cap:
            rt.mis2(g, engine="compacted_resident")
        assert cap.value("mis2.resident_dispatches") == 1
    """

    def __init__(self, registry: "MetricsRegistry"):
        self._registry = registry
        self._base: Optional[Snapshot] = None
        self._final: Optional[Snapshot] = None

    def __enter__(self) -> "Capture":
        self._base = self._registry.snapshot()
        return self

    def __exit__(self, *exc) -> None:
        self._final = self._registry.snapshot().delta(self._base)

    def delta(self) -> Snapshot:
        if self._final is not None:
            return self._final
        if self._base is None:
            raise RuntimeError("capture() used outside its with-block")
        return self._registry.snapshot().delta(self._base)

    def value(self, name: str, labels: Optional[dict] = None) -> float:
        return self.delta().value(name, labels)

    def count(self, name: str, labels: Optional[dict] = None) -> int:
        return self.delta().count(name, labels)

    def total(self, name: str) -> float:
        return self.delta().total(name)


@dataclass
class MetricsRegistry:
    """Thread-safe registry of named, labeled metric series."""

    max_series_per_metric: int = MAX_SERIES_PER_METRIC
    _lock: threading.RLock = field(default_factory=threading.RLock)
    _series: dict = field(default_factory=dict)     # (name, labelkey) -> _Series
    _kinds: dict = field(default_factory=dict)      # name -> kind
    _handles: dict = field(default_factory=dict)    # (name, labelkey) -> _Handle

    def _resolve(self, name: str, labels: Optional[dict], kind: str,
                 cls) -> _Handle:
        key = (name, _labelkey(labels))
        handle = self._handles.get(key)
        if handle is not None:
            if self._kinds[name] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{self._kinds[name]}, not {kind}")
            return handle
        with self._lock:
            handle = self._handles.get(key)
            if handle is not None:
                return handle
            if not _NAME_RE.match(name):
                raise ValueError(f"bad metric name {name!r}")
            prev_kind = self._kinds.setdefault(name, kind)
            if prev_kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {prev_kind}, "
                    f"not {kind}")
            for _, v in key[1]:
                if not _LABEL_VALUE_RE.match(v):
                    raise CardinalityError(
                        f"label value {v!r} on {name!r} is not a bounded "
                        "identifier (put unbounded identity — digests, "
                        "request ids — in span attrs, not metric labels)")
            n_series = sum(1 for (n, _) in self._series if n == name)
            if n_series >= self.max_series_per_metric:
                raise CardinalityError(
                    f"metric {name!r} exceeds {self.max_series_per_metric} "
                    "label sets — a label value is unbounded")
            series = self._series[key] = _Series(kind)
            handle = self._handles[key] = cls(series, self._lock, name,
                                              key[1])
            return handle

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        return self._resolve(name, labels, "counter", Counter)

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        return self._resolve(name, labels, "gauge", Gauge)

    def histogram(self, name: str,
                  labels: Optional[dict] = None) -> Histogram:
        return self._resolve(name, labels, "histogram", Histogram)

    # -- reading ------------------------------------------------------------

    def snapshot(self) -> Snapshot:
        with self._lock:
            return Snapshot({
                key: Sample(key[0], key[1], s.kind, s.value, s.count,
                            s.min, s.max)
                for key, s in self._series.items()})

    def capture(self) -> Capture:
        return Capture(self)

    # -- scoping ------------------------------------------------------------

    def reset(self, prefix: Optional[str] = None) -> None:
        """Zero every series (or those whose name starts with ``prefix``).

        Series objects stay alive so cached handles (and the legacy stats
        shims built on them) remain valid.  Prefer :meth:`capture` in
        tests — reset is process-global and order-dependent by nature.
        """
        with self._lock:
            for (name, _), s in self._series.items():
                if prefix is None or name.startswith(prefix):
                    s.zero()


# The process-wide registry.  Import as ``from repro_torch import obs`` and
# use ``obs.metrics`` — everything in the port writes here.
metrics = MetricsRegistry()
