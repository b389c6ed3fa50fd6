"""Snapshot exporters: Prometheus text exposition and canonical JSON.

Both operate on :class:`~repro_torch.obs.registry.Snapshot` values, so a scrape
is just ``to_prometheus(obs.snapshot())`` — no live-registry traversal,
no locking on the scrape path, and the same snapshot can be diffed by a
gate and exported to a dashboard without re-reading.
"""
from __future__ import annotations

from .registry import Snapshot

_PROM_HELP = {
    "counter": "counter",
    "gauge": "gauge",
    # no bucket config: histograms export the summary-style _count/_sum
    # (+ _min/_max gauges), which is what the gates and dashboards consume
    "histogram": "summary",
}


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _prom_labels(labels: tuple) -> str:
    if not labels:
        return ""
    quoted = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + quoted + "}"


def to_prometheus(snapshot: Snapshot, prefix: str = "repro_") -> str:
    """Render a snapshot in the Prometheus text exposition format."""
    lines: list[str] = []
    seen_type: set[str] = set()
    for s in snapshot:
        base = prefix + _prom_name(s.name)
        if base not in seen_type:
            seen_type.add(base)
            lines.append(f"# TYPE {base} {_PROM_HELP[s.kind]}")
        lab = _prom_labels(s.labels)
        if s.kind == "histogram":
            lines.append(f"{base}_count{lab} {s.count}")
            lines.append(f"{base}_sum{lab} {_fmt(s.value)}")
            if s.count:
                lines.append(f"{base}_min{lab} {_fmt(s.min)}")
                lines.append(f"{base}_max{lab} {_fmt(s.max)}")
        else:
            lines.append(f"{base}{lab} {_fmt(s.value)}")
    return "\n".join(lines) + "\n"


def _fmt(x: float) -> str:
    return str(int(x)) if float(x).is_integer() else repr(float(x))


def to_json(snapshot: Snapshot, indent: int = 2) -> str:
    """Canonical JSON form (round-trips through ``Snapshot.from_json``)."""
    return snapshot.to_json(indent=indent)


def from_json(text: str) -> Snapshot:
    return Snapshot.from_json(text)
