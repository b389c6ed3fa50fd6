"""Structured span tracing: nested wall-time scopes with metric deltas (a
copy of the JAX package's ``repro.obs.spans``, fenced with torch).

A span is a named ``with`` scope that records wall time
(``time.perf_counter``), arbitrary attrs, child spans, and the *metric
deltas* that occurred inside it: resident dispatches, in-loop host syncs,
conversions, multilevel stage calls.  Spans nest per-thread; the facade
opens a root span per call and attaches its serialized tree to the
returned ``Result`` as a :class:`Provenance` record, so any answer can
explain its own cost::

    r = rt.mis2(g)
    r.provenance.span["duration_s"]            # wall time
    r.provenance.span["metrics"]               # execution-shape deltas
    json.dumps(r.provenance.as_dict())         # fully serializable

Device timing: pass ``fence=<tensors>`` and the span synchronizes the
CUDA devices they live on before closing, so ``duration_s`` covers device
execution rather than the enqueue.  Every closed span also lands one
observation in the ``span.seconds{span=<name>}`` histogram (names are
code-defined, so cardinality stays bounded).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

from .registry import metrics as _metrics

_TLS = threading.local()
_RECENT_ROOTS: deque = deque(maxlen=64)

_SCALARS = (str, int, float, bool, type(None))


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _synchronize(fence) -> None:
    """Wait for the CUDA devices holding the tensors of ``fence`` (one
    tensor or an iterable of them; CPU tensors need no wait)."""
    import torch

    tensors = [fence] if isinstance(fence, torch.Tensor) else list(fence)
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(dev)


@dataclass
class Span:
    """One recorded scope: name, attrs, wall time, children, metric deltas."""

    name: str
    attrs: dict = field(default_factory=dict)
    start_s: float = 0.0
    duration_s: float = 0.0
    metrics: dict = field(default_factory=dict)   # flat nonzero deltas
    children: list = field(default_factory=list)

    def annotate(self, **attrs) -> "Span":
        """Attach attrs discovered mid-scope (iteration counts, digests)."""
        self.attrs.update({k: v if isinstance(v, _SCALARS) else str(v)
                           for k, v in attrs.items()})
        return self

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "attrs": dict(self.attrs),
            "duration_s": self.duration_s,
            "metrics": dict(self.metrics),
            "children": [c.to_dict() for c in self.children],
        }


@contextmanager
def span(name: str, *, fence=None, **attrs):
    """Open a nested tracing scope; yields the live :class:`Span`.

    ``fence`` (optional tensor or iterable of tensors) is synchronized on
    before the span closes so the duration covers device execution.
    Keyword attrs are serialized into the record (non-scalars via
    ``str``).
    """
    base = _metrics.snapshot()
    sp = Span(name,
              {k: v if isinstance(v, _SCALARS) else str(v)
               for k, v in attrs.items()},
              time.perf_counter())
    stack = _stack()
    parent = stack[-1] if stack else None
    stack.append(sp)
    try:
        yield sp
    finally:
        if fence is not None:
            _synchronize(fence)
        sp.duration_s = time.perf_counter() - sp.start_s
        sp.metrics = _metrics.snapshot().delta(base).flat()
        stack.pop()
        if parent is not None:
            parent.children.append(sp)
        else:
            _RECENT_ROOTS.append(sp)
        _metrics.histogram("span.seconds",
                           labels={"span": name}).observe(sp.duration_s)


def current_span() -> Optional[Span]:
    """The innermost open span on this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def recent_spans(n: int = 10) -> list:
    """The last ``n`` closed *root* spans (process-wide, bounded buffer)."""
    return list(_RECENT_ROOTS)[-n:]


@dataclass
class Provenance:
    """Serializable cost record attached to every facade ``Result``.

    ``span`` is the root :class:`Span` tree as a plain dict (wall time +
    metric deltas per scope); ``digest`` ties the record to the payload it
    explains, so a provenance pulled out of a cache or a log can always be
    matched back to its answer.
    """

    kind: str                    # facade entry: mis2 | color | amg_setup...
    engine: str
    backend: str                 # executing platform (cpu | gpu)
    digest: str
    span: dict = field(default_factory=dict)

    @property
    def wall_time_s(self) -> float:
        return self.span.get("duration_s", 0.0)

    @property
    def metrics(self) -> dict:
        """Flat metric deltas attributed to this call (root-span scope)."""
        return self.span.get("metrics", {})

    def as_dict(self) -> dict:
        return {"kind": self.kind, "engine": self.engine,
                "backend": self.backend, "digest": self.digest,
                "span": self.span}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.as_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Provenance":
        return cls(**json.loads(text))
