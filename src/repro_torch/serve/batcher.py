"""Request queue + continuous batcher: deadline-or-full group dispatch (a
copy of the JAX package's ``repro.serve.batcher``).

Requests accumulate in *groups* — one per (kind, options, requested
engine, placement) coalescing key — and a group dispatches as one batched
call when it reaches ``max_batch`` members (full) or its oldest member
has waited ``max_delay_s`` (deadline).  That is the classic continuous-
batching contract: an isolated request pays at most the latency budget,
a burst is coalesced into the batched bucket pipelines (``repro_torch.
batch``) at full occupancy.

Only auto-engine requests (``engine=None``) coalesce freely: an explicit
engine is a caller's statement about *how* to execute, so those requests
group per engine and dispatch through the single-graph facade path.
Results are bit-identical either way (the repo invariant) — grouping
affects throughput, never bytes.

Per-request deadlines: a request may carry an absolute ``deadline`` (same
timebase as ``now``).  :meth:`Batcher.pop_expired` evicts expired requests
*before* they can be dispatched — the server fails them with
``DeadlineExceeded`` and the engine never burns compute on an answer
nobody is waiting for.  ``next_deadline`` accounts for both the batching
latency budget and the earliest request deadline, so the pump loop wakes
in time to evict.

Timebase: every entry point takes an explicit ``now`` so tests drive the
deadline logic with a manual clock; the server passes
``time.perf_counter()``.
"""
from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class PendingRequest:
    """One queued request (kind + graph + normalized parameters)."""

    kind: str
    graph: Any                      # repro_torch Graph handle
    params: dict                    # kind-specific kwargs (normalized)
    engine: Optional[str]           # None = auto-select per request backend
    backend: Any                    # Backend or None
    cache_key: tuple
    future: Future = field(default_factory=Future)
    enqueued_at: float = 0.0
    deadline: Optional[float] = None    # absolute, server clock; None = none
    caller: str = "default"             # admission-control caller identity


def _freeze(obj) -> tuple:
    """Canonical hashable token for options/params of any supported shape."""
    import dataclasses

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, _freeze(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)


def group_key(req: PendingRequest) -> tuple:
    """The coalescing key: requests sharing it may dispatch as one batch."""
    placement = id(req.backend.device) if (
        req.backend is not None and req.backend.device is not None) else None
    return (req.kind, _freeze(req.params),
            req.engine if req.engine is not None else "auto", placement)


class Batcher:
    """Accumulates PendingRequests into dispatch groups (not thread-safe;
    the server serializes access under its own lock)."""

    def __init__(self, max_batch: int = 8, max_delay_s: float = 0.01):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self._groups: dict[tuple, list[PendingRequest]] = {}

    def __len__(self) -> int:
        return sum(len(g) for g in self._groups.values())

    def add(self, req: PendingRequest, now: float) -> None:
        req.enqueued_at = now
        self._groups.setdefault(group_key(req), []).append(req)

    def due(self, now: float, force: bool = False
            ) -> list[tuple[tuple, list[PendingRequest]]]:
        """Pop and return every group that must dispatch now.

        Full groups always dispatch (chunked to ``max_batch``); a partial
        group dispatches once its oldest member has waited out the latency
        budget, or unconditionally under ``force`` (flush/shutdown).
        """
        out: list[tuple[tuple, list[PendingRequest]]] = []
        for key in list(self._groups):
            reqs = self._groups[key]
            while len(reqs) >= self.max_batch:
                out.append((key, reqs[: self.max_batch]))
                reqs = reqs[self.max_batch:]
            expired = reqs and (now - reqs[0].enqueued_at >= self.max_delay_s)
            if reqs and (force or expired):
                out.append((key, reqs))
                reqs = []
            if reqs:
                self._groups[key] = reqs
            else:
                del self._groups[key]
        return out

    def pop_expired(self, now: float) -> list[PendingRequest]:
        """Remove and return every queued request whose deadline passed.

        Called by the pump before :meth:`due` so expired work is never
        dispatched — the server fails these futures with a typed
        ``DeadlineExceeded`` instead of computing answers late.
        """
        expired: list[PendingRequest] = []
        for key in list(self._groups):
            reqs = self._groups[key]
            keep = [r for r in reqs
                    if r.deadline is None or r.deadline > now]
            if len(keep) != len(reqs):
                expired.extend(r for r in reqs
                               if r.deadline is not None
                               and r.deadline <= now)
                if keep:
                    self._groups[key] = keep
                else:
                    del self._groups[key]
        return expired

    def drain(self) -> list[PendingRequest]:
        """Remove and return everything still queued (terminal shutdown:
        the server fails these with ``ServerClosed``)."""
        out = [r for reqs in self._groups.values() for r in reqs]
        self._groups.clear()
        return out

    def next_deadline(self, now: float) -> Optional[float]:
        """Seconds until the earliest pending event — a group's batching
        deadline or a request's own deadline, whichever comes first
        (None if empty)."""
        marks = [reqs[0].enqueued_at + self.max_delay_s
                 for reqs in self._groups.values() if reqs]
        marks.extend(r.deadline for reqs in self._groups.values()
                     for r in reqs if r.deadline is not None)
        if not marks:
            return None
        return max(0.0, min(marks) - now)
