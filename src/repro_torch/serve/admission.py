"""Admission control: bounded queue, per-caller quotas, deadline shedding
(a copy of the JAX package's ``repro.serve.admission``).

A server that accepts everything lets the Poisson p99 run away once
offered load passes batched capacity — the queue grows without bound and
every request eventually "succeeds", seconds late.  Admission control
inverts that: requests the server cannot serve *well* are failed *fast*
with a typed error at submit time, so callers see backpressure instead of
latency.

Three independent checks, applied to every cache-missing submit (cache
hits are served unconditionally — they cost a dict lookup):

1. **Per-caller token bucket** (:class:`QuotaConfig`): each caller
   refills at ``rate`` tokens/sec up to ``burst``; a submit costs one
   token; an empty bucket raises :class:`~repro_torch.serve.errors.QuotaExceeded`.
   One hot caller cannot starve the rest of the queue.
2. **Bounded queue**: more than ``max_pending`` queued requests raises
   :class:`~repro_torch.serve.errors.ServerOverloaded`.  Requests *joining* an
   in-flight computation (dedup) skip this check — they add zero queue
   pressure.
3. **Deadline feasibility**: a request whose ``deadline_s`` is already
   spent, or smaller than the EWMA-estimated queue wait, raises
   :class:`~repro_torch.serve.errors.DeadlineExceeded` immediately instead of
   queueing work that will be evicted unserved.

The controller is pure policy — it raises, the server counts
(``serve.shed{reason=...}``).  The clock is injectable so quota refill is
unit-testable without sleeping.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

from .errors import DeadlineExceeded, QuotaExceeded, ServerOverloaded

#: callers tracked before the least-recently-*used* bucket is recycled (a
#: caller id is a caller-chosen string; an unbounded set must not grow
#: server memory).  LRU, not FIFO: an active caller's bucket is refreshed
#: on every submit, so churn in one-shot caller ids cannot evict a hot
#: caller and hand it a fresh bucket at full burst
MAX_TRACKED_CALLERS = 4096


@dataclass(frozen=True)
class QuotaConfig:
    """Per-caller token-bucket quota: ``rate`` tokens/sec refill, up to
    ``burst`` capacity; every admitted submit costs one token."""

    rate: float = 50.0
    burst: float = 100.0

    def __post_init__(self):
        if self.rate < 0 or self.burst <= 0:
            raise ValueError("quota needs rate >= 0 and burst > 0")


class TokenBucket:
    """The classic leaky-bucket dual: continuous refill, capped at burst."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.last = now

    def try_take(self, now: float, n: float = 1.0) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + max(0.0, now - self.last) * self.rate)
        self.last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class AdmissionController:
    """Stateful admission policy for one server (not thread-safe on its
    own; the server serializes access under its lock).

    ``denials`` exposes per-caller quota-denial counts for the
    ``server_stats()`` dashboard view — per-caller identity deliberately
    stays *out* of metric labels (an unbounded caller set would trip the
    registry's cardinality bound); the process-wide aggregate is
    ``serve.shed{reason=quota}``.
    """

    def __init__(self, max_pending: Optional[int] = None,
                 quota: Optional[QuotaConfig] = None,
                 clock=time.perf_counter):
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        self.max_pending = max_pending
        self.quota = quota
        self.clock = clock
        self._buckets: OrderedDict[str, TokenBucket] = OrderedDict()
        self.denials: dict[str, int] = {}

    def admit(self, *, caller: str = "default", pending: int = 0,
              deadline_s: Optional[float] = None,
              est_wait_s: Optional[float] = None,
              joining: bool = False) -> None:
        """Raise a typed error if the request must be shed; else return.

        ``pending`` is the current queue depth, ``est_wait_s`` the
        server's EWMA queue-wait estimate (None until it has data), and
        ``joining`` marks a dedup join (no new queue pressure: the
        bounded-queue and wait-estimate checks are skipped, the quota
        still charges — rate limits meter callers, not computes).
        """
        now = self.clock()
        if self.quota is not None:
            bucket = self._buckets.get(caller)
            if bucket is None:
                if len(self._buckets) >= MAX_TRACKED_CALLERS:
                    self._buckets.popitem(last=False)   # least recently used
                bucket = self._buckets[caller] = TokenBucket(
                    self.quota.rate, self.quota.burst, now)
            else:
                self._buckets.move_to_end(caller)       # LRU refresh
            if not bucket.try_take(now):
                self.denials[caller] = self.denials.get(caller, 0) + 1
                raise QuotaExceeded(
                    f"caller {caller!r} exhausted its token bucket "
                    f"(rate={self.quota.rate}/s, burst={self.quota.burst})")
        if deadline_s is not None and deadline_s <= 0:
            raise DeadlineExceeded(
                f"deadline_s={deadline_s} already expired at submit")
        if joining:
            return
        if self.max_pending is not None and pending >= self.max_pending:
            raise ServerOverloaded(
                f"{pending} requests pending >= max_pending="
                f"{self.max_pending}; resubmit after backoff")
        if deadline_s is not None and est_wait_s is not None \
                and deadline_s < est_wait_s:
            raise DeadlineExceeded(
                f"deadline_s={deadline_s:.4f} below the estimated queue "
                f"wait {est_wait_s:.4f}s — shedding instead of queueing "
                "work that would expire unserved")
