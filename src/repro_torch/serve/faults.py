"""Deterministic seeded fault injection + the retry/fallback policy (a copy
of the JAX package's ``repro.serve.faults``, with the port's engine names).

A :class:`FaultPlan` names *sites* — fixed points in the serving code
where a failure can be injected — and gives each one a :class:`Fault`
descriptor (kind, rate, firing budget).  Sampling is a per-site seeded
``numpy`` stream derived from ``(seed, sha256(site))``, so a plan is
fully deterministic: the same seed and the same visit sequence fire the
same faults, which is what lets the chaos tests assert exact
retry/fallback/corruption counts instead of flaky probabilistic bounds.

Named sites (the serving code consults exactly these):

========================  ====================================================
``dispatch``              before a batch dispatch (``slow`` models a stalled
                          device queue; ``error`` a dispatch-path crash)
``engine``                around the primary engine compute (``error`` with
                          ``transient=True`` models a recoverable engine
                          blip -> retried; ``transient=False`` a persistent
                          failure -> immediate fallback)
``repair``                inside streaming incremental repair (``error``
                          degrades the delta to a from-scratch recompute)
``persist_write``         persistent-cache commit (simulated crash: the tmp
                          directory is left behind, nothing is committed)
``persist_corrupt``       persistent-cache payload bytes flipped on write
                          (digest re-verification must drop the entry on load)
========================  ====================================================

Every firing increments ``serve.faults.injected{site}`` so chaos runs
leave an auditable trail next to the retry/fallback/shed counters they
provoke.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..obs import metrics as _OBS
from .errors import ServeError

FAULT_KINDS = ("error", "slow", "corrupt")


class InjectedFault(ServeError):
    """An exception raised by a ``kind="error"`` fault at a named site."""

    reason = "injected"

    def __init__(self, site: str, transient: bool = True):
        super().__init__(f"injected fault at site {site!r} "
                         f"({'transient' if transient else 'persistent'})")
        self.site = site
        self.transient = transient
        self.retryable = transient


@dataclass(frozen=True)
class Fault:
    """One site's failure mode.

    ``rate`` is the per-visit firing probability (1.0 = every visit);
    ``count`` caps total firings (None = unlimited) — ``count=1`` with
    ``rate=1.0`` is the deterministic "fail exactly once, then recover"
    shape most retry tests want.  ``transient`` only matters for
    ``error`` faults: transient errors are retried under the
    :class:`RetryPolicy`, persistent ones go straight to fallback.
    ``delay_s`` only matters for ``slow`` faults.
    """

    kind: str
    rate: float = 1.0
    count: Optional[int] = None
    transient: bool = True
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {FAULT_KINDS}")


class FaultPlan:
    """Seeded, thread-safe fault injector over named sites.

    ``sites`` maps site name -> :class:`Fault`.  ``fired`` exposes the
    per-site firing counts (the deterministic trail tests assert on).
    """

    def __init__(self, seed: int = 0, sites: Optional[dict] = None):
        self.seed = int(seed)
        self.sites: dict[str, Fault] = dict(sites or {})
        self.fired: dict[str, int] = {}
        self._rngs: dict[str, np.random.Generator] = {}
        self._lock = threading.Lock()

    def _rng(self, site: str) -> np.random.Generator:
        rng = self._rngs.get(site)
        if rng is None:
            # stable per-site stream: independent of dict order and of
            # visits to other sites, so firing sequences are reproducible
            tag = int.from_bytes(
                hashlib.sha256(site.encode()).digest()[:4], "big")
            rng = self._rngs[site] = np.random.default_rng([self.seed, tag])
        return rng

    def should_fire(self, site: str) -> Optional[Fault]:
        """Consume one visit at ``site``; return the Fault iff it fires."""
        fault = self.sites.get(site)
        if fault is None:
            return None
        with self._lock:
            if fault.count is not None and \
                    self.fired.get(site, 0) >= fault.count:
                return None
            rng = self._rng(site)
            hit = fault.rate >= 1.0 or rng.random() < fault.rate
            if not hit:
                return None
            self.fired[site] = self.fired.get(site, 0) + 1
        _OBS.counter("serve.faults.injected", labels={"site": site}).inc()
        return fault

    def fire(self, site: str) -> None:
        """Inject at ``site``: sleep for ``slow`` faults, raise
        :class:`InjectedFault` for ``error`` faults.  ``corrupt`` faults
        are polled by their call site via :meth:`corrupts` instead."""
        fault = self.should_fire(site)
        if fault is None or fault.kind == "corrupt":
            return
        if fault.kind == "slow":
            time.sleep(fault.delay_s)
            return
        raise InjectedFault(site, transient=fault.transient)

    def corrupts(self, site: str) -> bool:
        """True iff a ``corrupt`` fault fires at ``site`` on this visit."""
        fault = self.sites.get(site)
        if fault is None or fault.kind != "corrupt":
            return False
        return self.should_fire(site) is not None


@dataclass(frozen=True)
class RetryPolicy:
    """Retry/fallback semantics for a failed dispatch.

    *Transient* engine failures (``InjectedFault(transient=True)`` — the
    recoverable-blip model) are retried up to ``max_attempts`` total
    attempts with capped exponential backoff.  Any other engine failure,
    or an exhausted retry budget, degrades to the **fallback engine** —
    except a CUDA kernel's build or launch error and a CUDA runtime error,
    which the server resolves with ``EngineFailure`` (a fault of the card
    or of a kernel is never hidden behind another engine's answer) —
    the host/dense referent every parity gate in the repo anchors on
    (``mis2 -> dense``, ``amg_setup -> host``, coloring/coarsening -> the
    default facade path).  Fallback results flow through the same digest
    ledger as every response, so degraded answers are held to the same
    bit-identity contract.
    """

    max_attempts: int = 3
    base_backoff_s: float = 0.001
    max_backoff_s: float = 0.05
    fallback: bool = True

    def backoff_s(self, attempt: int) -> float:
        """Capped exponential backoff before retry number ``attempt``
        (1-based)."""
        return min(self.max_backoff_s,
                   self.base_backoff_s * (2.0 ** (attempt - 1)))


#: the engine-contract referent each kind degrades to on the CPU (None =
#: the facade default path, which on a failure of an explicit engine is
#: itself the fallback); a request on the card degrades to the card's
#: default engine
FALLBACK_ENGINES = {
    "mis2": "dense",
    "amg_setup": "host",
    "color": None,
    "coarsen": None,
}
