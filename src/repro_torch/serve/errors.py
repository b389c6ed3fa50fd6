"""Typed error taxonomy for ``repro_torch.serve`` (a copy of the JAX
package's ``repro.serve.errors``).

Every way a served request can fail maps to exactly one exception class
here, so callers can branch on type instead of parsing messages, and the
failure-mode matrix in API.md is checkable: each class carries

* ``reason``     the bounded token used as the ``serve.shed{reason=...}``
  metric label (admission-path errors) — one place ties the exception a
  caller sees to the counter an operator watches;
* ``retryable``  whether resubmitting the same request later can succeed
  (``ServerOverloaded``/``QuotaExceeded``: yes, pressure subsides;
  ``DeadlineExceeded``: only with a fresh deadline; ``ServerClosed``:
  only against a new server; parity/ledger violations: never — they
  indicate a determinism bug, not a transient condition).

The hardening contract (tests/test_torch_serve.py): under overload,
injected faults, and shutdown races, every submitted future resolves
either with a digest-correct ``Result`` or with one of these types —
never a hang, never a silent wrong answer.
"""
from __future__ import annotations


class ServeError(RuntimeError):
    """Base class for every typed serving failure."""

    reason: str = "error"
    retryable: bool = False


class ServerClosed(ServeError):
    """The server was stopped: queued futures are failed with this and
    every later ``submit`` returns a future already carrying it."""

    reason = "closed"
    retryable = False


class ServerOverloaded(ServeError):
    """Admission control shed the request: the bounded queue is full.
    Back off and resubmit — the queue drains at batched capacity."""

    reason = "overloaded"
    retryable = True


class QuotaExceeded(ServeError):
    """The caller's token bucket is empty (per-caller rate limit).
    Retry after the bucket refills (``QuotaConfig.rate`` tokens/sec)."""

    reason = "quota"
    retryable = True


class DeadlineExceeded(ServeError):
    """The request's deadline expired — at admission (the queue-wait
    estimate already exceeds it) or in the queue (evicted before
    dispatch; expired work is never dispatched)."""

    reason = "deadline"
    retryable = False


class LayoutInfeasible(ServeError):
    """Admission control shed the request because the engine it names (or
    defaults to) would materialize the monolithic padded-ELL layout, and
    the graph's ``[V, max_degree]`` bytes estimate exceeds
    ``repro_torch.graphs.handle.ELL_BYTE_LIMIT`` — the compute would die in
    an out-of-memory error after queueing, so it is refused up front with a typed error
    naming the fix.  Not retryable as-is: resubmit with a degree-aware
    engine (``mis2``/``coarsen`` with ``engine=None`` or
    ``'cuda_hybrid'``, ``color`` with ``'luby_hybrid'``), which handles
    exactly these skewed graphs."""

    reason = "layout"
    retryable = False


class EngineFailure(ServeError):
    """Compute failed after the retry budget and the fallback engine, or
    failed in a CUDA kernel's build or launch (never degraded to another
    engine).  The original engine error is chained as ``__cause__``."""

    reason = "engine"
    retryable = False


class DigestMismatch(ServeError):
    """A response's digest conflicts with the digest previously served
    for the same ``(kind, graph digest, engine, options)`` key.  The
    determinism invariant says equal keys produce bit-identical payloads,
    so a conflict means corruption or a determinism bug — the response is
    failed rather than served."""

    reason = "digest"
    retryable = False
