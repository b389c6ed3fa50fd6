"""``repro_torch.serve`` — persistent graph service over the ``repro_torch``
facade (the port of the JAX package's ``repro.serve``).

Continuous batching (deadline-or-full coalescing into ``GraphBatch``
buckets), a digest-keyed LRU result cache whose hits are bit-identical to
recomputation (with an optional digest-verified disk tier that survives
restarts), a warm registry that builds the kernels and warms the
configured bucket shapes at startup, and a streaming update mode with
exact incremental MIS-2 repair.

The hardened request path adds in-flight dedup (one compute per unique
``(kind, digest, engine, options)`` key), admission control (bounded
queue, per-caller quotas, deadline-aware shedding with typed errors), and
a retry/fallback policy under deterministic seeded fault injection —
every response is a digest-correct ``Result`` or a typed
:class:`~repro_torch.serve.errors.ServeError`; nothing hangs, nothing
lies.  A CUDA kernel's build or launch error is never degraded to a
fallback engine: it resolves the request with ``EngineFailure``.

    from repro_torch.serve import Server, ServerConfig

    srv = Server(ServerConfig(warm_buckets=((256, 8),)))
    fut = srv.submit("mis2", graph)
    srv.flush()                      # or srv.start() for a live pump
    result = fut.result()            # bit-identical to repro_torch.mis2(graph)
"""
from .admission import AdmissionController, QuotaConfig, TokenBucket
from .batcher import Batcher, PendingRequest
from .cache import CacheParityError, CacheStats, ResultCache
from .errors import (DeadlineExceeded, DigestMismatch, EngineFailure,
                     LayoutInfeasible, QuotaExceeded, ServeError,
                     ServerClosed, ServerOverloaded)
from .faults import (FALLBACK_ENGINES, Fault, FaultPlan, InjectedFault,
                     RetryPolicy)
from .persist import PersistStats, PersistTier
from .server import KINDS, Server, ServerConfig, ServeStats, warm_buckets_for
from .streaming import RepairStats, StreamSession
from .warm import WarmRegistry, WarmSpec

__all__ = [
    "Server", "ServerConfig", "ServeStats", "KINDS", "warm_buckets_for",
    "ResultCache", "CacheStats", "CacheParityError",
    "PersistTier", "PersistStats",
    "WarmRegistry", "WarmSpec",
    "Batcher", "PendingRequest",
    "StreamSession", "RepairStats",
    "AdmissionController", "QuotaConfig", "TokenBucket",
    "ServeError", "ServerClosed", "ServerOverloaded", "QuotaExceeded",
    "DeadlineExceeded", "EngineFailure", "DigestMismatch",
    "LayoutInfeasible",
    "Fault", "FaultPlan", "InjectedFault", "RetryPolicy",
    "FALLBACK_ENGINES",
]
