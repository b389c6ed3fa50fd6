"""The persistent graph service: one process, many callers, zero rebits
(the JAX package's ``repro.serve.server`` on the port's facade).

``Server`` accepts concurrent ``mis2`` / ``color`` / ``coarsen`` /
``amg_setup`` requests and serves every one with a result bit-identical
to the direct facade call — batching, caching, warm executables, request
dedup, and fallback engines are throughput/robustness machinery, never
semantics (the repo's determinism invariant is what makes every one of
those compositions safe).

Request path::

    submit() -> closed check (typed ServerClosed after stop())
             -> cache lookup (memory LRU, then digest-verified disk tier)
             -> admission control (quota / bounded queue / deadline
                feasibility -> typed shed errors)
             -> in-flight dedup (same-key concurrent requests join the
                primary's future; exactly one compute per unique key)
             -> batcher group (deadline-or-full continuous batching)
    pump()   -> expired-request eviction (never dispatched)
             -> batched dispatch over GraphBatch buckets, under the
                retry/fallback policy (transient faults retried with
                capped backoff; persistent failures degrade to the
                host/dense referent engine on the CPU, to the default
                engine on the card — but a real exception on the card, or
                a kernel's build or launch error, a CUDA runtime error or a
                device out-of-memory error anywhere, resolves the request
                with ``EngineFailure``: no fallback hides a fault of the
                card or of a kernel)
             -> digest ledger check -> cache insert + future resolution

The **digest ledger** is the last line of the robustness contract: the
server remembers the digest it served for each key and refuses (typed
``DigestMismatch``) to ever serve a second, different digest for the same
key — so retries, fallbacks, and rehydrated cache entries are all held to
the engine contract, not trusted.

``pump()`` is the explicit event-loop step (deterministic for tests and
CI); ``start()`` runs it on a daemon thread for real concurrent callers.
``stop()`` is terminal: queued futures fail with ``ServerClosed``, later
submits return already-failed futures — nothing ever hangs.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from ..api import facade
from ..api.backend import (
    Backend,
    backend_platform,
    default_mis2_engine,
    default_multilevel_engine,
    resolve_backend,
)
from ..api.result import Mis2Result
from ..batch.container import GraphBatch, bucket_shape
from ..batch.pipeline import _mis2_batch_impl
from ..core.coloring import MAX_ROUNDS_DEFAULT
from ..core.mis2 import Mis2Options
from ..graphs.handle import ELL_BYTE_LIMIT, as_graph
from ..kernels._build import KernelBuildError, KernelLaunchError
from ..obs import Provenance
from ..obs import metrics as _OBS
from ..obs import span as _obs_span
from .admission import AdmissionController, QuotaConfig
from .batcher import Batcher, PendingRequest, _freeze
from .cache import ResultCache
from .errors import (DeadlineExceeded, DigestMismatch, EngineFailure,
                     LayoutInfeasible, ServeError, ServerClosed)
from .faults import FALLBACK_ENGINES, FaultPlan, InjectedFault, RetryPolicy
from .persist import PersistTier
from .streaming import StreamSession
from .warm import WarmRegistry, WarmSpec

KINDS = ("mis2", "color", "coarsen", "amg_setup")

#: digest-ledger retention: enough for every key a long-lived server
#: plausibly serves, bounded so the ledger cannot grow without limit
LEDGER_CAP = 65536

#: the largest padded-ELL bytes estimate (``Graph.ell_bytes_estimate``) of
#: a graph that joins a batched dispatch; past it the graph runs alone on
#: the single-graph engines, which beat the batched fixed points there (on
#: an H100, ``tools/bench_serve_route.py`` with one batched launch a bucket:
#: batched wins every kind up to 32.8 MB a graph, loses ``mis2`` and ``color``
#: from 35.0 MB).  It lies below the hybrid layout's threshold, so no graph
#: that needs that layout joins a padded batch.
BATCH_MAX_ELL_BYTES = 32 << 20


@dataclass(frozen=True)
class ServerConfig:
    """Serving policy: batching budget, cache budget, warm shapes,
    admission limits, fault/retry semantics, persistence.

    ``warm_buckets`` lists ``(rows, width)`` bucket shapes (the
    ``repro_torch.batch`` power-of-two classes) to warm at startup at
    batch capacity ``max_batch`` for the configured mis2 options (the
    kernels built, one batched run on the device); live shapes outside the
    list still work, they are just counted as runtime compiles.  ``parity_fraction`` recomputes that fraction of cache hits
    and asserts digest equality; ``delta_check_fraction`` does the same
    for streaming repairs.

    Hardening knobs (all off by default, ``dedup`` aside):

    * ``dedup``              coalesce concurrent same-key requests onto
      one in-flight future (exactly one compute per unique key),
    * ``max_pending``        bounded queue; beyond it submits fail with
      ``ServerOverloaded`` (None = unbounded),
    * ``quota``              per-caller token-bucket rate limit
      (:class:`~repro_torch.serve.admission.QuotaConfig`; None = no
      quotas),
    * ``default_deadline_s`` deadline applied to requests that don't pass
      their own ``deadline_s`` (None = no deadline); expired queued work
      is evicted, never dispatched,
    * ``retry``              :class:`~repro_torch.serve.faults.RetryPolicy`
      for transient-fault retries and engine fallback,
    * ``faults``             a seeded
      :class:`~repro_torch.serve.faults.FaultPlan`
      for chaos runs (None in production),
    * ``persist_dir``        directory for the digest-verified disk cache
      tier (None = memory-only), ``persist_bytes`` its byte budget.

    ``backend`` places every request's graph (None: the process default
    backend, ``Backend()``, the card, unless another is installed).
    """

    max_batch: int = 8
    max_delay_s: float = 0.01
    cache_bytes: int = 64 << 20
    parity_fraction: float = 0.0
    warm_buckets: tuple = ()
    mis2_options: Optional[Mis2Options] = None
    delta_check_fraction: float = 0.0
    single_fast_path: bool = True
    backend: Optional[Backend] = None
    poll_interval_s: float = 0.002
    dedup: bool = True
    max_pending: Optional[int] = None
    quota: Optional[QuotaConfig] = None
    default_deadline_s: Optional[float] = None
    retry: RetryPolicy = RetryPolicy()
    faults: Optional[FaultPlan] = None
    persist_dir: Optional[str] = None
    persist_bytes: int = 256 << 20


@dataclass
class ServeStats:
    """Per-server counters, mirrored into the ``repro_torch.obs`` registry
    (``serve.requests`` / ``serve.dispatches`` / ``serve.batched_graphs``
    / ``serve.single_dispatches`` / ``serve.dedup_hits`` / ``serve.shed``
    / ``serve.expired`` / ``serve.retries`` / ``serve.fallbacks``).  All
    timestamps come from ``time.perf_counter()`` — the one clock every
    timing in this repo reports on (uptime windows, cache timings, span
    durations), so derived intervals are mutually comparable and
    monotone."""

    requests: int = 0
    dispatches: int = 0
    batched_graphs: int = 0
    single_dispatches: int = 0
    dedup_hits: int = 0
    shed: int = 0
    expired: int = 0
    retries: int = 0
    fallbacks: int = 0
    started_at: float = field(default_factory=time.perf_counter)
    window_started_at: float = field(default_factory=time.perf_counter)

    def bump(self, name: str, n: int = 1) -> None:
        setattr(self, name, getattr(self, name) + n)
        _OBS.counter(f"serve.{name}").inc(n)


def _device_fault(err: BaseException) -> bool:
    """A CUDA kernel's build or launch error, a CUDA runtime error or a
    device out-of-memory error anywhere in ``err``'s cause chain: never
    degraded to a fallback."""
    accel = getattr(torch, "AcceleratorError", ())
    while err is not None:
        if isinstance(err, (KernelBuildError, KernelLaunchError,
                            torch.OutOfMemoryError)) or (
                accel and isinstance(err, accel)) or (
                isinstance(err, RuntimeError) and "CUDA error" in str(err)):
            return True
        err = err.__cause__ or err.__context__
    return False


def _on_card(req: PendingRequest) -> bool:
    """Whether the request's graph lies on an accelerator."""
    return req.graph.device.type != "cpu"


class Server:
    """Persistent graph-algorithm service over the ``repro_torch`` facade."""

    def __init__(self, config: Optional[ServerConfig] = None):
        self.config = config if config is not None else ServerConfig()
        self.persist: Optional[PersistTier] = None
        if self.config.persist_dir is not None:
            self.persist = PersistTier(self.config.persist_dir,
                                       max_bytes=self.config.persist_bytes,
                                       faults=self.config.faults)
        self.cache = ResultCache(max_bytes=self.config.cache_bytes,
                                 parity_fraction=self.config.parity_fraction,
                                 persist=self.persist)
        self.batcher = Batcher(max_batch=self.config.max_batch,
                               max_delay_s=self.config.max_delay_s)
        self.admission = AdmissionController(
            max_pending=self.config.max_pending, quota=self.config.quota)
        self.warm = WarmRegistry()
        self.stats = ServeStats()
        # two-lock discipline: ``_lock`` guards queue/cache/ledger state
        # and is only ever held for O(bookkeeping); ``_dispatch_lock``
        # serializes the compute side of pump() (engine calls, retries,
        # backoff sleeps, injected slow faults) so a degraded dispatch
        # can never block submit() or cache-hit lookups
        self._lock = threading.RLock()
        self._dispatch_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        # key -> primary future, while queued-or-dispatching (dedup joins)
        self._inflight: dict[tuple, object] = {}
        # key -> digest already served for that key (never contradicted)
        self._ledger: OrderedDict[tuple, str] = OrderedDict()
        # EWMA of seconds per dispatch, for the admission wait estimate
        self._service_ewma: Optional[float] = None
        opts = self.config.mis2_options or Mis2Options()
        self.warm.warm((WarmSpec(self.config.max_batch, rows, width,
                                 opts.priority, opts.max_iters)
                        for rows, width in self.config.warm_buckets),
                       resolve_backend(self.config.backend).resolve_device())

    # -- request intake -----------------------------------------------------

    def _normalize(self, kind: str, params: dict) -> dict:
        if kind == "mis2":
            options = params.get("options")
            if options is None:
                options = self.config.mis2_options or Mis2Options()
            return {"options": options}
        if kind == "color":
            return {"max_rounds": params.get("max_rounds",
                                             MAX_ROUNDS_DEFAULT)}
        if kind == "coarsen":
            return {"method": params.get("method", "two_phase"),
                    "options": params.get("options"),
                    "min_secondary_neighbors":
                        params.get("min_secondary_neighbors", 2)}
        if kind == "amg_setup":
            out = dict(params)
            out.setdefault("aggregation", "two_phase")
            return out
        raise ValueError(f"unknown request kind {kind!r} (one of {KINDS})")

    #: engines per kind that never materialize the monolithic padded ELL
    #: (``None`` = auto-selection, which routes past HYBRID_AUTO_BYTES to
    #: the hybrid layout on its own)
    _DEGREE_AWARE = {"mis2": (None, "cuda_hybrid"),
                     "coarsen": (None, "cuda_hybrid"),
                     "color": ("luby_hybrid",)}

    def _layout_guard(self, req: PendingRequest) -> Optional[LayoutInfeasible]:
        """Admission-side layout feasibility: a request whose engine is
        ELL-bound on a graph whose padded-ELL estimate exceeds
        ``ELL_BYTE_LIMIT`` would die in an out-of-memory error *after*
        consuming queue capacity — shed it up front with the typed error
        instead."""
        if req.graph.ell_bytes_estimate() <= ELL_BYTE_LIMIT:
            return None
        if req.engine in self._DEGREE_AWARE.get(req.kind, ()):
            return None
        return LayoutInfeasible(
            f"{req.kind} request with engine={req.engine!r} needs the "
            f"monolithic padded ELL "
            f"(~{req.graph.ell_bytes_estimate():,} bytes > limit "
            f"{ELL_BYTE_LIMIT:,}); resubmit with a degree-aware engine "
            f"({self._DEGREE_AWARE.get(req.kind) or 'none for this kind'})")

    def _count_shed(self, reason: str) -> None:
        self.stats.shed += 1
        _OBS.counter("serve.shed", labels={"reason": reason}).inc()

    def _rejected(self, req: PendingRequest, err: ServeError):
        """Fail a request at admission: typed error on its future,
        ``serve.shed{reason=...}`` counted — the caller sees the error on
        ``result()``, never an exception out of ``submit`` itself."""
        self._count_shed(err.reason)
        req.future.set_exception(err)
        return req.future

    def submit(self, kind: str, graph, *, engine: Optional[str] = None,
               backend: Optional[Backend] = None,
               deadline_s: Optional[float] = None,
               caller: str = "default", **params):
        """Enqueue one request; returns a ``concurrent.futures.Future``.

        The returned future always resolves — with a digest-correct
        ``Result`` or a typed :class:`~repro_torch.serve.errors.ServeError`
        (shed, expired, closed, failed).  ``submit`` itself only raises
        for malformed requests (unknown kind/params).

        A cache hit resolves the future immediately (optionally parity-
        checked) and bypasses admission.  Otherwise the request passes
        admission control, then — under ``dedup`` — coalesces onto any
        in-flight computation for the same ``(kind, digest, engine,
        options)`` key (joiners share the primary's future, including its
        deadline fate), else joins its continuous-batching group.

        ``deadline_s`` is a relative deadline (falls back to
        ``config.default_deadline_s``); expired queued requests are
        evicted with ``DeadlineExceeded``, never dispatched.  ``caller``
        is the per-caller quota identity.
        """
        norm = self._normalize(kind, params)
        be = backend if backend is not None else self.config.backend
        gh = as_graph(graph).place(resolve_backend(be).resolve_device())
        engine_token = engine if engine is not None else "auto"
        key = (kind, gh.digest, engine_token, _freeze(norm))
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        req = PendingRequest(kind=kind, graph=gh, params=norm, engine=engine,
                             backend=be, cache_key=key, caller=caller)
        with self._lock, _obs_span("serve.submit", kind=kind) as sp:
            self.stats.bump("requests")
            if self._closed:
                sp.annotate(outcome="closed")
                return self._rejected(req, ServerClosed(
                    "server is stopped; submit on a new Server"))
            with _obs_span("serve.cache_lookup", kind=kind):
                cached = self.cache.lookup(
                    key, recompute=lambda: self._parity_referent(req))
            if cached is not None:
                sp.annotate(cache="hit")
                req.future.set_result(cached)
                return req.future
            sp.annotate(cache="miss")
            layout_err = self._layout_guard(req)
            if layout_err is not None:
                sp.annotate(outcome=f"shed:{layout_err.reason}")
                return self._rejected(req, layout_err)
            joining = self.config.dedup and key in self._inflight
            try:
                self.admission.admit(
                    caller=caller, pending=len(self.batcher),
                    deadline_s=deadline_s, est_wait_s=self._est_wait(),
                    joining=joining)
            except ServeError as err:
                sp.annotate(outcome=f"shed:{err.reason}")
                return self._rejected(req, err)
            if joining:
                sp.annotate(outcome="dedup")
                self.stats.bump("dedup_hits")
                return self._inflight[key]
            now = time.perf_counter()
            if deadline_s is not None:
                req.deadline = now + deadline_s
            if self.config.dedup:
                self._inflight[key] = req.future
            self.batcher.add(req, now)
        return req.future

    def request(self, kind: str, graph, *, engine: Optional[str] = None,
                backend: Optional[Backend] = None, **params):
        """Synchronous convenience: submit, flush, return the Result."""
        fut = self.submit(kind, graph, engine=engine, backend=backend,
                          **params)
        self.flush()
        return fut.result()

    def open_stream(self, graph, *,
                    options: Optional[Mis2Options] = None) -> StreamSession:
        """A streaming MIS-2 session governed by this server's config
        (``delta_check_fraction`` and the fault plan taken from the
        serving config)."""
        if self._closed:
            raise ServerClosed("server is stopped; open streams on a "
                               "new Server")
        return StreamSession(
            graph, options=options,
            check_fraction=self.config.delta_check_fraction,
            faults=self.config.faults, backend=self.config.backend)

    # -- event loop ---------------------------------------------------------

    def pump(self, now: Optional[float] = None, force: bool = False) -> int:
        """Evict expired requests, dispatch every due group; returns the
        number of groups served.

        Queue surgery happens under the state lock; the dispatches
        themselves run holding only the dispatch lock, so concurrent
        submits and cache hits proceed even while a dispatch is deep in
        retry backoff or an injected slow fault."""
        with self._dispatch_lock:
            with self._lock:
                if self._closed:
                    return 0
                t = time.perf_counter() if now is None else now
                for req in self.batcher.pop_expired(t):
                    self.stats.bump("expired")
                    self._finish_error(req, DeadlineExceeded(
                        f"deadline expired after {t - req.enqueued_at:.4f}s "
                        "in queue; request evicted before dispatch"),
                        shed_reason="expired")
                groups = self.batcher.due(t, force=force)
            for _, reqs in groups:
                self._dispatch(reqs)
            return len(groups)

    def flush(self) -> int:
        """Dispatch everything pending regardless of deadlines."""
        return self.pump(force=True)

    def start(self) -> "Server":
        """Run the pump on a daemon thread (idempotent)."""
        with self._lock:
            if self._closed:
                raise ServerClosed("cannot start a stopped server")
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="repro-serve")
            self._thread.start()
        return self

    def stop(self) -> None:
        """Terminal shutdown: the pump thread stops, every queued future
        fails with :class:`~repro_torch.serve.errors.ServerClosed`, and every
        later ``submit`` returns a future already carrying it.  Requests
        mid-dispatch complete normally — their group already left the
        queue, the drain cannot touch them, and in-flight retry backoff
        is cut short by the stop event.  Idempotent."""
        with self._lock:
            first = not self._closed
            self._closed = True
            thread = self._thread
            self._thread = None
        self._stop.set()
        if thread is not None:
            thread.join()
        if not first:
            return
        with self._lock:
            for req in self.batcher.drain():
                self._finish_error(req, ServerClosed(
                    "server stopped with the request still queued"),
                    shed_reason="closed")
            self._inflight.clear()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.pump()
            except Exception as err:  # noqa: BLE001 - the pump thread must
                self._pump_crashed(err)     # outlive any single failure
            with self._lock:
                delay = self.batcher.next_deadline(time.perf_counter())
            if delay is None:
                delay = self.config.poll_interval_s
            self._stop.wait(min(delay, self.config.poll_interval_s)
                            if delay > 0 else 0.0)

    def _pump_crashed(self, err: Exception) -> None:
        """Last-ditch pump-thread containment: an exception that escapes
        ``pump()`` (anything outside dispatch's own typed fan-out) would
        otherwise kill the daemon thread silently — every queued future
        then hangs forever and so does all later work.  Instead: fail
        everything queued with a typed error, count it, keep pumping."""
        _OBS.counter("serve.pump_errors").inc()
        wrapped = err if isinstance(err, ServeError) else EngineFailure(
            f"pump loop crashed: {err}")
        if wrapped is not err:
            wrapped.__cause__ = err
        with self._lock:
            for req in self.batcher.drain():
                self._finish_error(req, wrapped)

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- dispatch -----------------------------------------------------------

    def _est_wait(self) -> Optional[float]:
        """EWMA-based queue-wait estimate for deadline-aware shedding
        (None until the server has dispatched at least once)."""
        if self._service_ewma is None:
            return None
        depth = len(self.batcher)
        return self._service_ewma * (1.0 + depth / self.config.max_batch)

    def _resolve_engine(self, req: PendingRequest) -> Optional[str]:
        """Per-request engine auto-selection (at dispatch time, with the
        request's own backend — never a server-global choice)."""
        if req.engine is not None:
            return req.engine
        if req.kind == "mis2":
            return default_mis2_engine(req.graph, req.params.get("options"))
        if req.kind == "amg_setup":
            return default_multilevel_engine(req.graph)
        return None     # color/coarsen: the facade default is the engine

    def _direct(self, req: PendingRequest):
        """The direct facade call for one request — the bit-identity
        referent (used for single dispatch and parity recomputation)."""
        kw = dict(req.params)
        kw["backend"] = req.backend
        if req.kind == "mis2":
            return facade.mis2(req.graph, engine=req.engine, **kw)
        if req.kind == "color":
            if req.engine is not None:
                kw["engine"] = req.engine
            return facade.color(req.graph, **kw)
        if req.kind == "coarsen":
            if req.engine is not None:
                kw["mis2_engine"] = req.engine
            return facade.coarsen(req.graph, **kw)
        if req.kind == "amg_setup":
            return facade.amg_setup(req.graph, engine=req.engine, **kw)
        raise ValueError(req.kind)

    def _parity_referent(self, req: PendingRequest):
        """Recompute a cache hit for the parity assertion.

        For engine-agnostic mis2 requests the referent is the ``dense``
        engine: every engine is digest-identical (the invariant the cache
        relies on), so the parity check is a cross-engine check.
        """
        if req.kind == "mis2" and req.engine is None:
            kw = dict(req.params)
            kw["backend"] = req.backend
            # the dense referent pads to [V, max_degree]: on a graph past
            # the ELL budget recompute with the request's own (hybrid)
            # engine path instead — parity then checks run-to-run
            # determinism rather than cross-engine agreement
            if req.graph.ell_bytes_estimate() > ELL_BYTE_LIMIT:
                return self._direct(req)
            return facade.mis2(req.graph, engine="dense", **kw)
        return self._direct(req)

    def _dispatch(self, reqs: list[PendingRequest]) -> None:
        """One group's compute + fan-out (runs under the dispatch lock
        only; the state lock is taken just around the finish loops)."""
        self.stats.bump("dispatches")
        t0 = time.perf_counter()
        try:
            with _obs_span("serve.dispatch", kind=reqs[0].kind,
                           group=len(reqs)):
                results = self._compute_resilient(reqs)
        except Exception as err:    # typed fan-out: callers never see a hang
            wrapped = err if isinstance(err, ServeError) else EngineFailure(
                f"dispatch failed for kind={reqs[0].kind!r}: {err}")
            if wrapped is not err:
                wrapped.__cause__ = err
            with self._lock:
                for req in reqs:
                    self._finish_error(req, wrapped)
            return
        except BaseException as err:  # noqa: BLE001 - KeyboardInterrupt etc:
            with self._lock:          # fan out raw, then re-raise
                for req in reqs:
                    self._finish_error(req, err)
            raise
        sample = time.perf_counter() - t0
        with self._lock:
            self._service_ewma = sample if self._service_ewma is None else (
                0.3 * sample + 0.7 * self._service_ewma)
            for req, res in zip(reqs, results):
                try:
                    self._finish_result(req, res)
                except Exception as err:  # noqa: BLE001 - delivery failures
                    # (cache/persist/ledger) must fail THIS future typed,
                    # not leak out of pump() and strand the rest
                    wrapped = EngineFailure(
                        f"result delivery failed for kind={req.kind!r}: "
                        f"{err}")
                    wrapped.__cause__ = err
                    self._finish_error(req, wrapped)

    def _compute_resilient(self, reqs: list[PendingRequest]) -> list:
        """The compute body under the retry/fallback policy.

        Transient injected faults (the recoverable-blip model) retry the
        whole group with capped exponential backoff, counted per site in
        ``serve.retries{site}``.  A persistent fault, an exhausted retry
        budget, or a real engine exception degrades each request to its
        fallback engine (``serve.fallbacks{from,to}``) — the host/dense
        referent of the engine contract.  Only if the fallback *also*
        fails does the group error (wrapped ``EngineFailure``).  A real
        exception degrades only a group on the CPU: on the card, and for a
        kernel's build or launch error, a CUDA runtime error or a device
        out-of-memory error anywhere, it fails the group with
        ``EngineFailure``, the exception as its cause.  An injected fault
        on the card degrades to the card's default engine (``_fallback``).
        """
        faults = self.config.faults
        policy = self.config.retry
        attempt = 1
        while True:
            try:
                if faults is not None:
                    faults.fire("dispatch")
                    faults.fire("engine")
                return self._compute(reqs)
            except InjectedFault as err:
                if err.transient and attempt < policy.max_attempts:
                    self.stats.retries += 1
                    _OBS.counter("serve.retries",
                                 labels={"site": err.site}).inc()
                    # interruptible backoff (holds the dispatch lock, never
                    # the state lock): stop() cuts the wait short and the
                    # retry then completes the in-flight group normally
                    self._stop.wait(policy.backoff_s(attempt))
                    attempt += 1
                    continue
                if policy.fallback:
                    return [self._fallback(req, err) for req in reqs]
                raise
            except ServeError:
                raise
            except Exception as err:
                if (policy.fallback and not _device_fault(err)
                        and not any(_on_card(r) for r in reqs)):
                    return [self._fallback(req, err) for req in reqs]
                raise

    def _fallback(self, req: PendingRequest, cause: Exception):
        """Degrade one request to its fallback engine (the engine-contract
        referent; on the card the card's default engine, so the work stays
        on the card and its kernels).  The result flows through the same
        digest ledger as every response, so a degraded answer is held to
        bit-identity with whatever this key served before."""
        from_token = req.engine if req.engine is not None else "auto"
        to_engine = None if _on_card(req) else FALLBACK_ENGINES.get(req.kind)
        to_token = to_engine if to_engine is not None else "default"
        self.stats.fallbacks += 1
        _OBS.counter("serve.fallbacks",
                     labels={"from": from_token, "to": to_token}).inc()
        fb_req = dataclasses.replace(req, engine=to_engine)
        try:
            return self._direct(fb_req)
        except Exception as err:
            failure = EngineFailure(
                f"kind={req.kind!r} failed on the primary engine "
                f"({cause}) and again on fallback {to_token!r}: {err}")
            failure.__cause__ = cause
            raise failure from err

    def _finish_result(self, req: PendingRequest, res) -> None:
        """Resolve one future: digest-ledger check, cache insert, result.

        The ledger refuses to serve two different digests for one key —
        under the determinism invariant equal keys must produce equal
        bytes, so a conflict means corruption (the response is failed
        with ``DigestMismatch``, never served)."""
        prev = self._ledger.get(req.cache_key)
        if prev is not None and prev != res.digest:
            self._finish_error(req, DigestMismatch(
                f"key {req.cache_key[:3]} previously served digest {prev}, "
                f"this compute produced {res.digest}"))
            return
        if prev is None:
            self._ledger[req.cache_key] = res.digest
            if len(self._ledger) > LEDGER_CAP:
                self._ledger.popitem(last=False)
        else:
            self._ledger.move_to_end(req.cache_key)
        if self._inflight.get(req.cache_key) is req.future:
            del self._inflight[req.cache_key]
        self.cache.insert(req.cache_key, res)
        if not req.future.done():
            req.future.set_result(res)

    def _finish_error(self, req: PendingRequest, err: BaseException,
                      shed_reason: Optional[str] = None) -> None:
        if self._inflight.get(req.cache_key) is req.future:
            del self._inflight[req.cache_key]
        if shed_reason is not None:
            self._count_shed(shed_reason)
        if not req.future.done():
            req.future.set_exception(err)

    def _compute(self, reqs: list[PendingRequest]) -> list:
        """A group's results in order.  A lone request takes the fast path;
        an explicit-engine group runs each request through the facade with
        its engine (the batcher's contract: the caller said how to
        execute); in an ``engine=None`` group a graph past
        ``BATCH_MAX_ELL_BYTES`` runs alone through the facade's
        ``engine=None`` path (the device-resident or hybrid engines), the
        rest as one batched dispatch."""
        if len(reqs) == 1 and self.config.single_fast_path:
            self.stats.bump("single_dispatches")
            return [self._direct(reqs[0])]
        alone = [self._alone(r) for r in reqs]
        out: list = [None] * len(reqs)
        for i, req in enumerate(reqs):
            if alone[i]:
                self.stats.bump("single_dispatches")
                out[i] = self._direct(req)
        rest = [i for i in range(len(reqs)) if not alone[i]]
        if rest:
            self.stats.bump("batched_graphs", len(rest))
            for i, res in zip(rest, self._batched([reqs[i] for i in rest])):
                out[i] = res
        return out

    @staticmethod
    def _alone(req: PendingRequest) -> bool:
        """Whether a request runs through the single-graph facade path even
        inside a group (an explicit engine, or a large graph)."""
        return (req.engine is not None
                or req.graph.ell_bytes_estimate() > BATCH_MAX_ELL_BYTES)

    def _batched(self, reqs: list[PendingRequest]) -> list:
        """One batched dispatch for a homogeneous group (same kind/params,
        guaranteed by the batcher's group key).  Each member's provenance
        is the batch's record with the member's own digest."""
        kind, params = reqs[0].kind, reqs[0].params
        graphs = [r.graph for r in reqs]
        backend = reqs[0].backend
        if kind == "mis2":
            return self._mis2_batched(graphs, params["options"])
        if kind == "color":
            batch = facade.color_batch(graphs, backend=backend, **params)
        elif kind == "coarsen":
            batch = facade.coarsen_batch(graphs, backend=backend, **params)
        elif kind == "amg_setup":
            kw = dict(params)
            engine = self._resolve_engine(reqs[0])
            batch = facade.amg_setup_batch(graphs, engine=engine,
                                           backend=backend, **kw)
        else:
            raise ValueError(kind)
        for r in batch.results:
            r.provenance = dataclasses.replace(r.provenance, digest=r.digest)
        return list(batch.results)

    def _mis2_batched(self, graphs: Sequence,
                      options: Mis2Options) -> list[Mis2Result]:
        """Bucketed mis2 dispatch: the batched pipeline's own buckets and
        fixed point (``batch.pipeline._mis2_batch_impl``), so per-graph
        results are bit-identical to every single-graph engine; each
        bucket's shape is shown to the :class:`WarmRegistry`, which counts
        a shape it did not warm."""
        t0 = time.perf_counter()
        batch = GraphBatch(graphs)
        with _obs_span("serve.batch_mis2", graphs=len(graphs),
                       buckets=batch.num_buckets) as sp:
            for bucket in batch.buckets:
                self.warm.note(bucket.size, bucket.rows, bucket.width,
                               options.priority, options.max_iters)
            core = _mis2_batch_impl(batch, options)
        per = (time.perf_counter() - t0) / max(1, len(core))
        results = [Mis2Result(r.in_set, r.iterations, r.converged, per,
                              engine="dense_batched", host_syncs=r.host_syncs)
                   for r in core]
        span_dict = sp.to_dict()
        platform = backend_platform(resolve_backend(self.config.backend))
        for r in results:
            r.provenance = Provenance("mis2", "dense_batched", platform,
                                      r.digest, span_dict)
        return results

    # -- observability ------------------------------------------------------

    def reset_window(self) -> None:
        """Start a new uptime accounting window (compile churn counters)."""
        with self._lock:
            self.warm.reset_window()
            self.stats.window_started_at = time.perf_counter()

    def server_stats(self) -> dict:
        """Counters for dashboards/tests: requests, batching, dedup,
        shedding, retries/fallbacks, cache (memory + persistent tier),
        jit churn (total and since ``reset_window()``).

        Every counter here is also live in the process-wide
        ``repro_torch.obs`` registry (``serve.*`` / ``serve.cache.*`` / ``serve.persist.*`` /
        ``serve.warm.*``) — ``obs.snapshot()`` or the Prometheus exporter
        sees the same numbers without going through a ``Server``
        reference; this dict is the per-instance view.  All intervals are
        ``perf_counter`` deltas (monotone, same clock as spans and cache
        timings)."""
        with self._lock:
            now = time.perf_counter()
            out = {
                "requests": self.stats.requests,
                "dispatches": self.stats.dispatches,
                "batched_graphs": self.stats.batched_graphs,
                "single_dispatches": self.stats.single_dispatches,
                "dedup_hits": self.stats.dedup_hits,
                "shed": self.stats.shed,
                "expired": self.stats.expired,
                "retries": self.stats.retries,
                "fallbacks": self.stats.fallbacks,
                "pending": len(self.batcher),
                "inflight_keys": len(self._inflight),
                "ledger_keys": len(self._ledger),
                "closed": self._closed,
                "quota_denials": dict(self.admission.denials),
                "uptime_s": now - self.stats.started_at,
                "cache": self.cache.stats.as_dict(),
                "compiles": {
                    "startup_aot": self.warm.startup_compiles,
                    "warmed_shapes": self.warm.num_executables,
                    "runtime_cold": self.warm.runtime_compiles,
                    "window_s": now - self.stats.window_started_at,
                    "runtime_cold_window":
                        self.warm.runtime_compiles_window,
                    "nvcc_since_warm": self.warm.builds_since_warm,
                },
            }
            if self.persist is not None:
                out["persist"] = self.persist.stats.as_dict()
            return out


def warm_buckets_for(graphs) -> tuple:
    """The distinct ``(rows, width)`` bucket shapes a graph fleet lands in
    — convenience for building a ``ServerConfig`` from a known workload."""
    return tuple(sorted({bucket_shape(as_graph(g)) for g in graphs}))
