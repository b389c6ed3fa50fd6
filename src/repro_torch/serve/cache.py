"""Digest-keyed result cache: LRU over a byte budget, hits provably safe
(a copy of the JAX package's ``repro.serve.cache``; result bytes are read
from the tensors).

The cache key is ``(kind, graph.digest, engine token, options token)``.
Because every engine in this repo is bit-identical for equal inputs and
options (the standing determinism gate), two requests that collide on a
key would compute byte-equal ``Result`` payloads — so returning the cached
object *is* recomputation, minus the work.  The parity assertion mode
makes that claim self-checking in production: a configurable fraction of
hits is recomputed through the direct facade path and the digests
compared; any mismatch raises (and is counted) instead of being served.

Sampling is deterministic (an error-diffusion accumulator, not an RNG) so
a given hit sequence always checks the same hits — CI can force
``parity_fraction=1.0`` and count the checks exactly.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..obs import metrics as _OBS


class CacheParityError(AssertionError):
    """A sampled cache hit did not match its recomputation bit-for-bit."""


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(np.asarray(arr).nbytes)


def _result_nbytes(result) -> int:
    """Byte footprint of a Result for the LRU budget (payload-dominated)."""
    total = 256  # object overhead / scalar fields
    payload = getattr(result, "payload", None)
    if payload is not None:
        total += _nbytes(payload)
    hierarchy = getattr(result, "hierarchy", None)
    if hierarchy is not None:       # AmgSetup: the levels dominate, not the
        for lvl in getattr(hierarchy, "levels", ()):   # level-size payload
            for mat in (lvl.a_ell, lvl.p_ell, lvl.r_ell):
                for arr in (mat or ()):
                    total += _nbytes(arr)
            total += _nbytes(lvl.diag)
    return total


@dataclass
class CacheStats:
    """Per-cache counters, mirrored into the process-wide ``repro_torch.obs``
    registry (``serve.cache.*`` counters + ``serve.cache.bytes_used``
    gauge) so one ``obs.snapshot()`` sees cache traffic next to
    dispatches and compiles.  The instance fields remain the per-cache
    truth (two caches in one process split cleanly); the registry carries
    the process aggregate."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    inserts: int = 0
    parity_checks: int = 0
    parity_failures: int = 0
    bytes_used: int = 0

    def bump(self, name: str, n: int = 1) -> None:
        setattr(self, name, getattr(self, name) + n)
        _OBS.counter(f"serve.cache.{name}").inc(n)

    def set_bytes(self, used: int) -> None:
        self.bytes_used = used
        _OBS.gauge("serve.cache.bytes_used").set(used)

    def as_dict(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions, "inserts": self.inserts,
            "parity_checks": self.parity_checks,
            "parity_failures": self.parity_failures,
            "bytes_used": self.bytes_used,
            "hit_rate": self.hits / max(1, self.hits + self.misses),
        }


@dataclass
class ResultCache:
    """LRU result cache with a byte budget and sampled parity assertions.

    ``max_bytes <= 0`` disables caching entirely (every lookup misses,
    nothing is stored).  ``parity_fraction`` in ``[0, 1]`` recomputes that
    fraction of hits through ``recompute`` (provided per lookup by the
    server — it is the direct facade call for the request) and asserts
    digest equality.
    """

    max_bytes: int = 64 << 20
    parity_fraction: float = 0.0
    stats: CacheStats = field(default_factory=CacheStats)
    #: optional PersistTier under this cache: memory misses fall through
    #: to disk (digest-verified on load), inserts write through
    persist: Optional[Any] = None

    def __post_init__(self):
        self._entries: OrderedDict[tuple, tuple[Any, int]] = OrderedDict()
        self._parity_acc = 0.0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: tuple,
               recompute: Optional[Callable[[], Any]] = None):
        """Return the cached Result for ``key`` or None (a miss).

        On a hit the entry is refreshed (LRU) and, per the sampling
        accumulator, optionally parity-checked against ``recompute()``.
        A memory miss falls through to the persistent tier (if any):
        a digest-verified disk hit counts as a cache hit and is promoted
        into memory (without re-writing disk).
        """
        if self.max_bytes <= 0 or key not in self._entries:
            if self.persist is not None and self.max_bytes > 0:
                try:
                    rehydrated = self.persist.load(key)
                except Exception:   # noqa: BLE001 - disk-tier failures are
                    # misses, never exceptions out of submit()'s cache lookup
                    _OBS.counter("serve.persist.load_errors").inc()
                    rehydrated = None
                if rehydrated is not None:
                    self.stats.bump("hits")
                    self.insert(key, rehydrated, write_persist=False)
                    return rehydrated
            self.stats.bump("misses")
            return None
        result, _ = self._entries[key]
        self._entries.move_to_end(key)
        self.stats.bump("hits")
        if recompute is not None and self.parity_fraction > 0.0:
            self._parity_acc += min(1.0, self.parity_fraction)
            if self._parity_acc >= 1.0:
                self._parity_acc -= 1.0
                self.stats.bump("parity_checks")
                fresh = recompute()
                if fresh.digest != result.digest:
                    self.stats.bump("parity_failures")
                    raise CacheParityError(
                        f"cache parity violation for {key}: cached digest "
                        f"{result.digest} != recomputed {fresh.digest}")
        return result

    def insert(self, key: tuple, result, write_persist: bool = True) -> None:
        if self.max_bytes <= 0:
            return
        if write_persist and self.persist is not None:
            try:
                self.persist.store(key, result)
            except Exception:   # noqa: BLE001 - a broken disk tier must
                # never break the response path (insert runs while the
                # server is resolving futures); the entry stays memory-only
                _OBS.counter("serve.persist.store_errors").inc()
        nbytes = _result_nbytes(result)
        if nbytes > self.max_bytes:
            return  # would evict everything and still not fit
        if key in self._entries:
            _, old = self._entries.pop(key)
            self.stats.set_bytes(self.stats.bytes_used - old)
        self._entries[key] = (result, nbytes)
        self.stats.set_bytes(self.stats.bytes_used + nbytes)
        self.stats.bump("inserts")
        while self.stats.bytes_used > self.max_bytes and self._entries:
            _, (_, evicted) = self._entries.popitem(last=False)
            self.stats.set_bytes(self.stats.bytes_used - evicted)
            self.stats.bump("evictions")

    def clear(self) -> None:
        self._entries.clear()
        self.stats.set_bytes(0)
