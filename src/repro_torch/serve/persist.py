"""Content-addressed persistent cache tier: digest-verified, atomic, LRU
(the JAX package's ``repro.serve.persist``, on the port's Result types).

The in-memory :class:`~repro_torch.serve.cache.ResultCache` dies with the
process; this tier sits *under* it and survives restarts.  Each entry is
one directory named by the hash of its cache key::

    <root>/entry_<sha256(repr(key))[:32]>/
        arrays.npz       payload (+ roots/phase for coarsening results)
        manifest.json    version, kind, repr(key), per-array digests,
                         scalar Result fields

Three properties make rehydrating from disk as safe as recomputing:

* **Atomic commit** — the checkpoint-manager pattern: build the entry in
  a ``.tmp`` sibling, fsync every file, then ``os.replace`` into place.
  A crash mid-write leaves a ``.tmp`` orphan (swept and counted as
  ``torn_cleaned`` on the next open), never a half-entry that could load.
* **Digest re-verification on load** — every array is re-hashed with
  :func:`~repro_torch.api.result.determinism_digest` and compared against the
  manifest, and the manifest key must match the requested key exactly.
  Any mismatch (bit rot, a truncated write that still parses, an injected
  ``persist_corrupt`` fault) drops the entry and counts
  ``serve.persist.corrupt`` — a corrupt entry is *never* served.
* **Byte-budget LRU** — entries beyond ``max_bytes`` are evicted oldest-
  mtime-first (loads touch the entry's mtime, so recently-served entries
  survive).  Ordering keys off filesystem mtimes rather than wall-clock
  reads in code.

Only result kinds whose payloads fully round-trip through ``.npz`` are
persisted (``mis2`` / ``color`` / ``coarsen``); ``amg_setup`` carries a
live hierarchy object graph and stays memory-only — ``store`` returns
False and the server keeps working.

Payloads are written from their host copies (a facade Result's payload,
roots and phase are host numpy arrays), and a rehydrated Result holds host
arrays too, exactly as the direct facade call's Result does.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..api.result import (AggregationResult, ColoringResult, Mis2Result,
                          determinism_digest)
from ..obs import metrics as _OBS

PERSIST_VERSION = 1

#: kinds whose Result round-trips losslessly through arrays + JSON scalars
PERSISTABLE_KINDS = ("mis2", "color", "coarsen")

_ENTRY_PREFIX = "entry_"
_TMP_SUFFIX = ".tmp"


def entry_name(key: tuple) -> str:
    """Content address for a cache key (stable across processes: the key
    is built from digests, engine tokens and frozen option tuples, so its
    ``repr`` is deterministic)."""
    return _ENTRY_PREFIX + hashlib.sha256(repr(key).encode()).hexdigest()[:32]


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _dir_nbytes(path: str) -> int:
    total = 0
    for name in os.listdir(path):
        total += os.path.getsize(os.path.join(path, name))
    return total


@dataclass
class PersistStats:
    """Per-tier counters mirrored into ``repro_torch.obs``
    (``serve.persist.*`` counters + ``serve.persist.bytes_used`` gauge),
    same split as :class:`~repro_torch.serve.cache.CacheStats`: instance fields are per-tier
    truth, the registry carries the process aggregate."""

    hits: int = 0
    misses: int = 0
    writes: int = 0
    corrupt: int = 0
    evictions: int = 0
    torn_cleaned: int = 0
    io_errors: int = 0
    bytes_used: int = 0

    def bump(self, name: str, n: int = 1) -> None:
        setattr(self, name, getattr(self, name) + n)
        _OBS.counter(f"serve.persist.{name}").inc(n)

    def set_bytes(self, used: int) -> None:
        self.bytes_used = used
        _OBS.gauge("serve.persist.bytes_used").set(used)

    def as_dict(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses, "writes": self.writes,
            "corrupt": self.corrupt, "evictions": self.evictions,
            "torn_cleaned": self.torn_cleaned, "io_errors": self.io_errors,
            "bytes_used": self.bytes_used,
        }


@dataclass
class PersistTier:
    """Digest-verified disk tier under the in-memory result cache.

    ``faults`` (a :class:`~repro_torch.serve.faults.FaultPlan` or None) is
    consulted at the ``persist_write`` site (simulated crash: the tmp
    build is abandoned uncommitted) and the ``persist_corrupt`` site
    (payload bytes are flipped *on disk* while the manifest keeps the
    true digests — exercising exactly the verification path that guards
    against real bit rot).
    """

    directory: str
    max_bytes: int = 256 << 20
    faults: Any = None
    stats: PersistStats = field(default_factory=PersistStats)

    def __post_init__(self):
        self._lock = threading.Lock()
        os.makedirs(self.directory, exist_ok=True)
        swept = 0
        total = 0
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.endswith(_TMP_SUFFIX):
                shutil.rmtree(path, ignore_errors=True)
                swept += 1
            elif name.startswith(_ENTRY_PREFIX) and os.path.isdir(path):
                total += _dir_nbytes(path)
        if swept:
            self.stats.bump("torn_cleaned", swept)
        self.stats.set_bytes(total)

    def __len__(self) -> int:
        return sum(1 for name in os.listdir(self.directory)
                   if name.startswith(_ENTRY_PREFIX))

    # ------------------------------------------------------------- store
    def store(self, key: tuple, result) -> bool:
        """Persist ``result`` under ``key``; True iff committed.

        Non-persistable kinds, oversized entries, injected
        ``persist_write`` crashes, and real I/O failures (ENOSPC, yanked
        permissions, a directory deleted underfoot — counted
        ``serve.persist.io_errors``) all return False — the tier degrades
        to memory-only for that entry, never blocks the response path.
        """
        kind = key[0] if key else None
        if kind not in PERSISTABLE_KINDS:
            return False
        arrays = {"payload": np.asarray(result.payload)}
        if kind == "coarsen":
            if result.roots is not None:
                arrays["roots"] = np.asarray(result.roots)
            if result.phase is not None:
                arrays["phase"] = np.asarray(result.phase)
        manifest = {
            "version": PERSIST_VERSION,
            "kind": kind,
            "key": repr(key),
            "digest": result.digest,
            "array_digests": {n: determinism_digest(a)
                              for n, a in arrays.items()},
            "fields": self._scalar_fields(kind, result),
        }
        if self.faults is not None and self.faults.corrupts("persist_corrupt"):
            # flip one payload byte on disk; the manifest keeps the true
            # digests, so load-time re-verification must catch this
            buf = arrays["payload"].copy()
            flat = buf.view(np.uint8).reshape(-1)
            flat[0] ^= 0xFF
            arrays["payload"] = buf
        name = entry_name(key)
        final = os.path.join(self.directory, name)
        tmp = final + _TMP_SUFFIX
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                json.dump(manifest, fh, indent=1)
                fh.flush()
                os.fsync(fh.fileno())
            _fsync_file(os.path.join(tmp, "arrays.npz"))
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            self.stats.bump("io_errors")
            return False
        if self.faults is not None:
            try:
                self.faults.fire("persist_write")
            except Exception:
                # simulated crash between build and commit: the tmp
                # orphan stays for the next open's sweep to find
                return False
        try:
            nbytes = _dir_nbytes(tmp)
            if nbytes > self.max_bytes:
                shutil.rmtree(tmp, ignore_errors=True)
                return False
            with self._lock:
                replaced = _dir_nbytes(final) if os.path.isdir(final) else 0
                if replaced:
                    # os.replace cannot clobber a non-empty dir target
                    shutil.rmtree(final, ignore_errors=True)
                os.replace(tmp, final)
                self.stats.set_bytes(
                    self.stats.bytes_used - replaced + nbytes)
                self.stats.bump("writes")
                self._evict_over_budget(keep=name)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            self.stats.bump("io_errors")
            return False
        return True

    @staticmethod
    def _scalar_fields(kind: str, result) -> dict:
        fields = {
            "iterations": int(result.iterations),
            "converged": bool(result.converged),
            "wall_time_s": float(result.wall_time_s),
        }
        if kind == "mis2":
            fields["engine"] = result.engine
            fields["host_syncs"] = int(result.host_syncs)
            fields["num_compiles"] = result.num_compiles
            collectives = result.collectives
            try:
                json.dumps(collectives)
            except (TypeError, ValueError):
                collectives = None
            fields["collectives"] = collectives
        elif kind == "color":
            fields["num_colors"] = int(result.num_colors)
        elif kind == "coarsen":
            fields["num_aggregates"] = int(result.num_aggregates)
            fields["engine"] = result.engine
        return fields

    # -------------------------------------------------------------- load
    def load(self, key: tuple):
        """Return the rehydrated Result for ``key``, or None.

        Every array is re-digested against the manifest and the manifest
        key/kind/version must match the request; any discrepancy drops
        the entry (counted ``serve.persist.corrupt``) and misses.
        """
        final = os.path.join(self.directory, entry_name(key))
        if not os.path.isdir(final):
            self.stats.bump("misses")
            return None
        try:
            with open(os.path.join(final, "manifest.json")) as fh:
                manifest = json.load(fh)
            ok = (manifest.get("version") == PERSIST_VERSION
                  and manifest.get("key") == repr(key)
                  and manifest.get("kind") == (key[0] if key else None))
            arrays = {}
            if ok:
                with np.load(os.path.join(final, "arrays.npz")) as npz:
                    expected = manifest["array_digests"]
                    ok = set(npz.files) == set(expected)
                    if ok:
                        for name in npz.files:
                            arr = npz[name]
                            if determinism_digest(arr) != expected[name]:
                                ok = False
                                break
                            arrays[name] = arr
                    # the Result digest is by contract the payload digest;
                    # pin the manifest's top-level digest to the *verified*
                    # payload digest so a corrupted digest field can never
                    # rehydrate a Result that disagrees with its own bytes
                    # (and later poison the ledger or parity checks)
                    ok = ok and manifest.get("digest") == expected["payload"]
        except Exception:   # noqa: BLE001 - unparseable == corrupt: any
            ok = False      # bit rot that breaks zip/json parsing lands here
        if not ok:
            self._drop(final, corrupt=True)
            self.stats.bump("misses")
            return None
        try:
            os.utime(final)  # LRU touch: loads keep hot entries off the
            #                  eviction frontier
        except OSError:      # entry evicted/removed underfoot (shared
            self.stats.bump("misses")   # persist_dir): it is gone — a miss
            return None
        self.stats.bump("hits")
        return self._rebuild(manifest, arrays)

    @staticmethod
    def _rebuild(manifest: dict, arrays: dict):
        kind = manifest["kind"]
        fields = manifest["fields"]
        common = dict(payload=arrays["payload"],
                      iterations=fields["iterations"],
                      converged=fields["converged"],
                      wall_time_s=fields["wall_time_s"],
                      digest=manifest["digest"])
        if kind == "mis2":
            return Mis2Result(engine=fields.get("engine", ""),
                              host_syncs=fields.get("host_syncs", 0),
                              collectives=fields.get("collectives"),
                              num_compiles=fields.get("num_compiles"),
                              **common)
        if kind == "color":
            return ColoringResult(num_colors=fields.get("num_colors", 0),
                                  **common)
        return AggregationResult(
            num_aggregates=fields.get("num_aggregates", 0),
            engine=fields.get("engine", ""),
            roots=arrays.get("roots"), phase=arrays.get("phase"), **common)

    # --------------------------------------------------------- retention
    def _drop(self, path: str, corrupt: bool = False) -> None:
        try:
            nbytes = _dir_nbytes(path) if os.path.isdir(path) else 0
        except OSError:     # entry vanished mid-measure: nothing to subtract
            nbytes = 0
        shutil.rmtree(path, ignore_errors=True)
        with self._lock:
            self.stats.set_bytes(max(0, self.stats.bytes_used - nbytes))
        if corrupt:
            self.stats.bump("corrupt")

    def _evict_over_budget(self, keep: Optional[str] = None) -> None:
        # caller holds self._lock
        if self.stats.bytes_used <= self.max_bytes:
            return
        entries = []
        for name in os.listdir(self.directory):
            if not name.startswith(_ENTRY_PREFIX) or name == keep:
                continue
            path = os.path.join(self.directory, name)
            try:
                if os.path.isdir(path):
                    entries.append((os.stat(path).st_mtime_ns, path))
            except OSError:     # entry vanished between listdir and stat
                continue
        entries.sort()
        for _, path in entries:
            if self.stats.bytes_used <= self.max_bytes:
                break
            try:
                nbytes = _dir_nbytes(path)
            except OSError:
                nbytes = 0
            shutil.rmtree(path, ignore_errors=True)
            self.stats.set_bytes(max(0, self.stats.bytes_used - nbytes))
            self.stats.bump("evictions")

    def clear(self) -> None:
        for name in os.listdir(self.directory):
            if name.startswith(_ENTRY_PREFIX) or name.endswith(_TMP_SUFFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        self.stats.set_bytes(0)
