"""Streaming MIS-2: apply edge deltas, repair locally, stay bit-exact (the
JAX package's ``repro.serve.streaming`` on the port's repair helpers).

``StreamSession.apply_delta(edge_adds, edge_removes)`` updates a live
MIS-2 solution without recomputing from scratch: only the closed 2-hop
neighbourhood of the touched endpoints is reactivated (re-seeded
undecided), everything else keeps its previous T state (``IN``/``OUT``
frozen), and the warm-started fixed point
(:func:`repro_torch.core.mis2.mis2_repair_fixed_point`, on the device)
re-decides the region.  The edge bookkeeping and the reactivated region
stay on the host, as in the reference.

Exactness — why the repaired set is bit-identical to from-scratch:

* With the round-independent ``"fixed"`` priority, the MIS-2 fixed point
  computes the unique *lexicographically-first* MIS-2 under the packed
  priority order ``p``; that set is characterized pointwise by the
  recurrence "``v IN`` iff no member within distance 2 has smaller
  ``p``" (unique by induction along the priority order).
* After each repair solve, :func:`repro_torch.core.mis2.lexfirst_violations`
  checks that recurrence *globally* with two closed-neighbourhood min
  propagations.  Any violation necessarily implicates a frozen vertex
  within distance 2, so the violators' closed 2-hop is reactivated and
  the solve repeats; the region grows monotonically, hence terminates.
  An all-clear certifies the assignment satisfies the recurrence
  everywhere, and the unique such assignment *is* the from-scratch answer.

With a round-varying priority (the ``xorshift_star`` default elsewhere)
the fixed point is history-dependent and no warm start can be exact, so
``apply_delta`` falls back to a full recompute (``mode="recompute"``).
``check_fraction`` additionally digest-checks sampled deltas against an
actual from-scratch run.

The edge set is kept as sorted unique keys ``u * V + v``; a delta merges
into it and the CSR is read off the keys in one pass (no re-sort), which
gives the CSR that ``csr_from_coo`` would build from the same edges.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..api.backend import Backend, backend_platform, resolve_backend
from ..api.result import Mis2Result
from ..core.mis2 import (
    Mis2Options,
    fixed_packed_priorities,
    lexfirst_violations,
    mis2_dense_jittable,
    mis2_repair_fixed_point,
)
from ..core.tuples import IN, OUT, id_bits, is_undecided
from ..graphs.csr import CSRGraph, ensure_self_loops
from ..graphs.handle import Graph, as_graph
from ..obs import Provenance
from ..obs import metrics as _OBS
from ..obs import span as _obs_span
from .faults import InjectedFault


@dataclass
class RepairStats:
    """Observability for one ``apply_delta`` call."""

    mode: str                   # "repair" | "recompute"
    touched: int = 0            # endpoints named by the delta
    reactivated: int = 0        # vertices re-seeded undecided (final region)
    expansions: int = 0         # recurrence-check driven region growths
    iterations: int = 0         # fixed-point rounds across all solves
    checked: bool = False       # from-scratch digest check ran
    degraded: bool = False      # repair path failed; served via recompute
    wall_time_s: float = 0.0


def _two_hop(mask: np.ndarray, rows: np.ndarray, cols: np.ndarray,
             hops: int = 2) -> np.ndarray:
    """Closed ``hops``-neighbourhood of ``mask`` over COO edges (host):
    ``reach[r] |= reach[c]`` for every edge, ``hops`` times."""
    reach = mask.copy()
    for _ in range(hops):
        nxt = reach.copy()
        nxt[rows[reach[cols]]] = True
        reach = nxt
    return reach


def _edge_keys(pairs, num_vertices: int) -> np.ndarray:
    """Symmetric (u, v) pairs -> sorted unique int64 ``u * V + v`` keys."""
    if pairs is None or len(pairs) == 0:
        return np.empty(0, dtype=np.int64)
    arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if (arr < 0).any() or (arr >= num_vertices).any():
        raise ValueError("delta edge endpoint out of range")
    keys = np.concatenate([arr[:, 0] * num_vertices + arr[:, 1],
                           arr[:, 1] * num_vertices + arr[:, 0]])
    return np.unique(keys)


def _merge_keys(cur: np.ndarray, adds: np.ndarray, removes: np.ndarray,
                num_vertices: int) -> np.ndarray:
    """``(cur | adds) - removes``, self-loops kept: ``cur`` and the deltas
    are sorted unique keys; the result is too."""
    removes = removes[removes // num_vertices != removes % num_vertices]
    if len(removes):
        pos = np.searchsorted(cur, removes)
        hit = pos < len(cur)
        hit[hit] = cur[pos[hit]] == removes[hit]
        cur = np.delete(cur, pos[hit])
    if len(adds):
        pos = np.searchsorted(cur, adds)
        new = (pos == len(cur)) | (cur[np.minimum(pos, len(cur) - 1)] != adds)
        cur = np.insert(cur, pos[new], adds[new])
    return cur


def _csr_of_keys(keys: np.ndarray, num_vertices: int) -> CSRGraph:
    rows, cols = keys // num_vertices, keys % num_vertices
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=num_vertices))
    return CSRGraph(indptr.astype(np.int32), cols.astype(np.int32))


class StreamSession:
    """A live MIS-2 solution over a mutating graph (fixed vertex set), on
    ``backend``'s device.

    ``options.priority == "fixed"`` (the default here) enables exact
    incremental repair; any other priority downgrades ``apply_delta`` to
    full recomputation.  ``check_fraction`` in ``[0, 1]`` recomputes that
    fraction of deltas from scratch and asserts digest equality
    (deterministic error-diffusion sampling, like the result cache).

    ``faults`` (a :class:`~repro_torch.serve.faults.FaultPlan` or None)
    consults the ``repair`` site: an injected repair failure degrades the
    delta to a from-scratch recompute (``last_repair.degraded``, counted
    ``serve.fallbacks{from=repair,to=recompute}``).
    """

    def __init__(self, graph, *, options: Optional[Mis2Options] = None,
                 check_fraction: float = 0.0, faults=None,
                 backend: Optional[Backend] = None):
        self.options = options if options is not None else \
            Mis2Options(priority="fixed")
        self.faults = faults
        self.check_fraction = float(check_fraction)
        self._check_acc = 0.0
        self.backend = resolve_backend(backend)
        self._device = self.backend.resolve_device()
        csr = ensure_self_loops(as_graph(graph).csr)
        self._v = csr.num_vertices
        indptr = np.asarray(csr.indptr)
        rows = np.repeat(np.arange(self._v, dtype=np.int64), np.diff(indptr))
        self._keys = rows * self._v + np.asarray(csr.indices, np.int64)
        self.graph = Graph(CSRGraph(csr.indptr, csr.indices),
                           device=self._device)
        self._p = None
        if self.options.priority == "fixed":
            self._p = fixed_packed_priorities(self._v, self._device)
        self.result = self._solve_scratch(self.graph)
        self.in_set = np.asarray(self.result.payload)
        self.last_repair: Optional[RepairStats] = None

    # -- internals ----------------------------------------------------------

    def _solve_scratch(self, gh: Graph) -> Mis2Result:
        t0 = time.perf_counter()
        t, iters, syncs = mis2_dense_jittable(
            gh.ell.neighbors,
            torch.ones(self._v, dtype=torch.bool, device=self._device),
            self.options.priority, self.options.max_iters)
        if bool(is_undecided(t).any()):
            raise RuntimeError("MIS-2 fixed point hit max_iters during "
                               "streaming solve; raise Mis2Options.max_iters")
        return Mis2Result((t == IN).cpu().numpy(), iters, True,
                          time.perf_counter() - t0, engine="dense",
                          host_syncs=syncs)

    def _recompute_full(self, gh: Graph, touched: np.ndarray,
                        t_start: float, degraded: bool = False) -> Mis2Result:
        """Serve one delta by full recomputation (the round-varying-
        priority path and the degraded fallback when incremental repair
        faults)."""
        self.result = self._solve_scratch(gh)
        self.in_set = np.asarray(self.result.payload)
        self.graph = gh
        self.last_repair = RepairStats(
            mode="recompute", touched=int(touched.sum()),
            reactivated=self._v,
            iterations=self.result.iterations,
            degraded=degraded,
            wall_time_s=time.perf_counter() - t_start)
        return self.result

    # -- public -------------------------------------------------------------

    def apply_delta(self, edge_adds=None, edge_removes=None) -> Mis2Result:
        """Apply symmetric edge insertions/removals and repair the set.

        Returns the updated facade ``Mis2Result`` (also stored as
        ``self.result``); per-call accounting lands in ``self.last_repair``
        and in the ``repro_torch.obs`` registry (``serve.repair.*``); the
        result carries a ``provenance`` like facade results.  Self-loops
        cannot be removed (closed-neighbourhood semantics) and the vertex
        set is fixed.
        """
        with _obs_span("serve.repair") as sp:
            result = self._apply_delta_impl(edge_adds, edge_removes)
            st = self.last_repair
            sp.annotate(mode=st.mode, touched=st.touched,
                        reactivated=st.reactivated, expansions=st.expansions)
            _OBS.counter("serve.repair.deltas",
                         labels={"mode": st.mode}).inc()
            _OBS.counter("serve.repair.reactivated").inc(st.reactivated)
            _OBS.counter("serve.repair.expansions").inc(st.expansions)
            _OBS.counter("serve.repair.iterations").inc(st.iterations)
        result.provenance = Provenance(
            "mis2", result.engine, backend_platform(self.backend),
            result.digest, sp.to_dict())
        return result

    def _apply_delta_impl(self, edge_adds=None, edge_removes=None):
        t_start = time.perf_counter()
        v = self._v
        adds = _edge_keys(edge_adds, v)
        removes = _edge_keys(edge_removes, v)
        old_keys = self._keys
        self._keys = _merge_keys(old_keys, adds, removes, v)
        gh = Graph(_csr_of_keys(self._keys, v), device=self._device)

        touched_keys = np.concatenate([adds, removes])
        touched = np.zeros(v, dtype=bool)
        touched[np.unique(touched_keys // v)] = True
        touched[np.unique(touched_keys % v)] = True

        if self._p is None:     # round-varying priority: repair is inexact
            return self._recompute_full(gh, touched, t_start)

        try:
            if self.faults is not None:
                self.faults.fire("repair")
            # reactivate the closed 2-hop of touched endpoints, under the
            # union of old and new adjacency (a removed edge still
            # mediated influence)
            u_keys = np.concatenate([old_keys, self._keys])
            region = _two_hop(touched, u_keys // v, u_keys % v)
            rows, cols = self._keys // v, self._keys % v

            neighbors = gh.ell.neighbors
            b = id_bits(v)
            prev_in = self.in_set
            stats = RepairStats(mode="repair", touched=int(touched.sum()))
            while True:
                t0 = torch.from_numpy(np.where(
                    region, np.int64(1),
                    np.where(prev_in, IN, OUT))).to(self._device)
                t, iters, _ = mis2_repair_fixed_point(
                    neighbors, t0, b, self.options.priority,
                    self.options.max_iters)
                stats.iterations += int(iters)
                if bool(is_undecided(t).any()):
                    raise RuntimeError(
                        "repair fixed point hit max_iters; raise "
                        "Mis2Options.max_iters")
                in_dev = t == IN
                # the region grows on the host, as the reference's repair
                # loop pulls its violations every re-solve
                # repro-lint: ignore[RL101] serve.repair.expansions + 1; the reference pulls too
                viol = lexfirst_violations(neighbors, in_dev,
                                           self._p).cpu().numpy()
                if not viol.any():
                    break
                # violations implicate frozen vertices within distance 2:
                # reactivate their closed 2-hop and re-solve (region grows)
                region = region | _two_hop(viol, rows, cols)
                stats.expansions += 1
                if stats.expansions > v:      # unreachable; safety net
                    raise RuntimeError("repair failed to converge")
        except InjectedFault:
            # degraded but live: the delta is served via full recompute,
            # which is exact by construction
            _OBS.counter("serve.fallbacks",
                         labels={"from": "repair", "to": "recompute"}).inc()
            return self._recompute_full(gh, touched, t_start, degraded=True)
        stats.reactivated = int(region.sum())
        in_set = in_dev.cpu().numpy()

        result = Mis2Result(in_set, stats.iterations, True,
                            time.perf_counter() - t_start,
                            engine="stream_repair")
        if self.check_fraction > 0.0:
            self._check_acc += min(1.0, self.check_fraction)
            if self._check_acc >= 1.0:
                self._check_acc -= 1.0
                stats.checked = True
                scratch = self._solve_scratch(gh)
                if scratch.digest != result.digest:
                    raise AssertionError(
                        f"incremental repair diverged from from-scratch: "
                        f"{result.digest} != {scratch.digest}")
        self.graph = gh
        self.in_set = in_set
        self.result = result
        stats.wall_time_s = time.perf_counter() - t_start
        self.last_repair = stats
        return result
