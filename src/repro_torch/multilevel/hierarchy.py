"""Multilevel setup: SA-AMG hierarchies and cluster-GS packing, the two
engines of ``repro.multilevel.hierarchy``, giving equal hierarchies (per-level
``A_l`` digests, P, R, diagonals, cluster labels, colors and packed rows).

* ``host``: the prolongator and Galerkin product are numpy/scipy on the
  host, as in the reference's ``host`` engine; each level's matrices are
  then copied to the device.
* ``resident``: the whole per-level setup on the graph's device, in
  float64 — the prolongator from the aggregation labels, the two-stage
  sorted-COO Galerkin product on the run-sum kernel, the coarse ELL, the
  coarse graph of cluster GS and the cluster packing.  After aggregation
  no matrix-sized array leaves the device; only shape scalars (row
  widths, entry counts, per-color geometry) come back.  The reference's
  7 stage calls a level (2 prolongator, 4 Galerkin, 1 pack) are counted in
  :attr:`AMGHierarchy.dispatches`.

Both engines count in the ``repro_torch.obs`` registry as the reference
does: ``multilevel.host_syncs`` (the host engine's matrix-sized round-trips,
3 a level, and 1 for each cluster-GS coarse graph and packing) and
``multilevel.resident_dispatches`` (the resident engine's stage calls, 7 a
level, and 2 for each cluster-GS coarse graph and packing).

The aggregation inside (MIS-2 coarsening, one persistent kernel a MIS-2
solve), the coloring, every level matrix and the whole solve phase live on
the graph's device; the ``float32`` coarsest-level LU factors and solves
there too.

``hierarchy_from_arrays`` builds a hierarchy from given per-level arrays
(for instance the reference's), so the solve phase can be held against
the reference's on one and the same hierarchy.
"""
from __future__ import annotations

import functools
import hashlib
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..graphs.csr import (
    CSRMatrix,
    ELLMatrix,
    csr_to_ell_arrays,
    csr_to_ell_matrix,
    ell_matrix_to,
)
from ..graphs.handle import Graph, as_graph
from ..graphs.ops import (
    coarse_graph_from_labels,
    ell_diagonal,
    extract_diagonal,
    matrix_to_scipy,
)
from ..kernels.spmv_ell import ops as spmv_ops
from ..obs import metrics as _obs
from .galerkin import (
    _coarse_graph_ell_device,
    _coarse_graph_keys_device,
    _coo_rows_repack_device,
    _coo_to_ell_device,
    _pad_p_rows,
    _spgemm_stage1_device,
    _spgemm_stage2_device,
    galerkin_coo_host,
)
from .packing import pack_clusters_device, pack_clusters_host
from .prolongator import (
    _prolongator_device,
    _prolongator_pack_device,
    rect_ell,
    smoothed_prolongator_host,
)

ENGINES = ("host", "resident")
#: the resident engine's stage calls a level, as the reference counts its
#: jitted dispatches: prolongator 2, Galerkin 4 (stage 1, repack, stage 2,
#: coarse ELL), pack 1
STAGES_PER_LEVEL = 7
#: the ``obs`` counters of the setup (the reference's names)
HOST_SYNCS = "multilevel.host_syncs"
RESIDENT_DISPATCHES = "multilevel.resident_dispatches"


@dataclass
class AMGLevel:
    a_ell: ELLMatrix
    diag: torch.Tensor
    p_ell: ELLMatrix | None        # prolongator (fine x coarse), None at coarsest
    r_ell: ELLMatrix | None        # restriction = P^T, None when matrix-free
    n: int
    nnz: int
    p_t: spmv_ops.EllTranspose | None = None   # P^T gather plan (matrix-free)


@dataclass
class AMGHierarchy:
    levels: List[AMGLevel]
    coarse_solve: Callable
    setup_seconds: float
    aggregation_seconds: float
    aggregation: str
    omega: float
    jacobi_weight: float
    smoother_sweeps: int
    level_sizes: list = field(default_factory=list)
    engine: str = "host"
    coarse_dtype: str = "float32"
    coarse_kind: str = "lu"        # 'lu' | 'jacobi' (above dense_coarse_cap)
    timings: dict = field(default_factory=dict)
    dispatches: int = 0            # resident stage calls this build
    _digests: list | None = None

    def as_precond(self) -> Callable:
        from ..solvers.amg import v_cycle   # lazy: solvers imports us

        return functools.partial(v_cycle, self)

    def level_digests(self) -> list[str]:
        """Per-level ``A_l`` ELL digest (cols + vals + mask), computed on
        first use — the only place the level matrices come to the host."""
        if self._digests is None:
            self._digests = [ell_matrix_digest(lvl.a_ell)
                             for lvl in self.levels]
        return self._digests


def ell_matrix_digest(ell: ELLMatrix) -> str:
    """One digest over an ELL matrix's (cols, vals, mask), from the
    per-array :func:`determinism_digest` — the reference's definition."""
    from ..api.result import determinism_digest   # lazy: api imports us

    h = hashlib.sha256()
    for arr in (ell.cols, ell.vals, ell.mask):
        h.update(determinism_digest(arr.cpu().numpy()).encode())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# coarsest-level solver
# ---------------------------------------------------------------------------

def resolve_coarse_dtype(coarse_dtype: Optional[str],
                         device: torch.device) -> str:
    """Default coarse factorization dtype: float32 on the card, float64 on
    the CPU, as the reference picks it by platform."""
    if coarse_dtype is not None:
        if coarse_dtype not in ("float32", "float64"):
            raise ValueError(f"unknown coarse_dtype {coarse_dtype!r}")
        return str(coarse_dtype)
    return "float32" if device.type == "cuda" else "float64"


def _coarse_solver(dense, coarse_dtype: str,
                   device: torch.device) -> Callable:
    """Cached dense factorization of the coarsest matrix (host numpy or a
    device tensor).

    ``float32`` factors on the device and solves there, with no host copy
    per V-cycle (a device ``dense`` never leaves it); ``float64`` factors
    and solves on the host with scipy."""
    if coarse_dtype == "float64":
        import scipy.linalg as sla

        if isinstance(dense, torch.Tensor):
            dense = dense.cpu().numpy()
        lu_piv = sla.lu_factor(np.asarray(dense, dtype=np.float64))

        def coarse_solve(b):
            x = sla.lu_solve(lu_piv, b.cpu().numpy().astype(np.float64))
            return torch.from_numpy(x.astype(np.float32)).to(b.device)

        return coarse_solve
    lu, piv = torch.linalg.lu_factor(
        torch.as_tensor(dense).to(device=device, dtype=torch.float32))

    def coarse_solve(b):
        return torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]

    return coarse_solve


def _jacobi_coarse_solver(a_ell: ELLMatrix, diag: torch.Tensor,
                          weight: float, sweeps: int) -> Callable:
    """Fallback when the coarsest level exceeds ``dense_coarse_cap``:
    weighted-Jacobi sweeps instead of an O(n^2) dense factorization."""
    w = float(np.float32(weight))

    def coarse_solve(b):
        x = torch.zeros_like(b)
        for _ in range(sweeps):
            ax = spmv_ops.spmv(a_ell.cols, a_ell.vals, x)
            x = x + w * (b - ax) / diag
        return x

    return coarse_solve


def _ell_to_dense_device(a: ELLMatrix) -> torch.Tensor:
    """The coarsest ELL matrix densified on its device (float32: each entry
    is one ELL value)."""
    n = a.num_rows
    rows = torch.arange(n, device=a.cols.device)[:, None].expand_as(a.cols)
    dense = torch.zeros((n, n), dtype=torch.float32, device=a.cols.device)
    dense[rows[a.mask], a.cols[a.mask].to(torch.int64)] = a.vals[a.mask]
    return dense


def _ell_dense(cols: np.ndarray, vals: np.ndarray,
               mask: np.ndarray) -> np.ndarray:
    n = cols.shape[0]
    dense = np.zeros((n, n), dtype=np.float64)
    rows = np.broadcast_to(np.arange(n)[:, None], cols.shape)
    np.add.at(dense, (rows[mask], cols[mask]), vals[mask])
    return dense


def _finish(levels: List[AMGLevel], dense, coarse_dtype: str,
            dense_coarse_cap: int, jacobi_weight: float,
            smoother_sweeps: int, explicit_restriction: bool,
            device: torch.device):
    """Coarse solver and, without explicit R, each level's P^T plan.
    ``dense`` is a callable giving the coarsest matrix densified, on the
    host or the device (called only under the cap).  Returns
    ``(coarse_solve, kind)``."""
    coarsest = levels[-1]
    if coarsest.n <= dense_coarse_cap:
        coarse_solve = _coarse_solver(dense(), coarse_dtype, device)
        kind = "lu"
    else:
        coarse_solve = _jacobi_coarse_solver(
            coarsest.a_ell, coarsest.diag, jacobi_weight,
            sweeps=8 * smoother_sweeps)
        kind = "jacobi"
    if not explicit_restriction:
        for lvl, nxt in zip(levels[:-1], levels[1:]):
            lvl.r_ell = None      # v_cycle restricts via spmv_t instead
            lvl.p_t = spmv_ops.ell_transpose(lvl.p_ell.cols, lvl.p_ell.mask,
                                             nxt.n)
    return coarse_solve, kind


# ---------------------------------------------------------------------------
# host-engine levels
# ---------------------------------------------------------------------------

def _add_time(timings: dict, key: str, t0: float) -> None:
    timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def _host_level(cur: CSRMatrix, a_ell: ELLMatrix | None, labels: np.ndarray,
                nagg: int, omega: float, timings: dict,
                device: torch.device):
    """One host-engine level: scipy prolongator, canonical numpy Galerkin,
    then the level's A, P, R and diagonal copied to the device.  Returns
    ``(level, a_next)``."""
    v = cur.num_rows
    t0 = time.perf_counter()
    pr, pc, pv = smoothed_prolongator_host(cur, labels, nagg, omega)
    _obs.counter(HOST_SYNCS).inc()
    _add_time(timings, "prolongator", t0)
    t0 = time.perf_counter()
    a_host = csr_to_ell_arrays(cur)
    p_pad_cols, p_pad_vals = _pad_p_rows(pr, pc, pv, v)
    cr, cc, cv = galerkin_coo_host(*a_host, p_pad_cols, p_pad_vals, nagg)
    indptr = np.zeros(nagg + 1, dtype=np.int64)
    np.add.at(indptr, cr + 1, 1)
    a_next = CSRMatrix(np.cumsum(indptr).astype(np.int32),
                       cc.astype(np.int32), cv.astype(np.float32))
    _obs.counter(HOST_SYNCS).inc()
    _add_time(timings, "galerkin", t0)
    t0 = time.perf_counter()
    pv32 = pv.astype(np.float32)
    level = AMGLevel(a_ell if a_ell is not None else
                     ell_matrix_to(a_host, device),
                     extract_diagonal(cur, device),
                     rect_ell(pr, pc, pv32, v, device),
                     rect_ell(pc, pr, pv32, nagg, device),
                     v, cur.num_entries)
    _obs.counter(HOST_SYNCS).inc()
    _add_time(timings, "pack", t0)
    return level, a_next


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work, so that a phase's time is its
    own and not the next phase's."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _phase(name: str):
    """A named range of a resident setup phase, for ``torch.profiler``."""
    return torch.profiler.record_function(f"multilevel.{name}")


def _resident_level(a_ell: ELLMatrix, nnz: int, labels: np.ndarray,
                    nagg: int, omega: float, timings: dict):
    """One resident-engine level on ``a_ell``'s device: prolongator (2
    stages), Galerkin product (4), P and R (1).  Returns ``(level, a_next,
    nnz_next)``; only shape scalars come to the host."""
    dev = a_ell.cols.device
    v = a_ell.num_rows
    t0 = time.perf_counter()
    with _phase("prolongator"):
        p_cols, p_vals, p_mask, diag = _prolongator_device(
            a_ell, labels, nagg, omega)
        _sync(dev)
    _obs.counter(RESIDENT_DISPATCHES).inc(2)
    _add_time(timings, "prolongator", t0)
    t0 = time.perf_counter()
    with _phase("galerkin"):
        q = _coo_rows_repack_device(
            *_spgemm_stage1_device(*a_ell, p_cols, p_vals, p_mask, v), v, v)
        keys, sums = _spgemm_stage2_device(p_cols, p_vals, p_mask, *q, v)
        a_next = _coo_to_ell_device(keys, sums, v, nagg)
        nnz_next = int(keys.shape[0])
        _sync(dev)
    _obs.counter(RESIDENT_DISPATCHES).inc(4)
    _add_time(timings, "galerkin", t0)
    t0 = time.perf_counter()
    with _phase("pack"):
        p_ell, r_ell = _prolongator_pack_device(p_cols, p_vals, p_mask, nagg)
        _sync(dev)
    _obs.counter(RESIDENT_DISPATCHES).inc()
    _add_time(timings, "pack", t0)
    return AMGLevel(a_ell, diag, p_ell, r_ell, v, nnz), a_next, nnz_next


def _aggregation(aggregation: str, options, mis2_engine: Optional[str]):
    """``graph -> AggregationResult`` for the named coarsening method."""
    from ..api.backend import default_mis2_engine
    from ..api.registry import get_engine

    fn = get_engine("aggregation", aggregation)
    return lambda g: fn(g, options,
                        mis2_engine or default_mis2_engine(g, options), 2)


def _build_hierarchy_impl(a, aggregation: str = "two_phase",
                          max_levels: int = 10, coarse_size: int = 200,
                          omega: float = 2.0 / 3.0,
                          jacobi_weight: float = 2.0 / 3.0,
                          smoother_sweeps: int = 2,
                          options=None,
                          mis2_engine: Optional[str] = None,
                          coarse_dtype: Optional[str] = None,
                          dense_coarse_cap: Optional[int] = None,
                          explicit_restriction: bool = True,
                          engine: str = "host",
                          first_agg=None) -> AMGHierarchy:
    """Build the SA-AMG hierarchy of matrix ``a`` (a ``Graph`` handle with
    values, or a ``CSRMatrix``) on its device with the multilevel
    ``engine`` (``host`` | ``resident``).

    ``dense_coarse_cap`` (default: ``coarse_size``) bounds the dense
    coarsest-level factorization; a coarsest level above it gets
    weighted-Jacobi sweeps instead.  ``explicit_restriction=False`` drops
    the stored ``R = P^T`` after the build; the V-cycle then restricts
    through the transposed SpMV kernel on P.

    ``first_agg`` optionally injects a precomputed finest-level
    ``AggregationResult``, used once in place of the first aggregation (the
    batched setup aggregates every finest level of a batch at once and
    finishes each hierarchy here).
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown multilevel engine {engine!r} "
                         f"({' | '.join(ENGINES)})")
    gh = as_graph(a)
    dev = gh.device
    coarse_dtype = resolve_coarse_dtype(coarse_dtype, dev)
    if dense_coarse_cap is None:
        dense_coarse_cap = coarse_size
    t_setup = time.perf_counter()
    t_agg = 0.0
    timings: dict = {}
    aggregate = _aggregation(aggregation, options, mis2_engine)

    levels: List[AMGLevel] = []
    sizes = []
    cur_graph, a_ell = gh, gh.ell_matrix
    cur = gh.csr_matrix if engine == "host" else None
    n, nnz = gh.num_vertices, gh.num_entries
    while len(levels) < max_levels - 1 and n > coarse_size:
        t0 = time.perf_counter()
        if first_agg is not None:
            agg, first_agg = first_agg, None
        else:
            agg = aggregate(cur_graph)
        dt = time.perf_counter() - t0
        t_agg += dt
        timings["aggregate"] = timings.get("aggregate", 0.0) + dt
        if agg.num_aggregates >= n:
            break
        if engine == "host":
            level, cur = _host_level(cur, a_ell, agg.labels,
                                     agg.num_aggregates, omega, timings, dev)
            cur_graph, a_ell = Graph(cur.graph, device=dev), None
            n, nnz = cur.num_rows, cur.num_entries
        else:
            level, a_ell, nnz = _resident_level(
                a_ell, nnz, agg.labels, agg.num_aggregates, omega, timings)
            cur_graph, n = Graph(a_ell), agg.num_aggregates
        levels.append(level)
        sizes.append((level.n, level.nnz))

    if engine == "host":
        levels.append(AMGLevel(
            a_ell if a_ell is not None else csr_to_ell_matrix(cur,
                                                              device=dev),
            extract_diagonal(cur, dev), None, None, n, nnz))

        def dense():
            return np.asarray(matrix_to_scipy(cur).todense())
    else:
        levels.append(AMGLevel(a_ell, ell_diagonal(a_ell), None, None, n,
                               nnz))

        def dense():
            return _ell_to_dense_device(a_ell)
    sizes.append((n, nnz))
    t0 = time.perf_counter()
    coarse_solve, coarse_kind = _finish(
        levels, dense, coarse_dtype, dense_coarse_cap, jacobi_weight,
        smoother_sweeps, explicit_restriction, dev)
    _add_time(timings, "pack", t0)
    return AMGHierarchy(
        levels, coarse_solve, time.perf_counter() - t_setup, t_agg,
        aggregation, omega, jacobi_weight, smoother_sweeps, sizes,
        engine=engine, coarse_dtype=coarse_dtype, coarse_kind=coarse_kind,
        timings=timings,
        dispatches=0 if engine == "host"
        else STAGES_PER_LEVEL * (len(levels) - 1))


def hierarchy_from_arrays(levels: list, *, jacobi_weight: float = 2.0 / 3.0,
                          smoother_sweeps: int = 2,
                          coarse_dtype: Optional[str] = None,
                          dense_coarse_cap: int = 200,
                          explicit_restriction: bool = True,
                          device: torch.device | str = "cuda"
                          ) -> AMGHierarchy:
    """An :class:`AMGHierarchy` from host arrays, finest level first.

    Each entry of ``levels`` is a dict with ``a = (cols, vals, mask)``,
    ``diag``, ``n``, ``nnz`` and, on every level but the coarsest,
    ``p = (cols, vals, mask)`` and ``r = (cols, vals, mask)``: the ELL
    arrays of a hierarchy built elsewhere (the reference's, in the tests).
    The coarse solver is set up as :func:`_build_hierarchy_impl` does.
    """
    dev = torch.device(device)
    coarse_dtype = resolve_coarse_dtype(coarse_dtype, dev)
    built = []
    for lv in levels:
        p, r = lv.get("p"), lv.get("r")
        built.append(AMGLevel(
            ell_matrix_to(lv["a"], dev),
            torch.from_numpy(np.array(lv["diag"], np.float32)).to(dev),
            None if p is None else ell_matrix_to(p, dev),
            None if r is None else ell_matrix_to(r, dev),
            int(lv["n"]), int(lv["nnz"])))
    coarse_solve, coarse_kind = _finish(
        built, lambda: _ell_dense(*(np.asarray(x) for x in levels[-1]["a"])),
        coarse_dtype, dense_coarse_cap, jacobi_weight, smoother_sweeps,
        explicit_restriction, dev)
    return AMGHierarchy(
        built, coarse_solve, 0.0, 0.0, "", 0.0, jacobi_weight,
        smoother_sweeps, [(lv.n, lv.nnz) for lv in built],
        engine="arrays", coarse_dtype=coarse_dtype, coarse_kind=coarse_kind)


# ---------------------------------------------------------------------------
# cluster-GS setup
# ---------------------------------------------------------------------------

def _cluster_gs_setup_impl(a, aggregation: str = "two_phase", options=None,
                           coarsen_levels: int = 1,
                           mis2_engine: Optional[str] = None,
                           engine: str = "host"):
    """Aggregate -> color the coarse graph -> pack cluster rows, with the
    coarse graph and the packing on the host (``host``) or the graph's
    device (``resident``).

    Returns ``(color_rows, num_colors, num_clusters, labels, colors,
    timings, color_rounds)`` with ``timings`` the setup-phase split
    ``{aggregate, color, pack}`` in seconds.
    """
    from ..core.coloring import _color_graph_impl

    if engine not in ENGINES:
        raise ValueError(f"unknown multilevel engine {engine!r} "
                         f"({' | '.join(ENGINES)})")
    gh = as_graph(a)
    dev = gh.device
    v = gh.num_vertices
    timings = {"aggregate": 0.0, "color": 0.0, "pack": 0.0}
    aggregate = _aggregation(aggregation, options, mis2_engine)

    def coarse_structure(labels, nagg):
        if engine == "host":
            g = coarse_graph_from_labels(gh.csr, labels, nagg)
            _obs.counter(HOST_SYNCS).inc()
            return Graph(g, device=dev)
        with _phase("coarse_graph"):
            ell = gh.ell
            keys = _coarse_graph_keys_device(
                ell.neighbors, ell.mask,
                torch.from_numpy(np.asarray(labels, dtype=np.int64)).to(dev),
                v)
            g = _coarse_graph_ell_device(keys, v, nagg)
        _obs.counter(RESIDENT_DISPATCHES).inc(2)
        return Graph(g)

    t0 = time.perf_counter()
    agg = aggregate(gh)
    labels, nagg = agg.labels, agg.num_aggregates
    timings["aggregate"] += time.perf_counter() - t0
    for _ in range(coarsen_levels - 1):        # optional deeper clustering
        t0 = time.perf_counter()
        agg2 = aggregate(coarse_structure(labels, nagg))
        labels = agg2.labels[labels]
        nagg = agg2.num_aggregates
        timings["aggregate"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    coloring = _color_graph_impl(coarse_structure(labels, nagg))
    timings["color"] += time.perf_counter() - t0
    if not coloring.converged:     # a partial coloring is unusable for GS
        raise RuntimeError("coarse-graph coloring did not converge")

    t0 = time.perf_counter()
    if engine == "host":
        color_rows = pack_clusters_host(labels, coloring.colors,
                                        coloring.num_colors, v, dev)
        _obs.counter(HOST_SYNCS).inc()
    else:
        with _phase("pack"):
            color_rows = pack_clusters_device(labels, coloring.colors,
                                              coloring.num_colors, v, dev)
            _sync(dev)
        _obs.counter(RESIDENT_DISPATCHES).inc(2)
    timings["pack"] += time.perf_counter() - t0
    return color_rows, coloring.num_colors, nagg, labels, \
        coloring.colors, timings, coloring.rounds
