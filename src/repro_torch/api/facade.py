"""The public facade: one call per pipeline with the JAX package's
signatures (``repro.api.facade``), engines dispatched by name, results in
the :class:`~repro_torch.api.result.Result` form.

    import repro_torch as rt

    a = rt.Graph(rt.graphs.laplace3d(100))
    r = rt.mis2(a)                           # cuda_resident on the card
                                             # (cuda_hybrid past 256 MiB)
    r3 = rt.misk(a, k=3)                     # distance-3 MIS
    agg = rt.coarsen(a, method="two_phase")
    parts = rt.partition(a, 8)               # multilevel, MIS-2 coarsening
    amg = rt.amg_setup(a)                    # SA-AMG hierarchy, set up on
    gs = rt.cluster_gs_setup(a)              # the card (engine resident)
    # then rt.solvers.cg(matvec, b, precond=amg.as_precond(), tol=1e-6)
"""
from __future__ import annotations

import time

import numpy as np

from ..core.coloring import MAX_ROUNDS_DEFAULT
from ..core.mis2 import Mis2Options
from ..graphs.handle import Graph, as_graph
from .backend import (
    Backend,
    default_mis2_engine,
    default_misk_engine,
    default_multilevel_engine,
    resolve_backend,
)
from .registry import get_engine
from .result import (
    AggregationResult,
    AmgSetup,
    ClusterGsSetup,
    ColoringResult,
    Mis2Result,
    PartitionResult,
)


def _prepare(graph, be: Backend) -> Graph:
    return as_graph(graph).place(be.resolve_device())


def mis2(graph, *, active=None, options: Mis2Options | None = None,
         engine: str | None = None,
         backend: Backend | None = None) -> Mis2Result:
    """Distance-2 maximal independent set (paper Alg. 1); ``dense``,
    ``compacted``, ``cuda_compacted``, ``compacted_resident``,
    ``cuda_resident`` and ``cuda_hybrid`` return bit-identical sets (equal
    ``digest``), equal to the JAX package's for equal graph and options.
    ``engine=None`` selects ``cuda_resident``, or ``cuda_hybrid`` (the
    sliced-ELL + COO-spill layout, O(E) memory) once the padded-ELL bytes
    estimate passes ``repro_torch.graphs.hybrid.HYBRID_AUTO_BYTES``; for
    options the kernels do not take (the Fig. 2 ablations of
    ``ABLATION_CHAIN``) it selects the engine that runs them
    (``api.backend.default_mis2_engine``).  The hybrid engine reports its
    traffic accounting in ``collectives``; the host-driven engines their
    worklist-bucket pairs in ``num_compiles``."""
    be = resolve_backend(backend)
    gh = _prepare(graph, be)
    engine = default_mis2_engine(gh, options) if engine is None else engine
    fn = get_engine("mis2", engine)
    t0 = time.perf_counter()
    r = fn(gh, active, options)
    dt = time.perf_counter() - t0
    return Mis2Result(r.in_set, r.iterations, r.converged, dt, engine=engine,
                      host_syncs=r.host_syncs, collectives=r.collectives,
                      num_compiles=r.num_compiles)


def misk(graph, k: int = 2, *, priority: str = "xorshift_star",
         max_iters: int = 256, engine: str | None = None,
         backend: Backend | None = None) -> Mis2Result:
    """Distance-k maximal independent set (k-fold min-propagation):
    ``dense`` and ``resident`` (the worklist refresh) return bit-identical
    sets, equal to the JAX package's.  ``engine=None`` selects ``dense``.
    ``result.engine`` is ``f"misk{k}_{engine}"``; ``host_syncs`` counts the
    one live-flag read a round."""
    be = resolve_backend(backend)
    gh = _prepare(graph, be)
    engine = default_misk_engine() if engine is None else engine
    fn = get_engine("misk", engine)
    t0 = time.perf_counter()
    r = fn(gh, k, priority, max_iters)
    dt = time.perf_counter() - t0
    return Mis2Result(r.in_set, r.iterations, r.converged, dt,
                      engine=f"misk{k}_{engine}", host_syncs=r.host_syncs,
                      num_compiles=r.num_compiles)


def coarsen(graph, *, method: str = "two_phase",
            options: Mis2Options | None = None,
            mis2_engine: str | None = None,
            min_secondary_neighbors: int = 2,
            backend: Backend | None = None) -> AggregationResult:
    """MIS-2 graph coarsening: ``method`` is ``two_phase`` (paper Alg. 3),
    ``basic`` (Alg. 2) or ``serial`` (host-sequential reference).
    ``mis2_engine=None`` selects the inner fixed points as ``mis2`` does
    (``cuda_hybrid``, with the joins over the hybrid layout, past the
    threshold)."""
    be = resolve_backend(backend)
    gh = _prepare(graph, be)
    fn = get_engine("aggregation", method)
    inner = default_mis2_engine(gh, options) if mis2_engine is None \
        else mis2_engine
    t0 = time.perf_counter()
    r = fn(gh, options, inner, min_secondary_neighbors)
    dt = time.perf_counter() - t0
    return AggregationResult(r.labels, r.mis2_iterations, r.converged, dt,
                             num_aggregates=r.num_aggregates, roots=r.roots,
                             phase=r.phase, engine=inner)


def color(graph, *, max_rounds: int = MAX_ROUNDS_DEFAULT,
          engine: str = "luby",
          backend: Backend | None = None) -> ColoringResult:
    """Deterministic parallel greedy distance-1 coloring, equal (colors and
    digest) to the JAX package's: ``engine`` is ``luby`` (padded ELL) or
    ``luby_hybrid`` (the hybrid layout).  If the round limit is hit before
    every vertex is colored the result comes back with ``converged=False``
    (uncolored vertices hold ``-1``) instead of raising."""
    be = resolve_backend(backend)
    gh = _prepare(graph, be)
    fn = get_engine("coloring", engine)
    t0 = time.perf_counter()
    r = fn(gh, max_rounds)
    dt = time.perf_counter() - t0
    return ColoringResult(r.colors, r.rounds, r.converged, dt,
                          num_colors=r.num_colors, host_syncs=r.host_syncs)


def partition(graph, num_parts: int, *, coarse_target: int | None = None,
              options: Mis2Options | None = None,
              engine: str = "multilevel",
              backend: Backend | None = None) -> PartitionResult:
    """Multilevel graph partitioning via MIS-2 aggregation (paper §VII):
    parts, edge cut, levels and per-level ``(V, E)`` history equal to the
    JAX package's.  Each level coarsens on the device (the inner MIS-2 as
    ``coarsen`` selects it: ``cuda_resident`` on the card); the greedy
    split of the coarsest graph and the refinement's moves run on the
    host."""
    be = resolve_backend(backend)
    gh = _prepare(graph, be)
    fn = get_engine("partition", engine)
    t0 = time.perf_counter()
    r = fn(gh, num_parts, coarse_target, options)
    dt = time.perf_counter() - t0
    return PartitionResult(r.parts, r.levels, r.converged, dt,
                           num_parts=r.num_parts, edge_cut=r.edge_cut,
                           levels=r.levels, history=list(r.history))


def amg_setup(matrix, *, aggregation: str = "two_phase",
              engine: str | None = None, max_levels: int = 10,
              coarse_size: int = 200, omega: float = 2.0 / 3.0,
              jacobi_weight: float = 2.0 / 3.0, smoother_sweeps: int = 2,
              options: Mis2Options | None = None,
              mis2_engine: str | None = None,
              coarse_dtype: str | None = None,
              dense_coarse_cap: int | None = None,
              explicit_restriction: bool = True,
              backend: Backend | None = None) -> AmgSetup:
    """Smoothed-aggregation AMG setup (paper Table V) through the
    ``multilevel`` registry: ``host`` (prolongator and Galerkin product on
    the host) or ``resident`` (the whole per-level setup on the device);
    ``engine=None`` selects ``resident`` for a graph on CUDA and ``host``
    on the CPU.  Either engine's level matrices are bit-identical to the
    JAX package's ``host`` engine (equal ``level_digests``) and live on the
    device with the whole solve phase.

    ``coarse_dtype`` picks the dense coarsest-level factorization (default:
    float32, on the card; float64 on the CPU, with scipy);
    ``dense_coarse_cap`` (default: ``coarse_size``) bounds the densified
    size, above which weighted-Jacobi sweeps stand in.
    ``explicit_restriction=False`` drops the stored ``R = P^T``; the
    V-cycle then restricts through the transposed SpMV kernel on P."""
    be = resolve_backend(backend)
    gh = _prepare(matrix, be)
    engine = default_multilevel_engine(gh) if engine is None else engine
    fn = get_engine("multilevel", engine)
    t0 = time.perf_counter()
    h = fn("amg", gh, aggregation=aggregation, max_levels=max_levels,
           coarse_size=coarse_size, omega=omega, jacobi_weight=jacobi_weight,
           smoother_sweeps=smoother_sweeps, options=options,
           mis2_engine=mis2_engine, coarse_dtype=coarse_dtype,
           dense_coarse_cap=dense_coarse_cap,
           explicit_restriction=explicit_restriction)
    dt = time.perf_counter() - t0
    sizes = np.asarray(h.level_sizes, dtype=np.int64).reshape(-1, 2)
    return AmgSetup(sizes, len(h.levels), True, dt, hierarchy=h,
                    aggregation=aggregation, setup_seconds=h.setup_seconds,
                    aggregation_seconds=h.aggregation_seconds, engine=engine,
                    timings=dict(h.timings), dispatches=h.dispatches)


def amg(matrix, *, aggregation: str = "two_phase", max_levels: int = 10,
        coarse_size: int = 200, omega: float = 2.0 / 3.0,
        jacobi_weight: float = 2.0 / 3.0, smoother_sweeps: int = 2,
        options: Mis2Options | None = None,
        backend: Backend | None = None) -> AmgSetup:
    """:func:`amg_setup` with the default engine (the reference's
    ``repro.amg``)."""
    return amg_setup(matrix, aggregation=aggregation, max_levels=max_levels,
                     coarse_size=coarse_size, omega=omega,
                     jacobi_weight=jacobi_weight,
                     smoother_sweeps=smoother_sweeps, options=options,
                     backend=backend)


def cluster_gs_setup(matrix, *, aggregation: str = "two_phase",
                     engine: str | None = None,
                     options: Mis2Options | None = None,
                     coarsen_levels: int = 1,
                     mis2_engine: str | None = None,
                     backend: Backend | None = None) -> ClusterGsSetup:
    """Cluster multicolor Gauss-Seidel setup (paper Alg. 4 / Table VI):
    aggregate with MIS-2, color the coarse graph, pack cluster rows per
    color.  Labels and colors equal the JAX package's (equal ``digest``
    and ``colors_digest``); the coarse graph and the packing run on the
    host (``host``) or the device (``resident``), and ``engine=None``
    selects ``resident`` for a graph on CUDA and ``host`` on the CPU."""
    from ..graphs.ops import extract_diagonal
    from ..solvers.multicolor_gs import MulticolorGSPreconditioner

    be = resolve_backend(backend)
    gh = _prepare(matrix, be)
    engine = default_multilevel_engine(gh) if engine is None else engine
    fn = get_engine("multilevel", engine)
    t0 = time.perf_counter()
    color_rows, num_colors, nagg, labels, colors, timings, rounds = fn(
        "cluster_gs", gh, aggregation=aggregation, options=options,
        coarsen_levels=coarsen_levels, mis2_engine=mis2_engine)
    dt = time.perf_counter() - t0
    pre = MulticolorGSPreconditioner(
        gh.ell_matrix, extract_diagonal(gh.csr_matrix, gh.device),
        color_rows, num_colors, nagg, dt, "cluster", timings=timings)
    return ClusterGsSetup(labels, 0, True, dt, preconditioner=pre,
                          num_colors=num_colors, num_clusters=nagg,
                          colors=colors, engine=engine, timings=timings,
                          color_rounds=rounds)
