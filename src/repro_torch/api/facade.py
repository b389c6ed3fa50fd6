"""The public facade: one call per pipeline with the JAX package's
signatures (``repro.api.facade``), engines dispatched by name, results in
the :class:`~repro_torch.api.result.Result` form.  An engine may be named
by an alias, the reference's names among them (``pallas_resident`` runs
``cuda_resident``, ``mis2_agg`` ``two_phase``); results and provenance
name the canonical engine.

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

    br = rt.mis2_batch(graphs)               # many graphs, one pass a
    br.digests                               # size bucket (also color_,
                                             # coarsen_, amg_setup_batch)

Every result carries ``provenance`` (:class:`~repro_torch.obs.Provenance`):
the call's kind, engine, platform (``gpu`` on CUDA, else ``cpu``), digest
and root span ``api.<kind>`` with its wall time and metric deltas (host
syncs, resident dispatches, conversions, multilevel stage calls).  A
``BatchResult`` and its members share one batch-level record.
"""
from __future__ import annotations

import time

import numpy as np

from ..batch.container import GraphBatch
from ..batch.pipeline import (
    _amg_setup_batch_impl,
    _coarsen_batch_impl,
    _color_batch_impl,
    _mis2_batch_impl,
)
from ..core.aggregation import _aggregate_serial_greedy_impl
from ..core.coloring import MAX_ROUNDS_DEFAULT
from ..core.mis2 import Mis2Options
from ..graphs.handle import Graph, as_graph
from ..obs import Provenance
from ..obs import span as _obs_span
from .backend import (
    Backend,
    backend_platform,
    default_mis2_engine,
    default_misk_engine,
    default_multilevel_engine,
    resolve_backend,
)
from .registry import _canonical, get_engine
from .result import (
    AggregationResult,
    AmgSetup,
    BatchResult,
    ClusterGsSetup,
    ColoringResult,
    Mis2Result,
    PartitionResult,
)


def _prepare(graph, be: Backend) -> Graph:
    return as_graph(graph).place(be.resolve_device())


def _traced(kind: str, engine, be: Backend, call, wrap):
    """Run one facade engine call inside an ``obs`` span and attach the
    provenance record to the wrapped Result.

    ``call()`` runs the engine; ``wrap(core, dt)`` builds the facade Result
    from its output and wall seconds.  The root span ``api.<kind>`` (wall
    time and the metric deltas inside the call) with the engine, platform
    and digest become ``result.provenance``."""
    platform = backend_platform(be)
    with _obs_span(f"api.{kind}", engine=str(engine),
                   backend=platform) as sp:
        t0 = time.perf_counter()
        core = call()
        dt = time.perf_counter() - t0
        result = wrap(core, dt)
    result.provenance = Provenance(kind, str(engine), platform,
                                   getattr(result, "digest", ""),
                                   sp.to_dict())
    return result


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
    engine = default_mis2_engine(gh, options) if engine is None \
        else _canonical("mis2", engine)
    fn = get_engine("mis2", engine)
    return _traced(
        "mis2", engine, be, lambda: fn(gh, active, options, backend=be),
        lambda r, dt: Mis2Result(
            r.in_set, r.iterations, r.converged, dt, engine=engine,
            host_syncs=r.host_syncs, collectives=r.collectives,
            num_compiles=r.num_compiles))


def misk(graph, k: int = 2, *, priority: str = "xorshift_star",
         max_iters: int = 256, engine: str | None = None,
         backend: Backend | None = None) -> Mis2Result:
    """Distance-k maximal independent set (k-fold min-propagation):
    ``dense`` and ``resident`` (the worklist refresh) return bit-identical
    sets, equal to the JAX package's.  ``engine=None`` selects ``dense``.
    ``result.engine`` is ``f"misk{k}_{engine}"``; ``host_syncs`` is 0 on
    the card (one launch a solve) and counts the CPU twin's live-count
    read a round."""
    be = resolve_backend(backend)
    gh = _prepare(graph, be)
    engine = default_misk_engine() if engine is None \
        else _canonical("misk", engine)
    fn = get_engine("misk", engine)
    return _traced(
        "misk", engine, be, lambda: fn(gh, k, priority, max_iters),
        lambda r, dt: Mis2Result(
            r.in_set, r.iterations, r.converged, dt,
            engine=f"misk{k}_{engine}", host_syncs=r.host_syncs,
            num_compiles=r.num_compiles))


def coarsen(graph, *, method: str = "two_phase",
            options: Mis2Options | None = None,
            mis2_engine: str | None = None,
            min_secondary_neighbors: int = 2,
            backend: Backend | None = None) -> AggregationResult:
    """MIS-2 graph coarsening: ``method`` is ``two_phase`` (paper Alg. 3),
    ``basic`` (Alg. 2), ``serial`` (host-sequential reference) or
    ``two_phase_distributed`` (Alg. 3 with every MIS-2 and label round
    sharded over ``Backend.group``; ``mis2_engine=
    "distributed_single_gather"`` for the half-traffic schedule).
    ``mis2_engine=None`` selects the inner fixed points as ``mis2`` does
    (``cuda_hybrid``, with the joins over the hybrid layout, past the
    threshold), ``distributed`` for the sharded method; a distributed
    inner engine with ``basic`` / ``two_phase`` shards the MIS-2 only."""
    be = resolve_backend(backend)
    gh = _prepare(graph, be)
    method = _canonical("aggregation", method)
    fn = get_engine("aggregation", method)
    if mis2_engine is not None:
        inner = _canonical("mis2", mis2_engine)
    elif method == "two_phase_distributed":
        inner = "distributed"
    else:
        inner = default_mis2_engine(gh, options)
    return _traced(
        "coarsen", method, be,
        lambda: fn(gh, options, inner, min_secondary_neighbors, backend=be),
        lambda r, dt: _wrap_aggregation(r, dt, inner))


def _wrap_aggregation(r, dt: float, engine: str) -> AggregationResult:
    return AggregationResult(r.labels, r.mis2_iterations, r.converged, dt,
                             num_aggregates=r.num_aggregates, roots=r.roots,
                             phase=r.phase, engine=engine)


def _wrap_coloring(r, dt: float) -> ColoringResult:
    return ColoringResult(r.colors, r.rounds, r.converged, dt,
                          num_colors=r.num_colors, host_syncs=r.host_syncs)


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
    engine = _canonical("coloring", engine)
    fn = get_engine("coloring", engine)
    return _traced("color", engine, be, lambda: fn(gh, max_rounds),
                   _wrap_coloring)


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
    engine = _canonical("partition", engine)
    fn = get_engine("partition", engine)
    return _traced(
        "partition", engine, be,
        lambda: fn(gh, num_parts, coarse_target, options),
        lambda r, dt: PartitionResult(
            r.parts, r.levels, r.converged, dt, num_parts=r.num_parts,
            edge_cut=r.edge_cut, levels=r.levels, history=list(r.history)))


def _wrap_hierarchy(h, aggregation: str, engine: str,
                    wall_time: float) -> AmgSetup:
    sizes = np.asarray(h.level_sizes, dtype=np.int64).reshape(-1, 2)
    return AmgSetup(sizes, len(h.levels), True, wall_time, hierarchy=h,
                    aggregation=aggregation, setup_seconds=h.setup_seconds,
                    aggregation_seconds=h.aggregation_seconds, engine=engine,
                    timings=dict(h.timings), dispatches=h.dispatches)


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
    engine = default_multilevel_engine(gh) if engine is None \
        else _canonical("multilevel", engine)
    aggregation = _canonical("aggregation", aggregation)
    mis2_engine = _canonical("mis2", mis2_engine)
    fn = get_engine("multilevel", engine)
    return _traced(
        "amg_setup", engine, be,
        lambda: fn("amg", gh, aggregation=aggregation, max_levels=max_levels,
                   coarse_size=coarse_size, omega=omega,
                   jacobi_weight=jacobi_weight,
                   smoother_sweeps=smoother_sweeps, options=options,
                   mis2_engine=mis2_engine, coarse_dtype=coarse_dtype,
                   dense_coarse_cap=dense_coarse_cap,
                   explicit_restriction=explicit_restriction),
        lambda h, dt: _wrap_hierarchy(h, aggregation, engine, dt))


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
    engine = default_multilevel_engine(gh) if engine is None \
        else _canonical("multilevel", engine)
    aggregation = _canonical("aggregation", aggregation)
    mis2_engine = _canonical("mis2", mis2_engine)
    fn = get_engine("multilevel", engine)

    def build(out, dt):
        color_rows, num_colors, nagg, labels, colors, timings, rounds = out
        pre = MulticolorGSPreconditioner(
            gh.ell_matrix, extract_diagonal(gh.csr_matrix, gh.device),
            color_rows, num_colors, nagg, dt, "cluster", timings=timings)
        return ClusterGsSetup(labels, 0, True, dt, preconditioner=pre,
                              num_colors=num_colors, num_clusters=nagg,
                              colors=colors, engine=engine, timings=timings,
                              color_rounds=rounds)

    return _traced(
        "cluster_gs_setup", engine, be,
        lambda: fn("cluster_gs", gh, aggregation=aggregation,
                   options=options, coarsen_levels=coarsen_levels,
                   mis2_engine=mis2_engine),
        build)


# ---------------------------------------------------------------------------
# batched entry points: many graphs, one pass per size bucket
# ---------------------------------------------------------------------------

def _traced_batch(kind: str, engine: str, be: Backend, call,
                  wrap) -> BatchResult:
    """:func:`_traced` for a batched call: the batch-level provenance (one
    span over every bucket) is shared by the ``BatchResult`` and each of
    its members."""
    batch = _traced(kind, engine, be, call, wrap)
    for r in batch.results:
        r.provenance = batch.provenance
    return batch


def _prepare_batch(graphs, be: Backend) -> GraphBatch:
    """The batch on the backend's device: a ``GraphBatch`` already there as
    it is, else every member placed there (cached formats move with it) and
    stacked anew."""
    dev = be.resolve_device()
    if isinstance(graphs, GraphBatch):
        if graphs.device == dev:
            return graphs
        graphs = graphs.graphs
    return GraphBatch([as_graph(g).place(dev) for g in graphs])


def _per_graph(core: list, dt: float) -> float:
    return dt / max(1, len(core))


def mis2_batch(graphs, *, options: Mis2Options | None = None,
               backend: Backend | None = None) -> BatchResult:
    """Distance-2 MIS over many graphs at once: size-bucketed, each bucket
    one block-diagonal dense fixed point (a few launches a round for ``B``
    graphs).  Each per-graph result (digest, iterations, ``converged``) is
    bit-identical to ``mis2(g, engine="dense")`` and to the JAX package's
    ``mis2_batch``.  ``graphs`` is a sequence of ``Graph`` handles /
    structural containers, or a ``GraphBatch`` (reusable across calls)."""
    be = resolve_backend(backend)
    batch = _prepare_batch(graphs, be)

    def wrap(core, dt):
        per = _per_graph(core, dt)
        return BatchResult(
            [Mis2Result(r.in_set, r.iterations, r.converged, per,
                        engine="dense_batched", host_syncs=r.host_syncs)
             for r in core], dt, engine="dense_batched",
            bucket_shapes=batch.bucket_shapes)

    return _traced_batch("mis2_batch", "dense_batched", be,
                         lambda: _mis2_batch_impl(batch, options), wrap)


def color_batch(graphs, *, max_rounds: int = MAX_ROUNDS_DEFAULT,
                backend: Backend | None = None) -> BatchResult:
    """Batched deterministic greedy coloring (Luby rounds over each bucket,
    one batched hash-pack launch a round); each per-graph result equals
    ``color(g)``'s bit for bit."""
    be = resolve_backend(backend)
    batch = _prepare_batch(graphs, be)

    def wrap(core, dt):
        per = _per_graph(core, dt)
        return BatchResult([_wrap_coloring(r, per) for r in core], dt,
                           engine="luby_batched",
                           bucket_shapes=batch.bucket_shapes)

    return _traced_batch("color_batch", "luby_batched", be,
                         lambda: _color_batch_impl(batch, max_rounds), wrap)


def coarsen_batch(graphs, *, method: str = "two_phase",
                  options: Mis2Options | None = None,
                  min_secondary_neighbors: int = 2,
                  backend: Backend | None = None) -> BatchResult:
    """Batched MIS-2 coarsening (paper Alg. 2 / 3) over the batched dense
    MIS-2; per-graph labels equal ``coarsen(g, method=...)``'s bit for bit.
    ``serial`` runs the host-sequential reference per graph, with no
    stacking (``bucket_shapes`` empty)."""
    be = resolve_backend(backend)
    method = _canonical("aggregation", method)
    if method == "serial":
        members = graphs.graphs if isinstance(graphs, GraphBatch) \
            else [as_graph(g) for g in graphs]

        def wrap_serial(core, dt):
            per = _per_graph(core, dt)
            return BatchResult([_wrap_aggregation(r, per, "serial")
                                for r in core], dt, engine="serial_batched")

        return _traced_batch(
            "coarsen_batch", "serial_batched", be,
            lambda: [_aggregate_serial_greedy_impl(g) for g in members],
            wrap_serial)
    batch = _prepare_batch(graphs, be)

    def wrap(core, dt):
        per = _per_graph(core, dt)
        return BatchResult([_wrap_aggregation(r, per, "dense_batched")
                            for r in core], dt, engine=f"{method}_batched",
                           bucket_shapes=batch.bucket_shapes)

    return _traced_batch(
        "coarsen_batch", f"{method}_batched", be,
        lambda: _coarsen_batch_impl(batch, method, options,
                                    min_secondary_neighbors), wrap)


def amg_setup_batch(matrices, *, aggregation: str = "two_phase",
                    engine: str | None = None,
                    options: Mis2Options | None = None,
                    backend: Backend | None = None,
                    **hierarchy_kwargs) -> BatchResult:
    """Batched AMG setup: every member's finest-level aggregation runs
    through the batched coarsening, then each hierarchy is finished by the
    multilevel ``engine`` (``engine=None``: ``resident`` on CUDA, ``host``
    on the CPU); ``hierarchy_kwargs`` are ``amg_setup``'s.  Per-graph
    hierarchies equal ``amg_setup(a, ...)``'s (equal level digests)."""
    be = resolve_backend(backend)
    batch = _prepare_batch(matrices, be)
    engine = default_multilevel_engine(batch.graphs[0]) if engine is None \
        else _canonical("multilevel", engine)
    aggregation = _canonical("aggregation", aggregation)

    def wrap(hierarchies, dt):
        per = _per_graph(hierarchies, dt)
        return BatchResult([_wrap_hierarchy(h, aggregation, engine, per)
                            for h in hierarchies], dt,
                           engine=f"{engine}_batched",
                           bucket_shapes=batch.bucket_shapes)

    return _traced_batch(
        "amg_setup_batch", f"{engine}_batched", be,
        lambda: _amg_setup_batch_impl(batch, aggregation, options,
                                      engine=engine, **hierarchy_kwargs),
        wrap)
