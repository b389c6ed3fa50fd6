"""The public facade: ``mis2`` and ``coarsen`` with the JAX package's
signatures (``repro.api.facade``), engines dispatched by name, results in
the :class:`~repro_torch.api.result.Result` form.

    import repro_torch as rt

    g = rt.Graph(rt.graphs.laplace3d(100))
    r = rt.mis2(g)                           # cuda_resident on the card
    agg = rt.coarsen(g, method="two_phase")
"""
from __future__ import annotations

import time

from ..core.mis2 import Mis2Options
from ..graphs.handle import Graph, as_graph
from .backend import DEFAULT_MIS2_ENGINE, Backend, resolve_backend
from .registry import get_engine
from .result import AggregationResult, Mis2Result


def _prepare(graph, be: Backend) -> Graph:
    return as_graph(graph).place(be.resolve_device())


def mis2(graph, *, active=None, options: Mis2Options | None = None,
         engine: str | None = None,
         backend: Backend | None = None) -> Mis2Result:
    """Distance-2 maximal independent set (paper Alg. 1); ``dense`` and
    ``cuda_resident`` return bit-identical sets (equal ``digest``), equal
    to the JAX package's for equal graph and options.  ``engine=None``
    selects ``cuda_resident``."""
    be = resolve_backend(backend)
    gh = _prepare(graph, be)
    engine = DEFAULT_MIS2_ENGINE if engine is None else engine
    fn = get_engine("mis2", engine)
    t0 = time.perf_counter()
    r = fn(gh, active, options)
    dt = time.perf_counter() - t0
    return Mis2Result(r.in_set, r.iterations, r.converged, dt, engine=engine,
                      host_syncs=r.host_syncs)


def coarsen(graph, *, method: str = "two_phase",
            options: Mis2Options | None = None,
            mis2_engine: str | None = None,
            min_secondary_neighbors: int = 2,
            backend: Backend | None = None) -> AggregationResult:
    """MIS-2 graph coarsening: ``method`` is ``two_phase`` (paper Alg. 3),
    ``basic`` (Alg. 2) or ``serial`` (host-sequential reference).
    ``mis2_engine=None`` selects ``cuda_resident`` for the inner fixed
    points."""
    be = resolve_backend(backend)
    gh = _prepare(graph, be)
    fn = get_engine("aggregation", method)
    inner = DEFAULT_MIS2_ENGINE if mis2_engine is None else mis2_engine
    t0 = time.perf_counter()
    r = fn(gh, options, inner, min_secondary_neighbors)
    dt = time.perf_counter() - t0
    return AggregationResult(r.labels, r.mis2_iterations, r.converged, dt,
                             num_aggregates=r.num_aggregates, roots=r.roots,
                             phase=r.phase, engine=inner)
