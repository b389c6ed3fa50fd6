"""Built-in engine registrations.

* ``mis2``:        fn(graph, active, options, backend=None)
                   -> core Mis2Result
* ``aggregation``: fn(graph, options, mis2_engine, min_secondary_neighbors,
                   backend=None) -> core AggregationResult
* ``coloring``:    fn(graph, max_rounds) -> core ColoringResult
* ``multilevel``:  fn(kind, graph, **kwargs) with kind 'amg' | 'cluster_gs'
                   -> AMGHierarchy | cluster-GS setup tuple
* ``misk``:        fn(graph, k, priority, max_iters) -> core Mis2Result
* ``partition``:   fn(graph, num_parts, coarse_target, options)
                   -> core PartitionResult

Every ``mis2`` and ``aggregation`` engine is given the call's ``Backend``
(the distributed engines, inner or outer, read its process group; the
others ignore it).
"""
from __future__ import annotations

from ..batch.container import GraphBatch
from ..batch.pipeline import _mis2_batch_impl
from ..core.aggregation import (
    _aggregate_basic_impl,
    _aggregate_serial_greedy_impl,
    _aggregate_two_phase_distributed_impl,
    _aggregate_two_phase_impl,
)
from ..core.coloring import _color_graph_impl, _color_hybrid_impl
from ..core.mis2 import DISTRIBUTED_ENGINES, run_mis2
from ..core.misk import _mis_k_impl, _misk_resident_impl
from ..core.partition import _partition_impl
from ..multilevel.hierarchy import (
    _build_hierarchy_impl,
    _cluster_gs_setup_impl,
)
from .backend import default_mis2_engine
from .registry import register_engine


def _single_graph(name: str):
    def engine(graph, active, options, backend=None):
        return run_mis2(graph, active, options, name, backend)
    return engine


# the single-graph and distributed engines: one dispatch, ``run_mis2``
for _name in ("dense", "compacted", "cuda_compacted", "compacted_resident",
              "cuda_resident", "cuda_hybrid", *DISTRIBUTED_ENGINES):
    register_engine("mis2", _name)(_single_graph(_name))


@register_engine("mis2", "dense_batched")
def _mis2_dense_batched(graph, active, options, backend=None):
    """A single graph as a batch of one (``mis2_batch``'s fixed point):
    bit-identical to ``dense``."""
    actives = None if active is None else [active]
    return _mis2_batch_impl(GraphBatch([graph]), options, actives)[0]


@register_engine("aggregation", "basic")
def _agg_basic(graph, options, mis2_engine, min_secondary_neighbors,
               backend=None):
    return _aggregate_basic_impl(graph, options, mis2_engine, backend)


@register_engine("aggregation", "two_phase")
def _agg_two_phase(graph, options, mis2_engine, min_secondary_neighbors,
                   backend=None):
    return _aggregate_two_phase_impl(graph, options, mis2_engine,
                                     min_secondary_neighbors, backend)


@register_engine("aggregation", "two_phase_distributed")
def _agg_two_phase_distributed(graph, options, mis2_engine,
                               min_secondary_neighbors, backend=None):
    """Alg. 3 over ``Backend.group``: both MIS-2 phases sharded, each label
    round one label all-gather and the local rowwise join.  The inner
    engine must be one of the two distributed ones (None: ``distributed``);
    any other raises rather than being absorbed."""
    if mis2_engine not in (None, *DISTRIBUTED_ENGINES):
        raise ValueError(
            f"two_phase_distributed runs a distributed MIS-2; got "
            f"mis2_engine={mis2_engine!r} (use 'distributed' | "
            "'distributed_single_gather')")
    return _aggregate_two_phase_distributed_impl(
        graph, options, min_secondary_neighbors, backend=backend,
        single_gather=mis2_engine == "distributed_single_gather")


@register_engine("aggregation", "serial")
def _agg_serial(graph, options, mis2_engine, min_secondary_neighbors,
                backend=None):
    return _aggregate_serial_greedy_impl(graph)


register_engine("coloring", "luby")(_color_graph_impl)
register_engine("coloring", "luby_hybrid")(_color_hybrid_impl)


def _multilevel(engine: str):
    def run(kind, graph, **kwargs):
        fn = _build_hierarchy_impl if kind == "amg" \
            else _cluster_gs_setup_impl
        return fn(graph, engine=engine, **kwargs)

    return run


register_engine("multilevel", "host")(_multilevel("host"))
register_engine("multilevel", "resident")(_multilevel("resident"))

register_engine("misk", "dense")(_mis_k_impl)
register_engine("misk", "resident")(_misk_resident_impl)


@register_engine("partition", "multilevel")
def _partition_multilevel(graph, num_parts, coarse_target, options):
    return _partition_impl(
        graph, num_parts, coarse_target, options,
        lambda level: default_mis2_engine(level, options))
