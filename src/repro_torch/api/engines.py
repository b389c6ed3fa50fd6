"""Built-in engine registrations.

* ``mis2``:        fn(graph, active, options) -> core Mis2Result
* ``aggregation``: fn(graph, options, mis2_engine, min_secondary_neighbors)
                   -> core AggregationResult
* ``coloring``:    fn(graph, max_rounds) -> core ColoringResult
* ``multilevel``:  fn(kind, graph, **kwargs) with kind 'amg' | 'cluster_gs'
                   -> AMGHierarchy | cluster-GS setup tuple
* ``misk``:        fn(graph, k, priority, max_iters) -> core Mis2Result
* ``partition``:   fn(graph, num_parts, coarse_target, options)
                   -> core PartitionResult
"""
from __future__ import annotations

from ..batch.container import GraphBatch
from ..batch.pipeline import _mis2_batch_impl
from ..core.aggregation import (
    _aggregate_basic_impl,
    _aggregate_serial_greedy_impl,
    _aggregate_two_phase_impl,
)
from ..core.coloring import _color_graph_impl, _color_hybrid_impl
from ..core.mis2 import (
    _mis2_compacted_impl,
    _mis2_dense_impl,
    _mis2_resident_impl,
    _mis2_resident_plain_impl,
)
from ..core.mis2_hybrid import _mis2_hybrid_impl
from ..core.misk import _mis_k_impl, _misk_resident_impl
from ..core.partition import _partition_impl
from ..multilevel.hierarchy import (
    _build_hierarchy_impl,
    _cluster_gs_setup_impl,
)
from .backend import default_mis2_engine
from .registry import register_engine

register_engine("mis2", "dense")(_mis2_dense_impl)
register_engine("mis2", "compacted")(_mis2_compacted_impl)
register_engine("mis2", "compacted_resident")(_mis2_resident_plain_impl)
register_engine("mis2", "cuda_resident")(_mis2_resident_impl)
register_engine("mis2", "cuda_hybrid")(_mis2_hybrid_impl)


@register_engine("mis2", "dense_batched")
def _mis2_dense_batched(graph, active, options):
    """A single graph as a batch of one (``mis2_batch``'s fixed point):
    bit-identical to ``dense``."""
    actives = None if active is None else [active]
    return _mis2_batch_impl(GraphBatch([graph]), options, actives)[0]


@register_engine("mis2", "cuda_compacted")
def _mis2_cuda_compacted(graph, active, options):
    return _mis2_compacted_impl(graph, active, options, kernels=True)


@register_engine("aggregation", "basic")
def _agg_basic(graph, options, mis2_engine, min_secondary_neighbors):
    return _aggregate_basic_impl(graph, options, mis2_engine)


@register_engine("aggregation", "two_phase")
def _agg_two_phase(graph, options, mis2_engine, min_secondary_neighbors):
    return _aggregate_two_phase_impl(graph, options, mis2_engine,
                                     min_secondary_neighbors)


@register_engine("aggregation", "serial")
def _agg_serial(graph, options, mis2_engine, min_secondary_neighbors):
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
