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


# the single-graph and distributed engines: one dispatch, ``run_mis2``;
# name -> (the reference's names for it, doc)
_MIS2_ENGINES = {
    "dense": ((), "fixed point over masks, every row each round (no "
                  "worklist compaction); the plain baseline"),
    "compacted": ((), "host-orchestrated §V-B worklist compaction; the "
                      "path behind the Fig. 2 ablation"),
    "cuda_compacted": (("pallas",),
                       "compacted driver with the hand-written "
                       "min-propagation kernels (refresh_columns, decide) "
                       "on the measured hot loop"),
    "compacted_resident": ((), "device-resident §V-B fixed point: "
                               "worklists compacted on the device (cumsum "
                               "stream compaction) — bit-identical to "
                               "'compacted'"),
    "cuda_resident": (("pallas_resident",),
                      "resident driver with the FUSED passes (rank packing "
                      "folded into the refresh, row-gather folded into "
                      "decide) inside one persistent kernel: one launch a "
                      "solve, no host read inside it; the facade default"),
    "cuda_hybrid": (("pallas_hybrid",),
                    "resident driver over the degree-aware hybrid layout "
                    "(sliced-ELL degree buckets + sorted-COO spill for "
                    "heavy hitters) in one persistent kernel — O(E) memory "
                    "on skewed graphs whose padded ELL cannot be "
                    "allocated, bit-identical to 'dense'; auto-selected "
                    "past the padded-ELL bytes threshold"),
    "distributed": ((), "vertex partition over Backend(group=...): T and M "
                        "all-gathered per iteration (2·V·4 B collective "
                        "traffic) — bit-identical to 'dense' for any rank "
                        "count"),
    "distributed_single_gather": (
        (), "distributed variant gathering T once per iteration and "
            "recomputing M locally (V·4 B collective traffic — half of "
            "'distributed'; replicates the ELL adjacency)"),
}
for _name, (_aliases, _doc) in _MIS2_ENGINES.items():
    register_engine("mis2", _name, aliases=_aliases, doc=_doc)(
        _single_graph(_name))


@register_engine("mis2", "dense_batched",
                 doc="batched fixed point over padded size buckets "
                     "(repro_torch.batch); a single-graph call runs as a "
                     "batch of one — bit-identical to 'dense'")
def _mis2_dense_batched(graph, active, options, backend=None):
    actives = None if active is None else [active]
    return _mis2_batch_impl(GraphBatch([graph]), options, actives)[0]


@register_engine("aggregation", "basic", aliases=("mis2_basic",),
                 doc="paper Alg. 2 (Bell-style): MIS-2 roots + neighbors")
def _agg_basic(graph, options, mis2_engine, min_secondary_neighbors,
               backend=None):
    return _aggregate_basic_impl(graph, options, mis2_engine, backend)


@register_engine("aggregation", "two_phase", aliases=("mis2_agg",),
                 doc="paper Alg. 3 (ML-style): two MIS-2 phases + "
                     "max-coupling cleanup")
def _agg_two_phase(graph, options, mis2_engine, min_secondary_neighbors,
                   backend=None):
    return _aggregate_two_phase_impl(graph, options, mis2_engine,
                                     min_secondary_neighbors, backend)


@register_engine("aggregation", "two_phase_distributed",
                 doc="paper Alg. 3 sharded over Backend(group=...): both "
                     "MIS-2 phases run the distributed fixed point and "
                     "each label-propagation round is one label "
                     "all-gather + local rowwise join — labels "
                     "bit-identical to 'two_phase'")
def _agg_two_phase_distributed(graph, options, mis2_engine,
                               min_secondary_neighbors, backend=None):
    """The inner engine must be one of the two distributed ones (None:
    ``distributed``); any other raises rather than being absorbed."""
    if mis2_engine not in (None, *DISTRIBUTED_ENGINES):
        raise ValueError(
            f"two_phase_distributed runs a distributed MIS-2; got "
            f"mis2_engine={mis2_engine!r} (use 'distributed' | "
            "'distributed_single_gather')")
    return _aggregate_two_phase_distributed_impl(
        graph, options, min_secondary_neighbors, backend=backend,
        single_gather=mis2_engine == "distributed_single_gather")


@register_engine("aggregation", "serial",
                 doc="host-sequential greedy reference (Table V 'Serial "
                     "Agg')")
def _agg_serial(graph, options, mis2_engine, min_secondary_neighbors,
                backend=None):
    return _aggregate_serial_greedy_impl(graph)


register_engine(
    "coloring", "luby",
    doc="Luby-style rounds with xorshift* packed priorities, one "
        "persistent kernel a coloring")(_color_graph_impl)
register_engine(
    "coloring", "luby_hybrid",
    doc="Luby rounds over the degree-aware hybrid layout (sliced-ELL + COO "
        "spill); bit-identical colors without the monolithic padded "
        "ELL")(_color_hybrid_impl)


def _multilevel(engine: str):
    def run(kind, graph, **kwargs):
        fn = _build_hierarchy_impl if kind == "amg" \
            else _cluster_gs_setup_impl
        return fn(graph, engine=engine, **kwargs)

    return run


register_engine(
    "multilevel", "host",
    doc="host orchestration: scipy smoothed prolongator, canonical "
        "sorted-COO Galerkin on numpy, numpy cluster packing — ~3 "
        "matrix-sized host round-trips per level")(_multilevel("host"))
register_engine(
    "multilevel", "resident",
    doc="whole per-level setup on the device: prolongator assembly, "
        "sorted-COO Galerkin product (the run-sum kernel), coarse ELL "
        "repack, cluster/color packing — no matrix-sized host sync, "
        "digest-identical to 'host'; the facade default on CUDA")(
    _multilevel("resident"))

register_engine(
    "misk", "dense",
    doc="k-fold min-propagation over masked [V] state, one launch of the "
        "misk kernel a solve")(_mis_k_impl)
register_engine(
    "misk", "resident",
    doc="§V-B worklist shape for distance-k: the compacted worklist feeds "
        "the row refresh — bit-identical to 'dense' (the default); kept "
        "for ablation")(_misk_resident_impl)


@register_engine("partition", "multilevel",
                 doc="MIS-2 multilevel coarsen + greedy coarse split + "
                     "boundary refinement per level")
def _partition_multilevel(graph, num_parts, coarse_target, options):
    return _partition_impl(
        graph, num_parts, coarse_target, options,
        lambda level: default_mis2_engine(level, options))
