"""``repro_torch.api`` — the public surface of the port."""
from ..batch.container import GraphBatch, as_graph_batch
from ..core.mis2 import ABLATION_CHAIN, Mis2Options
from . import engines as _engines  # noqa: F401  (registers built-in engines)
from .backend import (
    DEFAULT_MIS2_ENGINE,
    Backend,
    default_misk_engine,
    default_multilevel_engine,
)
from .facade import (
    amg,
    amg_setup,
    amg_setup_batch,
    cluster_gs_setup,
    coarsen,
    coarsen_batch,
    color,
    color_batch,
    mis2,
    mis2_batch,
    misk,
    partition,
)
from .registry import get_engine, list_engines, register_engine
from .result import (
    AggregationResult,
    AmgSetup,
    BatchResult,
    ClusterGsSetup,
    ColoringResult,
    Mis2Result,
    PartitionResult,
    Result,
    determinism_digest,
)

__all__ = [
    "mis2", "misk", "coarsen", "color", "partition", "amg_setup", "amg",
    "cluster_gs_setup", "Backend", "DEFAULT_MIS2_ENGINE",
    "default_misk_engine", "default_multilevel_engine", "get_engine",
    "list_engines", "register_engine", "AggregationResult", "AmgSetup",
    "ClusterGsSetup", "ColoringResult", "Mis2Result", "PartitionResult",
    "Result", "determinism_digest", "Mis2Options", "ABLATION_CHAIN",
    "mis2_batch", "color_batch", "coarsen_batch", "amg_setup_batch",
    "GraphBatch", "as_graph_batch", "BatchResult",
]
