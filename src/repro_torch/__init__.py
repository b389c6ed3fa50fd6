"""repro_torch — the PyTorch/CUDA port of ``repro``: distance-2 and
distance-k MIS, MIS-2 graph coarsening, multilevel partitioning, Luby
coloring, SA-AMG and cluster multicolor Gauss-Seidel on hand-written
Hopper kernels; the distributed MIS-2 engines over ``torch.distributed``
and the serving layer (``repro_torch.serve``).

It imports torch, numpy and the standard library only — never jax, and
nothing of the JAX package, which stays in the repository as the reference
each part of the port is held against (equal determinism digests).
"""
from . import api, graphs, obs, solvers
from .api import (
    ABLATION_CHAIN,
    AggregationResult,
    AmgSetup,
    Backend,
    BatchResult,
    ClusterGsSetup,
    ColoringResult,
    GraphBatch,
    Mis2Result,
    PartitionResult,
    Result,
    amg,
    amg_setup,
    amg_setup_batch,
    as_graph_batch,
    cluster_gs_setup,
    coarsen,
    coarsen_batch,
    color,
    color_batch,
    determinism_digest,
    list_engines,
    mis2,
    mis2_batch,
    misk,
    partition,
)
from .core.mis2 import Mis2Options
from .graphs import Graph

#: the reference's version string: the port answers as the same release
__version__ = "0.2.0"


def __getattr__(name: str):
    """``repro_torch.serve`` is imported on first use, as the reference's
    ``repro.serve`` is."""
    if name == "serve":
        import importlib

        return importlib.import_module(".serve", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "api", "__version__", "graphs", "solvers", "Graph", "Backend", "Mis2Options", "mis2", "misk",
    "coarsen", "color", "partition", "amg_setup", "amg", "cluster_gs_setup",
    "list_engines", "Result", "Mis2Result", "AggregationResult",
    "ColoringResult", "PartitionResult", "AmgSetup", "ClusterGsSetup",
    "determinism_digest", "ABLATION_CHAIN", "obs", "mis2_batch",
    "color_batch", "coarsen_batch", "amg_setup_batch", "GraphBatch",
    "as_graph_batch", "BatchResult", "serve",
]
