"""repro_torch — the PyTorch/CUDA port of ``repro``: distance-2 and
distance-k MIS, MIS-2 graph coarsening, multilevel partitioning, Luby
coloring, SA-AMG and cluster multicolor Gauss-Seidel on hand-written
Hopper kernels.

It imports torch, numpy and the standard library only — never jax, and
nothing of the JAX package, which stays in the repository as the reference
each part of the port is held against (equal determinism digests).
"""
from . import graphs, solvers
from .api import (
    ABLATION_CHAIN,
    AggregationResult,
    AmgSetup,
    Backend,
    ClusterGsSetup,
    ColoringResult,
    Mis2Result,
    PartitionResult,
    Result,
    amg,
    amg_setup,
    cluster_gs_setup,
    coarsen,
    color,
    determinism_digest,
    list_engines,
    mis2,
    misk,
    partition,
)
from .core.mis2 import Mis2Options
from .graphs import Graph

__all__ = [
    "graphs", "solvers", "Graph", "Backend", "Mis2Options", "mis2", "misk",
    "coarsen", "color", "partition", "amg_setup", "amg", "cluster_gs_setup",
    "list_engines", "Result", "Mis2Result", "AggregationResult",
    "ColoringResult", "PartitionResult", "AmgSetup", "ClusterGsSetup",
    "determinism_digest", "ABLATION_CHAIN",
]
