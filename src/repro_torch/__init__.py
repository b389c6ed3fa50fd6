"""repro_torch — the PyTorch/CUDA port of ``repro``: distance-2 MIS and
MIS-2 graph coarsening on hand-written Hopper kernels.

It imports torch, numpy and the standard library only — never jax, and
nothing of the JAX package, which stays in the repository as the reference
each part of the port is held against (equal determinism digests).
"""
from . import graphs
from .api import (
    AggregationResult,
    Backend,
    Mis2Result,
    Result,
    coarsen,
    determinism_digest,
    list_engines,
    mis2,
)
from .core.mis2 import Mis2Options
from .graphs import Graph

__all__ = [
    "graphs", "Graph", "Backend", "Mis2Options", "mis2", "coarsen",
    "list_engines", "Result", "Mis2Result", "AggregationResult",
    "determinism_digest",
]
