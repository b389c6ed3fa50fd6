"""``repro_torch.api`` — the public surface of the port, the names of
``repro.api``'s:

* :class:`Graph` — the cached-format handle (CSR on the host, the ELL forms
  and the hybrid layout on its device, each built once);
* :class:`Backend` — the execution policy (the device, the process group
  of the distributed engines), with a process default
  (:func:`get_default_backend`, :func:`set_default_backend`,
  :func:`using_backend`);
* the engine registry — ``(pipeline, engine-name)`` dispatch, the
  reference's engine names and aliases routable (:func:`get_engine_spec`);
  every engine of a pipeline returns the common :class:`Result` protocol.

``default_interpret`` (the reference's Pallas interpret-mode switch) has
no counterpart: on the CPU the kernels' plain-torch twins run instead.
"""
from ..batch.container import GraphBatch, as_graph_batch
from ..core.mis2 import ABLATION_CHAIN, Mis2Options
from . import engines as _engines  # noqa: F401  (registers built-in engines)
from . import generators  # noqa: F401  (problem generators, re-exported)
from .backend import (
    DEFAULT_MIS2_ENGINE,
    Backend,
    accelerator_present,
    default_misk_engine,
    default_multilevel_engine,
    get_default_backend,
    set_default_backend,
    using_backend,
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
from .graph import Graph, as_csr_graph, as_ell_graph, as_graph
from .registry import (
    EngineSpec,
    get_engine,
    get_engine_spec,
    list_engines,
    register_engine,
)
from .result import (
    AggregationResult,
    AmgSetup,
    BatchResult,
    ClusterGsSetup,
    ColoringResult,
    Mis2Result,
    PartitionResult,
    Result,
    ResultLike,
    determinism_digest,
)

__all__ = [
    # facade calls
    "mis2", "misk", "color", "coarsen", "partition", "amg",
    # multilevel setup
    "amg_setup", "cluster_gs_setup",
    # batched facade calls (repro_torch.batch)
    "mis2_batch", "color_batch", "coarsen_batch", "amg_setup_batch",
    "GraphBatch", "as_graph_batch", "BatchResult",
    # graph handle
    "Graph", "as_graph", "as_ell_graph", "as_csr_graph",
    # backend policy
    "Backend", "accelerator_present", "get_default_backend",
    "set_default_backend", "using_backend", "DEFAULT_MIS2_ENGINE",
    "default_misk_engine", "default_multilevel_engine",
    # engine registry
    "register_engine", "get_engine", "get_engine_spec", "list_engines",
    "EngineSpec",
    # problem generators (repro_torch.api.generators.laplace3d, ...)
    "generators",
    # options / results
    "Mis2Options", "ABLATION_CHAIN",
    "Result", "ResultLike", "Mis2Result", "ColoringResult",
    "AggregationResult", "PartitionResult", "AmgSetup", "ClusterGsSetup",
    "determinism_digest",
]
