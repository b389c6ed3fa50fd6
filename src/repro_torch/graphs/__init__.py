"""Graph containers, generators, the ``Graph`` handle (numpy on the host,
torch tensors on the device) and the sparse operations (``ops``)."""
from . import ops
from .csr import (
    CSRGraph,
    CSRMatrix,
    ELLGraph,
    ELLMatrix,
    csr_from_coo,
    csr_to_ell_graph,
    csr_to_ell_matrix,
    ell_to_csr_graph,
    ensure_self_loops,
    pad_ell_graph,
)
from .generators import (
    elasticity3d,
    laplace3d,
    paper_suite,
    path_graph,
    powerlaw_graph,
    random_skewed_graph,
    random_uniform_graph,
)
from .handle import (
    ELL_BYTE_LIMIT,
    ELL_BYTES_PER_SLOT,
    Graph,
    LayoutOverflowError,
    as_graph,
    ell_bytes_estimate,
)
from .hybrid import (
    HYBRID_AUTO_BYTES,
    HybridEllGraph,
    HybridSlice,
    csr_to_hybrid_ell,
)

__all__ = [
    "ops", "CSRGraph", "CSRMatrix", "ELLGraph", "ELLMatrix", "csr_from_coo",
    "csr_to_ell_graph", "csr_to_ell_matrix", "ell_to_csr_graph",
    "ensure_self_loops",
    "pad_ell_graph", "elasticity3d", "laplace3d", "paper_suite", "path_graph",
    "powerlaw_graph", "random_skewed_graph", "random_uniform_graph",
    "ELL_BYTE_LIMIT", "ELL_BYTES_PER_SLOT", "Graph", "LayoutOverflowError",
    "as_graph",
    "ell_bytes_estimate", "HYBRID_AUTO_BYTES", "HybridEllGraph",
    "HybridSlice", "csr_to_hybrid_ell",
]
