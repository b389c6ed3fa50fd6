"""Graph containers, generators, the ``Graph`` handle (numpy on the host,
torch tensors on the device) and the sparse operations (``ops``)."""
from . import ops
from .csr import (
    BucketedELL,
    CSRGraph,
    CSRMatrix,
    ELLGraph,
    ELLMatrix,
    csr_from_coo,
    csr_to_bucketed_ell,
    csr_to_ell_graph,
    csr_to_ell_matrix,
    ell_to_csr_graph,
    ensure_self_loops,
    degrees,
    pad_ell_graph,
    symmetrize,
)
from .generators import (
    elasticity3d,
    er_laplacian,
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
    as_csr_graph,
    as_ell_graph,
    as_graph,
    ell_bytes_estimate,
)
from .hybrid import (
    HYBRID_AUTO_BYTES,
    HybridEllGraph,
    HybridSlice,
    csr_to_hybrid_ell,
)
from .ops import (
    coarse_graph_from_labels,
    extract_diagonal,
    galerkin_coarse_matrix,
    graph_power2,
    matrix_to_scipy,
    neighbor_all_eq,
    neighbor_any_eq,
    neighbor_min,
    spmv_csr_segment,
    spmv_ell,
)

__all__ = [
    "ops", "BucketedELL", "CSRGraph", "CSRMatrix", "ELLGraph", "ELLMatrix",
    "csr_from_coo", "csr_to_bucketed_ell", "csr_to_ell_graph",
    "csr_to_ell_matrix", "degrees", "ell_to_csr_graph", "ensure_self_loops",
    "pad_ell_graph", "symmetrize", "elasticity3d", "er_laplacian",
    "laplace3d", "paper_suite", "path_graph", "powerlaw_graph",
    "random_skewed_graph", "random_uniform_graph", "ELL_BYTE_LIMIT",
    "ELL_BYTES_PER_SLOT", "Graph", "LayoutOverflowError", "as_csr_graph",
    "as_ell_graph", "as_graph", "ell_bytes_estimate", "HYBRID_AUTO_BYTES",
    "HybridEllGraph", "HybridSlice", "csr_to_hybrid_ell",
    "coarse_graph_from_labels", "extract_diagonal", "galerkin_coarse_matrix",
    "graph_power2", "matrix_to_scipy", "neighbor_all_eq", "neighbor_any_eq",
    "neighbor_min", "spmv_csr_segment", "spmv_ell",
]
