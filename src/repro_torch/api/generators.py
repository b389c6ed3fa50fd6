"""Problem generators re-exported on the facade
(``repro_torch.api.generators``), so that examples and benchmarks import
against the ``repro_torch.api`` surface alone.  Implementation lives in
``repro_torch.graphs.generators``."""
from ..graphs.generators import (
    elasticity3d,
    er_laplacian,
    laplace3d,
    paper_suite,
    path_graph,
    powerlaw_graph,
    random_skewed_graph,
    random_uniform_graph,
)

__all__ = [
    "elasticity3d", "er_laplacian", "laplace3d", "paper_suite", "path_graph",
    "powerlaw_graph", "random_skewed_graph", "random_uniform_graph",
]
