"""The graph handle on the facade (``repro_torch.api.Graph``): one object,
every structural format computed once.  Implementation lives in
``repro_torch.graphs.handle``."""
from ..graphs.handle import Graph, as_csr_graph, as_ell_graph, as_graph

__all__ = ["Graph", "as_graph", "as_ell_graph", "as_csr_graph"]
