"""``repro_torch.multilevel`` — the multilevel setup of SA-AMG and cluster
Gauss-Seidel (the reference's ``host`` engine): prolongator, Galerkin
product and packing on the host with numpy/scipy, level matrices on the
device."""
from .hierarchy import (
    AMGHierarchy,
    AMGLevel,
    ell_matrix_digest,
    hierarchy_from_arrays,
)

__all__ = ["AMGHierarchy", "AMGLevel", "ell_matrix_digest",
           "hierarchy_from_arrays"]
