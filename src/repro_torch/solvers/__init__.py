"""``repro_torch.solvers`` — the solve phase on the device: the SA-AMG
V-cycle, CG and restarted GMRES, and point / cluster multicolor
Gauss-Seidel."""
from .amg import v_cycle
from .krylov import SolveResult, cg, gmres
from .multicolor_gs import MulticolorGSPreconditioner, setup_point_gs

__all__ = ["v_cycle", "SolveResult", "cg", "gmres",
           "MulticolorGSPreconditioner", "setup_point_gs"]
