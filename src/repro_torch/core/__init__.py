"""Out-of-core block eigensolver core (port of `repro.core`, the
Krylov–Schur path over the RAM or the SAFS tier)."""
from repro_torch.core.tiered import (TieredStore, IOStats, DEVICE, HOST,
                                     ReadOnlyError)
from repro_torch.core.multivector import MultiVector
from repro_torch.core.stream import SubspacePass
from repro_torch.core.ortho import cholqr, bcgs2, ortho_error
from repro_torch.core.operator import (GraphOperator, DenseOperator,
                                       LinearOperator, capabilities,
                                       CAP_FUSED_EXPAND,
                                       CAP_SPECTRAL_TRANSFORM)
from repro_torch.core.krylov_schur import eigsh
from repro_torch.core.solver import (Solver, SolverContext, register_solver,
                                     solve, solver_names)
from repro_torch.core.residuals import EigResult, true_residuals

__all__ = [
    "TieredStore", "IOStats", "DEVICE", "HOST", "ReadOnlyError",
    "MultiVector", "SubspacePass", "cholqr", "bcgs2", "ortho_error",
    "GraphOperator", "DenseOperator", "LinearOperator", "capabilities",
    "CAP_FUSED_EXPAND", "CAP_SPECTRAL_TRANSFORM",
    "eigsh", "Solver", "SolverContext", "register_solver", "solve",
    "solver_names", "EigResult", "true_residuals",
]
