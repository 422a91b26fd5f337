from .iterative_jit import cg_fixed, minres_fixed
from .ksp import KSP, solve_linear
from .direct import DirectSolver, tridiag_inertia, banded_ldlt_inertia

__all__ = ["cg_fixed", "minres_fixed", "KSP", "solve_linear", "DirectSolver",
           "tridiag_inertia", "banded_ldlt_inertia"]
