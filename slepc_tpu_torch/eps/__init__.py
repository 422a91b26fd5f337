from .base import EPS, EPSConvergedReason, EPSError, EPSSolver, ProblemType
from . import krylovschur  # registers "krylovschur"
from . import power  # "power"
from . import subspace  # "subspace"
from . import explicit  # "arnoldi", "lanczos"
from . import lapack  # "lapack"

__all__ = ["EPS", "EPSConvergedReason", "EPSError", "EPSSolver", "ProblemType"]
