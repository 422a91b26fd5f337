from .base import EPS, EPSConvergedReason, EPSError, EPSSolver, ProblemType
from . import krylovschur  # registers "krylovschur"

__all__ = ["EPS", "EPSConvergedReason", "EPSError", "EPSSolver", "ProblemType"]
