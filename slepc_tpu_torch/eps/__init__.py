from .base import EPS, EPSConvergedReason, EPSError, ProblemType

__all__ = ["EPS", "EPSConvergedReason", "EPSError", "ProblemType"]
