from .lme import LME, LMEProblemType

__all__ = ["LME", "LMEProblemType"]
