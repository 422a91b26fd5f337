from .ldl import LDLFactorization, ldl_available

__all__ = ["LDLFactorization", "ldl_available"]
