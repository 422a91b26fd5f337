from .iterative_jit import minres_fixed

__all__ = ["minres_fixed"]
