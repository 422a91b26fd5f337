from .mfn import MFN, MFNConvergedReason

__all__ = ["MFN", "MFNConvergedReason"]
