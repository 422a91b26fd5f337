from .bv import BV, OrthogType, OrthogRefine, OrthogBlockType
from . import orthog, krylov

__all__ = ["BV", "OrthogType", "OrthogRefine", "OrthogBlockType", "orthog",
           "krylov"]
