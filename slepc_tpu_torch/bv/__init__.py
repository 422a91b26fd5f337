from .bv import BV, OrthogRefine, OrthogBlockType
from . import orthog, krylov

__all__ = ["BV", "OrthogRefine", "OrthogBlockType", "orthog", "krylov"]
