from .pep import PEP

__all__ = ["PEP"]
