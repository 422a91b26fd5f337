from .nep import NEP

__all__ = ["NEP"]
