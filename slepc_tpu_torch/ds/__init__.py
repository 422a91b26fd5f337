from .types import DS, DSHEP, DSGHEP
from . import compact

__all__ = ["DS", "DSHEP", "DSGHEP", "compact"]
