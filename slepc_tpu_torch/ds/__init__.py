from .types import DS, DSHEP, DSGHEP, DSNHEP, DSGNHEP
from . import compact, schur

__all__ = ["DS", "DSHEP", "DSGHEP", "DSNHEP", "DSGNHEP", "compact", "schur"]
