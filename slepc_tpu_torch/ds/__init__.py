from .types import DS, DSHEP, DSGHEP, DSGHIEP, DSNHEP, DSNHEPTS, DSGNHEP
from . import bdc, compact, schur

__all__ = ["DS", "DSHEP", "DSGHEP", "DSGHIEP", "DSNHEP", "DSNHEPTS",
           "DSGNHEP", "bdc", "compact", "schur"]
