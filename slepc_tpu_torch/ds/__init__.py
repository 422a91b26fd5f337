from .types import (DS, DSHEP, DSGHEP, DSGHIEP, DSNHEP, DSNHEPTS, DSGNHEP,
                    DSSVD, DSHSVD, DSGSVD)
from . import bdc, compact, schur

__all__ = ["DS", "DSHEP", "DSGHEP", "DSGHIEP", "DSNHEP", "DSNHEPTS",
           "DSGNHEP", "DSSVD", "DSHSVD", "DSGSVD", "bdc", "compact", "schur"]
