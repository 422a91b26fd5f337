from .types import (DS, DSHEP, DSGHEP, DSGHIEP, DSNHEP, DSNHEPTS, DSGNHEP,
                    DSSVD, DSHSVD, DSGSVD, DSPEP)
from . import bdc, compact, schur

__all__ = ["DS", "DSHEP", "DSGHEP", "DSGHIEP", "DSNHEP", "DSNHEPTS",
           "DSGNHEP", "DSSVD", "DSHSVD", "DSGSVD", "DSPEP", "bdc", "compact",
           "schur"]
