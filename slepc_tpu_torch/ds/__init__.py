from .types import (DS, DSHEP, DSGHEP, DSGHIEP, DSNHEP, DSNHEPTS, DSGNHEP,
                    DSSVD, DSHSVD, DSGSVD, DSPEP, DSNEP)
from . import bdc, compact, schur

__all__ = ["DS", "DSHEP", "DSGHEP", "DSGHIEP", "DSNHEP", "DSNHEPTS",
           "DSGNHEP", "DSSVD", "DSHSVD", "DSGSVD", "DSPEP", "DSNEP", "bdc",
           "compact", "schur"]
