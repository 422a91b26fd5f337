from .base import EPS, EPSConvergedReason, EPSError, EPSSolver, ProblemType
from . import krylovschur  # registers "krylovschur"
from . import power  # "power"
from . import subspace  # "subspace"
from . import explicit  # "arnoldi", "lanczos"
from . import lapack  # "lapack"
from . import davidson  # "gd", "jd" (and the GD cycle, gd_jit)
from . import lobpcg  # "lobpcg"
from . import rqcg  # "rqcg"
from . import ciss  # "ciss"
from . import bse  # "bse" (also dispatched from krylovschur)
from . import lyapii  # "lyapii"

__all__ = ["EPS", "EPSConvergedReason", "EPSError", "EPSSolver", "ProblemType"]
