"""EPS — linear eigenproblem solver front-end (``slepc_tpu/eps/base.py``).

The surface the Hermitian Krylov-Schur solver needs: ``A x = lambda x`` and
``A x = lambda B x`` (``hep`` / ``ghep``); options ``nev ncv mpd tol max_it
which problem_type target interval``, ``-eps_true_residual``,
``-eps_conv_*``, ``-eps_cheb_degree``, ``-eps_block_size``,
``-eps_lanczos_reorthog``, ``-eps_partitions``, monitors, and the ST
options ``-st_type -st_shift -st_ksp_type``; ``set_target``,
``set_interval``, ``set_st``, ``set_deflation_space``,
``set_initial_space``; ``solve``, ``nconv``, ``get_eigenpair``,
``compute_error`` (with B) and ``error_view``.  Eigenvectors stay on the
operator's device as the rows of a (nconv, n) tensor.  Other solvers and
the non-Hermitian, indefinite, harmonic, balanced, two-sided and
arbitrary-selection variants raise NotImplementedError naming their ROADMAP
item.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import numpy as np
import torch

from ..mat.linop import LinearOperator
from ..st.st import ST, STCayley, STPrecond, STShift, STSinvert
from ..sys.monitor import ConvMonitor, Monitor, monitor_all, monitor_first
from ..sys.options import Options, get_global_options
from ..sys.sort import SortCriterion, Which


class ProblemType(enum.Enum):
    HEP = "hep"  # Hermitian
    GHEP = "ghep"  # generalized Hermitian, B > 0
    NHEP = "nhep"  # non-Hermitian
    GNHEP = "gnhep"  # generalized non-Hermitian
    PGNHEP = "pgnhep"  # gen. non-Hermitian with positive-definite B
    GHIEP = "ghiep"  # gen. Hermitian-indefinite
    BSE = "bse"  # structured Bethe-Salpeter


class EPSConvergedReason(enum.IntEnum):
    CONVERGED_TOL = 1
    CONVERGED_USER = 2
    DIVERGED_ITS = -1
    DIVERGED_BREAKDOWN = -2
    DIVERGED_SYMMETRY_LOST = -3
    ITERATING = 0


class EPSError(RuntimeError):
    pass


_DEFAULT_TOL = {torch.float64: 1e-8, torch.float32: 1e-5}
_TODO_SOLVERS = ("only EPS 'krylovschur' on Hermitian (hep, ghep) problems "
                 "is ported; {} is still to be ported (ROADMAP.md, queue 1, "
                 "item 11)")
_REORTH = ("full", "partial", "periodic", "selective", "delayed", "local")


def _real_if_real(z: complex):
    """A complex option value as a float when its imaginary part is zero
    (real operators then keep real arithmetic)."""
    return z.real if z.imag == 0 else z


class EPS:
    """Linear eigensolver: A x = lambda x or A x = lambda B x."""

    def __init__(self, A: Optional[LinearOperator] = None,
                 B: Optional[LinearOperator] = None, *,
                 problem_type: Optional[str | ProblemType] = None,
                 which: str | Which = Which.LARGEST_MAGNITUDE,
                 nev: int = 1, ncv: Optional[int] = None, mpd: Optional[int] = None,
                 tol: Optional[float] = None, max_it: Optional[int] = None,
                 solver: str = "krylovschur", target: Optional[complex] = None,
                 interval: Optional[tuple] = None,
                 options: Optional[Options] = None, prefix: str = "eps_"):
        self.A = A
        self.B = B
        self.problem_type = ProblemType(problem_type) if problem_type else None
        self.which = Which(which) if not isinstance(which, Which) else which
        self.nev = nev
        self.ncv = ncv
        self.mpd = mpd
        self.tol = tol
        self.max_it = max_it
        self.solver_name = solver
        self.target = target
        self.interval = interval
        self.st: Optional[ST] = None
        self.monitor = Monitor()
        self.stopping: Optional[Callable] = None
        self.conv_test = "rel"  # rel | abs | norm
        self.initial_space: Optional[np.ndarray] = None   # (n, c) columns
        self.deflation_space: Optional[np.ndarray] = None  # (n, c) columns
        self.true_residual = False
        self.slice_npart = 1
        self.slice_factorizations = 0
        self.slice_backends = ()  # DirectSolver backends the slicing used
        # variants of the general loop that are not ported; setting one
        # makes the solver raise (ROADMAP.md, queue 1, item 11)
        self.extraction = "ritz"
        self.balance = None
        self.two_sided = False
        self.arbitrary: Optional[Callable] = None
        self.rg = None
        # Krylov-Schur fast-path settings (the attributes ks_hep_solve
        # reads; slepc_tpu/eps/ks_jit.py:1139-1148, 1220-1235)
        self.reorth = "full"
        self.reorth_period = 1
        self.rot_mode = "exact"
        self.block_size = 1
        self.cheb_degree = 0
        self.cheb_keep_den = 2
        self.cheb_rot_mode = "exact"
        self.cheb_reorth = "full"
        self.cheb_block = 1
        self.cheb_budget_s = None
        self.cheb_stats = None
        # solve state
        self.nconv = 0
        self.its = 0
        self.reason = EPSConvergedReason.ITERATING
        self.eigenvalues: np.ndarray = np.array([])
        self.errests: np.ndarray = np.array([])
        self._eigenvectors: Optional[torch.Tensor] = None
        opts = options if options is not None else get_global_options()
        self.options = opts.child(prefix) if opts.prefix == "" else opts
        self._apply_options()
        self._setup_done = False

    # -- configuration ----------------------------------------------------
    def _apply_options(self):
        o = self.options
        self.nev = int(o.get("nev", self.nev))
        if "ncv" in o:
            self.ncv = int(o["ncv"])
        if "mpd" in o:
            self.mpd = int(o["mpd"])
        if "tol" in o:
            self.tol = float(o["tol"])
        if "max_it" in o:
            self.max_it = int(o["max_it"])
        if "type" in o:
            self.solver_name = str(o["type"])
        if "target" in o:
            self.target = _real_if_real(complex(o["target"]))
            self.which = Which.TARGET_MAGNITUDE
        for w in Which:
            if f"{w.value}" == o.get("which"):
                self.which = w
            if o.get(w.value, False) is True:  # -eps_largest_real style
                self.which = w
        for pt in ProblemType:
            if o.get(pt.value, False) is True:
                self.problem_type = pt
        if "interval" in o:  # -eps_interval a,b
            iv = o["interval"]
            a, b = (float(t) for t in iv.split(",")) if isinstance(iv, str) \
                else iv
            self.set_interval(a, b)
        for ct in ("rel", "abs", "norm"):
            if o.get(f"conv_{ct}", False) is True:
                self.conv_test = ct
        if "conv_test" in o:
            self.conv_test = str(o["conv_test"])
        if o.get("true_residual", False) is True:
            self.true_residual = True
        if o.get("harmonic", False) is True or o.get("extraction") == "harmonic":
            self.extraction = "harmonic"
        if "balance" in o:
            self.balance = o["balance"] if isinstance(o["balance"], str) \
                else "krylov"
        if o.get("two_sided", False) is True:
            self.two_sided = True
        if "partitions" in o:
            self.slice_npart = int(o["partitions"])
        if "lanczos_reorthog" in o:
            self.set_reorthogonalization(str(o["lanczos_reorthog"]))
        if "block_size" in o:
            self.block_size = int(o["block_size"])
        if "cheb_degree" in o:  # Chebyshev-amplified smallest-end path
            self.cheb_degree = int(o["cheb_degree"])
        # monitors (reference -eps_monitor / _all / _conv, epsmon.c)
        if o.get("monitor", False) is True:
            self.monitor.add(monitor_first)
        if o.get("monitor_all", False) is True:
            self.monitor.add(monitor_all)
        if o.get("monitor_conv", False) is True:
            self.monitor.add(ConvMonitor())

    def set_target(self, target: complex):
        self.target = target
        if self.which not in (Which.TARGET_MAGNITUDE, Which.TARGET_REAL,
                              Which.TARGET_IMAGINARY):
            self.which = Which.TARGET_MAGNITUDE
        return self

    def set_interval(self, a: float, b: float):
        self.interval = (a, b)
        self.which = Which.ALL
        return self

    def set_st(self, st: ST):
        self.st = st
        return self

    def set_monitor(self, fn):
        self.monitor.add(fn)
        return self

    @staticmethod
    def _columns(X) -> np.ndarray:
        X = np.asarray(X.detach().cpu() if torch.is_tensor(X) else X)
        return X[:, None] if X.ndim == 1 else X

    def set_initial_space(self, X):
        """Start vectors, the columns of an (n, c) array (or one (n,)
        vector); the Krylov run starts from the first."""
        self.initial_space = self._columns(X)
        return self

    def set_deflation_space(self, X):
        """Vectors to deflate, the columns of an (n, c) array: the basis is
        kept orthogonal to them (BVInsertConstraints)."""
        self.deflation_space = self._columns(X)
        return self

    def set_partitions(self, npart: int):
        """Partitions of the interval for spectrum slicing; they run one
        after another."""
        self.slice_npart = int(npart)
        return self

    def set_true_residual(self, flg: bool = True):
        """Confirm convergence with explicit residuals on the ORIGINAL
        problem instead of the transformed-space Krylov estimate."""
        self.true_residual = flg
        return self

    def set_convergence_test(self, name: str):
        if name not in ("rel", "abs", "norm"):
            raise ValueError(f"convergence test {name!r} is not rel, abs "
                             f"or norm")
        self.conv_test = name
        return self

    def set_reorthogonalization(self, kind: str, period: int = 4):
        """Orthogonalization policy of the Krylov-Schur fast path
        (reference -eps_lanczos_reorthog, ``slepc_tpu/eps/base.py:316``):
        'full' (CGS2 every column, default), 'partial' (Simon's omega
        monitor: local CGS2 against the two previous rows, a full sweep
        only when the drift estimate crosses sqrt(eps)/sqrt(ncv)),
        'periodic' and 'selective' (explicit-Lanczos policies; the
        Krylov-Schur path runs them as the monitored 'partial'), 'local'
        (full here, as in the reference, unless a period was set) and
        'delayed' (runs as 'full').  ``period`` is kept for 'periodic'."""
        if kind not in _REORTH:
            raise ValueError(f"reorthogonalization {kind!r} is not one of "
                             f"{_REORTH}")
        self.reorth = kind
        if kind == "periodic":
            self.reorth_period = period
        return self

    # -- derived defaults --------------------------------------------------
    @property
    def n(self) -> int:
        return self.A.shape[0]

    def _default_dims(self):
        """ncv = min(n, max(2 nev, nev+15)), mpd cap for large nev
        (reference: EPSSetDimensions_Default, epssetup.c:654-678)."""
        n, nev = self.n, self.nev
        if self.ncv is None:
            if self.mpd is not None:
                self.ncv = min(n, nev + self.mpd)
            elif nev < 500:
                self.ncv = min(n, max(2 * nev, nev + 15))
            else:
                self.mpd = 500
                self.ncv = min(n, nev + self.mpd)
        if self.mpd is None:
            self.mpd = self.ncv
        self.ncv = max(self.ncv, self.nev + 1) if self.ncv < n else self.ncv
        self.ncv = min(self.ncv, n)
        self.mpd = min(self.mpd, self.ncv)

    def _default_tol(self):
        if self.tol is None:
            self.tol = _DEFAULT_TOL.get(self.A.dtype, 1e-8)
        if self.max_it is None:
            self.max_it = max(100, 2 * self.n // max(self.ncv, 1))

    @property
    def is_hermitian(self) -> bool:
        return self.problem_type in (ProblemType.HEP, ProblemType.GHEP,
                                     ProblemType.BSE)

    @property
    def is_generalized(self) -> bool:
        return self.B is not None

    def _default_st(self):
        """The ST from the ``-st_type -st_shift -st_ksp_type`` options
        (global "st_" prefix), else shift-and-invert at the target or the
        interval's left end, else the identity shift."""
        if self.st is not None:
            return
        hermitian = self.problem_type in (ProblemType.HEP, ProblemType.GHEP)
        mats = [self.A] if self.B is None else [self.A, self.B]
        sto = Options(self.options._values, "st_")
        st_type = sto.get("type")
        ksp_opts = {"ksp_type": sto["ksp_type"]} if "ksp_type" in sto else {}
        sigma_opt = sto.get("shift")
        if st_type is not None:
            table = {"shift": STShift, "sinvert": STSinvert,
                     "cayley": STCayley, "precond": STPrecond}
            cls = table.get(str(st_type))
            if str(st_type) == "filter":
                raise NotImplementedError(
                    "STFilter (-st_type filter) is still to be ported "
                    "(ROADMAP.md, queue 1, item 10)")
            if cls is None:
                raise EPSError(f"unknown st_type {st_type!r}; "
                               f"available: {sorted(table)}")
            sigma = _real_if_real(complex(
                sigma_opt if sigma_opt is not None else (
                    self.target if self.target is not None else 0.0)))
            kw = {"ksp_opts": ksp_opts} if ksp_opts else {}
            if cls is STSinvert:
                kw["hermitian"] = hermitian
            self.st = cls(mats, sigma=sigma, **kw)
            if cls in (STSinvert, STCayley) and self.target is None:
                # sinvert without an explicit target: the wanted pairs are
                # those nearest the shift
                self.target = sigma
                self.which = Which.TARGET_MAGNITUDE
        elif self.target is not None or self.interval is not None:
            sigma = self.target if self.target is not None \
                else self.interval[0]
            self.st = STSinvert(mats, sigma=sigma, hermitian=hermitian,
                                ksp_opts=ksp_opts or None)
        else:
            self.st = STShift(mats, sigma=0.0)

    def sort_criterion(self) -> SortCriterion:
        """Sorting happens on the back-transformed values, against the
        target."""
        return SortCriterion(which=self.which,
                             target=self.target if self.target is not None
                             else 0.0)

    # -- solve -------------------------------------------------------------
    def setup(self):
        if self.A is None:
            raise EPSError("operators not set")
        if self.problem_type is None:
            # conservative default, as the reference requires the user to
            # declare Hermitian structure (EPSSetProblemType)
            self.problem_type = (ProblemType.GNHEP if self.is_generalized
                                 else ProblemType.NHEP)
        self._default_dims()
        self._default_tol()
        self._default_st()
        if (self.deflation_space is not None
                and self.st.name in ("sinvert", "cayley")):
            # singular-pencil support: deflation vectors in the nullspace
            # of A - sigma*B are attached to the factorization's KSP
            self.st.check_null_space(self.deflation_space)
        self._setup_done = True
        return self

    def solve(self):
        """Run the configured solver (reference: EPSSolve, epssolve.c:119)."""
        from .krylovschur import KrylovSchur

        if self.solver_name != "krylovschur":
            raise NotImplementedError(_TODO_SOLVERS.format(
                f"solver {self.solver_name!r}"))
        if not self._setup_done:
            self.setup()
        self.its = 0
        self.nconv = 0
        self.reason = EPSConvergedReason.ITERATING
        KrylovSchur().solve(self)
        if self.reason == EPSConvergedReason.ITERATING:
            self.reason = (EPSConvergedReason.CONVERGED_TOL
                           if self.nconv >= self.nev else EPSConvergedReason.DIVERGED_ITS)
        # best-first ordering of converged pairs
        if self.nconv > 1 and self._eigenvectors is not None:
            perm = self.sort_criterion().argsort(self.eigenvalues[: self.nconv])
            self.eigenvalues[: self.nconv] = self.eigenvalues[perm]
            self.errests[: self.nconv] = self.errests[perm]
            self._eigenvectors = self._eigenvectors[
                torch.from_numpy(perm).to(self._eigenvectors.device)]
        return self

    # -- results -----------------------------------------------------------
    def get_eigenvalue(self, i: int):
        if i >= self.nconv:
            raise EPSError(f"only {self.nconv} converged pairs")
        return self.eigenvalues[i]

    def get_eigenpair(self, i: int):
        """(lambda_i, x_i) with x_i a tensor on the operator's device."""
        lam = self.get_eigenvalue(i)
        return lam, self._eigenvectors[i]

    def compute_error(self, i: int, error_type: str = "relative") -> float:
        """Explicit residual ||A x - lambda B x|| / ||x|| (/|lambda| if
        relative), computed with the operators' own SpMV (reference:
        EPSComputeError)."""
        lam, x = self.get_eigenpair(i)
        bx = self.B.mult(x) if self.B is not None else x
        r = self.A.mult(x) - float(lam) * bx
        res = float(torch.linalg.vector_norm(r)) / max(
            float(torch.linalg.vector_norm(x)), 1e-300)
        if error_type == "relative":
            return res / max(abs(lam), 1e-300)
        return res

    def error_view(self):
        lines = [f"nconv={self.nconv} reason={self.reason.name} its={self.its}"]
        for i in range(self.nconv):
            lam = self.eigenvalues[i]
            lines.append(f"  lambda[{i}] = {lam:.9g}  rel.err = {self.compute_error(i):.3e}")
        s = "\n".join(lines)
        print(s)
        return s

    # -- shared convergence machinery ---------------------------------------
    def conv_measure(self, theta: complex, res: float) -> float:
        """Error measure per convergence-test setting (reference:
        EPSConvergedRelative / Absolute / Norm)."""
        if self.conv_test == "abs":
            return res
        if self.conv_test == "norm":
            nrm = getattr(self, "_op_norm", None)
            if nrm is None:
                nrm = abs(theta)
            return res / max(abs(theta) + nrm, 1e-300)
        return res / max(abs(theta), 1e-300)
