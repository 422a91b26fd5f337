"""EPS — linear eigenproblem solver front-end (``slepc_tpu/eps/base.py``).

The reference's public surface: ``A x = lambda x`` and ``A x = lambda B x``;
options ``nev ncv mpd tol max_it which problem_type target interval``,
``-eps_true_residual``, ``-eps_conv_*``, ``-eps_cheb_degree``,
``-eps_block_size``, ``-eps_lanczos_reorthog``, ``-eps_partitions``,
``-eps_gd_blocksize`` / ``-eps_jd_blocksize``, ``-eps_jd_fix``,
``-eps_harmonic``, ``-eps_balance``, monitors, the post-solve viewers
``-eps_view`` / ``-eps_converged_reason`` / ``-eps_error_relative``, and the
ST options ``-st_type -st_shift -st_ksp_type`` (with ``-st_type filter``:
``-st_filter_interval a,b -st_filter_degree d``);
the setters (``set_operators``, ``set_problem_type``, ``set_type``,
``set_which``, ``set_dimensions``, ``set_tolerances``, ``set_target``,
``set_interval``, ``set_st``, ``set_rg``, ``set_balance``,
``set_extraction``, ``set_arbitrary_selection``, ...), ``solve`` through the
solver registry (:meth:`EPS.register`, :class:`EPSSolver`), the getters,
``compute_error`` (with B), ``view``, ``error_view`` and
``save_state`` / ``load_state``.  Eigenvectors stay on the operator's device
as the rows of a (nconv, n) tensor -- complex for the complex pairs of a
real non-Hermitian operator -- and ``get_eigenvectors`` returns them in the
reference's (n, nconv) shape, as a transposed view.

Registered: ``krylovschur`` (hep, ghep, nhep, gnhep, pgnhep, ghiep, bse;
the two-sided variant with ``set_two_sided``), ``bse`` (``eps/bse.py``),
``arnoldi``, ``lanczos``, ``power``, ``subspace``, ``lapack``, the
preconditioned solvers ``gd``, ``jd`` (``eps/davidson.py``, with the fused
GD cycle of ``eps/gd_jit.py``), ``lobpcg`` and ``rqcg``, the
contour-integral ``ciss`` and the Lyapunov inverse iteration ``lyapii``
(``eps/lyapii.py``, over the port's LME): every solver the reference
registers.  A two-sided solve returns the left eigenvectors
(``get_left_eigenvector``): from the coupled Krylov-Schur
(``eps/ks_twosided.py``), else from a second run on the adjoint problem
(:meth:`EPS._solve_left`; a copy of the right ones for a Hermitian problem
with B = I).  A name the reference does not know raises :class:`EPSError`
listing the registered ones.  Complex operators
(and complex shifts of real ones) run in complex arithmetic
(:func:`work_dtype`), the blocked cycle included; ``cheb_block`` is ignored
for them, as the reference ignores it, and the device shift-and-invert
raises NotImplementedError: the reference has no complex one.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Optional, Type

import numpy as np
import torch

from ..mat.linop import LinearOperator, apply_by_parts
from ..ops.rotate import rotate
from ..st.filter import STFilter
from ..st.st import ST, STCayley, STPrecond, STShift, STSinvert
from ..sys.events import log_event
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


_DEFAULT_TOL = {torch.float64: 1e-8, torch.float32: 1e-5,
                torch.complex128: 1e-8, torch.complex64: 1e-5}
_REORTH = ("full", "partial", "periodic", "selective", "delayed", "local")


def _real_if_real(z: complex):
    """A complex option value as a float when its imaginary part is zero
    (real operators then keep real arithmetic)."""
    return z.real if z.imag == 0 else z


class EPS:
    """Linear eigensolver: A x = lambda x or A x = lambda B x."""

    _solvers: Dict[str, Type["EPSSolver"]] = {}

    @classmethod
    def register(cls, name: str, solver: Type["EPSSolver"]) -> None:
        cls._solvers[name] = solver

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
        # the task mesh the partitions run over as ranks (None: in this
        # process) and the rank that ran each partition (eps/ks_slice.py)
        self.slice_mesh = None
        self.slice_partition_ranks: list = []
        # variants of the general loop; two_sided also asks for the left
        # eigenvectors; bse_variant picks the BSE solver's method (auto |
        # projected)
        self.extraction = "ritz"
        self.balance = None
        self.balance_its = 5
        self.two_sided = False
        self.bse_variant = "auto"
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
        # power iteration: shift variant (constant | rayleigh | wilkinson)
        # and steps between host reads of the constant-shift loop
        self.power_shift_type = "constant"
        self.power_chunk = 16
        # Davidson (gd, jd): the fused GD cycle unless gd_fused is False,
        # corrections per step (-eps_gd_blocksize / -eps_jd_blocksize), the
        # corrections a restart keeps, JD's fix and inner GMRES steps
        self.gd_fused = True
        self.davidson_bs = 1
        self.davidson_plusk = 1
        self.jd_fix = 0.01
        self.jd_inner_maxit = 24
        # LOBPCG: iterations of the fused chunk between host reads (its
        # block size, ``lobpcg_blocksize``, defaults to max(nev, 4) at solve)
        self.lobpcg_chunk = 8
        # CISS: point solves ("auto" | "batched" | "factorized"), adaptive
        # per-point tolerances, extraction ("rr" | "hankel"), task mesh
        self.ciss_solver = "auto"
        self.ciss_adaptive = True
        self.ciss_extraction = "rr"
        self.ciss_task_mesh = None
        # solve state
        self.nconv = 0
        self.its = 0
        # search-space expansions (basis-growth steps: the fused GD cycle
        # runs ncv - j0 of them per ``its``, the host loop about one) and
        # operator applications of the Davidson host loop
        self.expansions = 0
        self.matvecs = 0
        self.reason = EPSConvergedReason.ITERATING
        self.eigenvalues: np.ndarray = np.array([])
        self.errests: np.ndarray = np.array([])
        self._eigenvectors: Optional[torch.Tensor] = None
        self._left_eigenvectors: Optional[torch.Tensor] = None
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
        if "gd_blocksize" in o or "jd_blocksize" in o:
            self.davidson_bs = int(o.get("gd_blocksize",
                                         o.get("jd_blocksize", 1)))
        if "jd_fix" in o:
            self.jd_fix = float(o["jd_fix"])
        # monitors (reference -eps_monitor / _all / _conv, epsmon.c)
        if o.get("monitor", False) is True:
            self.monitor.add(monitor_first)
        if o.get("monitor_all", False) is True:
            self.monitor.add(monitor_all)
        if o.get("monitor_conv", False) is True:
            self.monitor.add(ConvMonitor())
        # post-solve viewers (reference -eps_view / -eps_converged_reason /
        # -eps_error_relative, epssolve.c:97-113)
        self._view_on_solve = o.get("view", False) is True
        self._error_view_on_solve = (
            o.get("error_relative", False) is True
            or o.get("error_absolute", False) is True)
        self._reason_view_on_solve = o.get("converged_reason", False) is True

    def set_operators(self, A: LinearOperator,
                      B: Optional[LinearOperator] = None):
        self.A = A
        self.B = B
        self._setup_done = False
        return self

    def set_problem_type(self, pt: str | ProblemType):
        self.problem_type = ProblemType(pt) if isinstance(pt, str) else pt
        return self

    def set_type(self, name: str):
        self.solver_name = name
        return self

    def set_which(self, which: str | Which, target: Optional[complex] = None):
        self.which = Which(which) if isinstance(which, str) else which
        if target is not None:
            self.target = target
        return self

    def set_dimensions(self, nev: Optional[int] = None,
                       ncv: Optional[int] = None, mpd: Optional[int] = None):
        if nev is not None:
            self.nev = nev
        if ncv is not None:
            self.ncv = ncv
        if mpd is not None:
            self.mpd = mpd
        return self

    def set_tolerances(self, tol: Optional[float] = None,
                       max_it: Optional[int] = None):
        if tol is not None:
            self.tol = tol
        if max_it is not None:
            self.max_it = max_it
        return self

    def set_rg(self, rg):
        """Leave out eigenvalues outside the region ``rg`` (an ``RG``):
        Krylov-Schur counts only the Ritz values ``rg.check_inside`` keeps."""
        self.rg = rg
        return self

    def set_two_sided(self, flg: bool = True):
        """Two-sided (left and right) solve: the left eigenvectors come back
        too (:meth:`get_left_eigenvector`)."""
        self.two_sided = flg
        return self

    def set_balance(self, kind: str = "krylov", its: int = 5):
        self.balance = kind
        self.balance_its = its
        return self

    def set_arbitrary_selection(self, fn):
        self.arbitrary = fn
        return self

    def set_extraction(self, kind: str):
        if kind not in ("ritz", "harmonic"):
            raise ValueError(f"extraction {kind!r} is not ritz or harmonic")
        self.extraction = kind
        return self

    def set_power_nonlinear(self, A_of_x, B_of_x=None):
        """Nonlinear inverse power iteration A(x) x = lambda B(x) x (the
        'power' solver): ``A_of_x`` / ``B_of_x`` map the iterate (an (n,)
        tensor) to a LinearOperator."""
        self.power_nonlinear = (A_of_x, B_of_x)
        self.solver_name = "power"
        return self

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

    def set_partitions(self, npart: int, mesh=None):
        """Partitions of the interval for spectrum slicing, run one after
        another in this process.  ``mesh``: a task mesh over several
        ``torch.distributed`` ranks (``parallel/tasks.py``
        ``make_task_mesh``) on which they run concurrently, one a rank
        group's lead; the solve is then collective over it, every rank
        solving the same operators, interval and npart
        (``eps/ks_slice.py``)."""
        self.slice_mesh = mesh
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
                     "cayley": STCayley, "precond": STPrecond,
                     "filter": STFilter}
            cls = table.get(str(st_type))
            if cls is None:
                raise EPSError(f"unknown st_type {st_type!r}; "
                               f"available: {sorted(table)}")
            sigma = _real_if_real(complex(
                sigma_opt if sigma_opt is not None else (
                    self.target if self.target is not None else 0.0)))
            if cls is STFilter:
                self.st = self._filter_from_options(sto, mats)
                return
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

    def _filter_from_options(self, sto: Options, mats) -> STFilter:
        """``-st_type filter``: the interval from ``-st_filter_interval
        a,b`` (else the EPS interval) and ``-st_filter_degree`` (100); the
        spectral range is estimated."""
        iv = sto.get("filter_interval", self.interval)
        if iv is None:
            raise EPSError("-st_type filter needs an interval "
                           "(-st_filter_interval a,b or set_interval)")
        interval = tuple(float(t) for t in iv.split(",")) \
            if isinstance(iv, str) else tuple(iv)
        return STFilter(mats, interval=interval,
                        degree=int(sto.get("filter_degree", 100)))

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
        """Run the configured solver (reference: EPSSolve, epssolve.c:119),
        inside the span ``EPS_Solve`` (sys/events.py)."""
        with log_event("EPS_Solve"):
            cls = self._solvers.get(self.solver_name)
            if cls is None:
                raise EPSError(f"unknown EPS solver {self.solver_name!r}; "
                               f"available: {sorted(self._solvers)}")
            if not self._setup_done:
                self.setup()
            self.its = 0
            self.nconv = 0
            self.expansions = 0
            self.matvecs = 0
            self.reason = EPSConvergedReason.ITERATING
            self._left_eigenvectors = None
            cls().solve(self)
            if self.two_sided and self.nconv > 0 \
                    and self._left_eigenvectors is None:
                self._solve_left()
            if self.reason == EPSConvergedReason.ITERATING:
                self.reason = (EPSConvergedReason.CONVERGED_TOL
                               if self.nconv >= self.nev
                               else EPSConvergedReason.DIVERGED_ITS)
            # best-first ordering of converged pairs
            if self.nconv > 1 and self._eigenvectors is not None:
                perm = self.sort_criterion().argsort(
                    self.eigenvalues[: self.nconv])
                self.eigenvalues[: self.nconv] = self.eigenvalues[perm]
                self.errests[: self.nconv] = self.errests[perm]
                idx = torch.from_numpy(perm).to(self._eigenvectors.device)
                self._eigenvectors = self._eigenvectors[idx]
                if self._left_eigenvectors is not None:
                    self._left_eigenvectors = self._left_eigenvectors[idx]
            if self._reason_view_on_solve:
                verb = "CONVERGED" if self.reason.value > 0 else "DIVERGED"
                print(f"EPS solve {verb}: {self.nconv} eigenpairs, reason "
                      f"{self.reason.name}, iterations {self.its}")
            if self._view_on_solve:
                self.view()
            if self._error_view_on_solve:
                self.error_view()
            return self

    def _solve_left(self):
        """Two-sided without the coupled variant: the left eigenvectors
        from a run on the adjoint problem A^H y = conj(lambda) B^H y with
        the same solver and settings, each right pair matched to the
        unused left value nearest conj(lambda) (the reference's dual run);
        for a Hermitian problem with B = I, a copy of the right vectors."""
        from ..ds.types import match_conj
        from ..mat.linop import AdjointOperator

        if self.is_hermitian and self.B is None:
            self._left_eigenvectors = self._eigenvectors.clone()
            return
        left = EPS(AdjointOperator(self.A),
                   None if self.B is None else AdjointOperator(self.B),
                   problem_type=self.problem_type.value, which=self.which,
                   nev=self.nev, ncv=self.ncv, tol=self.tol,
                   max_it=self.max_it, solver=self.solver_name,
                   target=(np.conj(self.target) if self.target is not None
                           else None), options=Options())
        left.solve()
        if left.nconv == 0:
            return
        pick = match_conj(self.eigenvalues[: self.nconv],
                          left.eigenvalues[: left.nconv])
        self._left_eigenvectors = left._eigenvectors[
            torch.from_numpy(pick).to(left._eigenvectors.device)]

    # -- checkpoint / resume ------------------------------------------------
    def save_state(self, path: str):
        """Persist the solve's results to an .npz file in the reference's
        layout (eigenvectors and basis as (n, k) columns), so that either
        package can resume from it."""
        def cols(X):
            return X.detach().cpu().numpy().T if X is not None \
                else np.zeros((self.n, 0))

        basis = getattr(self, "V", None)
        np.savez(path, eigenvalues=self.eigenvalues,
                 eigenvectors=cols(self._eigenvectors[: self.nconv]
                                   if self._eigenvectors is not None
                                   else None),
                 errests=self.errests, nconv=self.nconv, its=self.its,
                 basis=cols(basis.array) if basis is not None
                 else np.zeros((0, 0)))
        return self

    def load_state(self, path: str):
        """Warm-start from a saved state: the converged vectors (and a few
        leftover basis columns) become the initial space, the first column
        their sum plus a tiny seeded perturbation (the reference's
        ``load_state``)."""
        d = np.load(path)
        X = d["eigenvectors"]
        basis = d["basis"]
        cols = []
        if X.size:
            v0 = X.sum(axis=1, keepdims=True)
            real = self.A is not None and self.A.dtype.is_floating_point
            pert = 100.0 * (torch.finfo(self.A.dtype).eps if real
                            else np.finfo(np.float64).eps)
            rng = np.random.default_rng(1)
            v0 = v0 + pert * np.linalg.norm(v0) * rng.standard_normal(
                v0.shape) / np.sqrt(v0.shape[0])
            cols += [v0, X]
        if basis.size:
            extra = basis[:, X.shape[1]: X.shape[1] + 4]
            if extra.size:
                cols.append(extra)
        if cols:
            init = np.concatenate(cols, axis=1)
            if self.A is not None and not self.A.dtype.is_complex \
                    and np.iscomplexobj(init):
                init = init.real
            self.set_initial_space(init)
        return self

    # -- results -----------------------------------------------------------
    def get_converged(self) -> int:
        return self.nconv

    def get_eigenvalue(self, i: int):
        if i >= self.nconv:
            raise EPSError(f"only {self.nconv} converged pairs")
        return self.eigenvalues[i]

    def get_eigenpair(self, i: int):
        """(lambda_i, x_i) with x_i a tensor on the operator's device."""
        lam = self.get_eigenvalue(i)
        return lam, self._eigenvectors[i]

    def get_left_eigenvector(self, i: int) -> torch.Tensor:
        """y_i, with y_i^H A = lambda_i y_i^H (two-sided solves), a tensor
        on the operator's device."""
        if self._left_eigenvectors is None:
            raise EPSError("no left eigenvectors (enable two_sided)")
        return self._left_eigenvectors[i]

    def get_eigenvectors(self) -> torch.Tensor:
        """The converged eigenvectors as the reference's (n, nconv) columns:
        a transposed view of the device rows."""
        if self._eigenvectors is None:
            raise EPSError("no eigenvectors: solve first")
        return self._eigenvectors[: self.nconv].T

    def get_error_estimate(self, i: int) -> float:
        return float(self.errests[i])

    def compute_error(self, i: int, error_type: str = "relative") -> float:
        """Explicit residual ||A x - lambda B x|| / ||x|| (/|lambda| if
        relative), computed with the operators' own SpMV (reference:
        EPSComputeError).  A complex x of a real operator (a conjugate
        pair's vector) is applied as its real and imaginary parts."""
        lam, x = self.get_eigenpair(i)
        lam = complex(lam)
        if not x.is_complex() and lam.imag == 0:
            lam = lam.real
        bx = op_mult(self.B, x) if self.B is not None else x
        r = op_mult(self.A, x) - lam * bx
        res = float(torch.linalg.vector_norm(r)) / max(
            float(torch.linalg.vector_norm(x)), 1e-300)
        if error_type == "relative":
            return res / max(abs(lam), 1e-300)
        return res

    def view(self):
        """Print the solver configuration (reference: EPSView, epsview.c)."""
        pt = self.problem_type.value if self.problem_type else "(unset)"
        lines = [
            "EPS Object:",
            f"  solver: {self.solver_name}",
            f"  problem type: {pt}",
            f"  which: {self.which.value}"
            + (f" (target={self.target})" if self.target is not None else "")
            + (f" (interval={self.interval})" if self.interval is not None
               else ""),
            f"  dimensions: nev={self.nev} ncv={self.ncv} mpd={self.mpd}",
            f"  tolerances: tol={self.tol} max_it={self.max_it}",
            f"  convergence test: {self.conv_test}",
        ]
        if self.st is not None:
            lines.append(f"  ST: type={self.st.name} sigma={self.st.sigma}")
            if getattr(self.st, "ksp", None) is not None:
                lines.append(f"    KSP: method={self.st.ksp.method}")
        if self.rg is not None:
            lines.append(f"  RG: {type(self.rg).__name__}")
        s = "\n".join(lines)
        print(s)
        return s

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


class EPSSolver:
    """Base class of the solvers :meth:`EPS.register` dispatches to."""

    def solve(self, eps: EPS) -> None:
        raise NotImplementedError


def work_dtype(eps: EPS, op: LinearOperator) -> torch.dtype:
    """The solver's arithmetic: the problem's dtype, promoted to complex when
    the transformed operator is (a complex shift of a real operator)."""
    return torch.promote_types(eps.A.dtype, op.dtype)


def start_vector(rng: np.random.Generator, n: int, dtype: torch.dtype):
    """The reference's start vector: standard normals, Re + i Im for a
    complex dtype (drawn in that order), so both packages start alike."""
    v = rng.standard_normal(n)
    if dtype.is_complex:
        v = v + 1j * rng.standard_normal(n)
    return v


def op_mult(op: LinearOperator, x: torch.Tensor) -> torch.Tensor:
    """op x; a complex x of a real operator goes through ``mult`` as its
    real and imaginary parts (the kernels take real vectors)."""
    return apply_by_parts(op.mult, x, op.dtype)


def op_mult_block(op: LinearOperator, X: torch.Tensor) -> torch.Tensor:
    """op applied to each row of the (b, n) block X through ``mult_block``
    (K5 for a DIA operator); complex rows of a real operator as their real
    and imaginary parts."""
    return apply_by_parts(LinearOperator.block_of(op), X, op.dtype)


def basis_combine(V: torch.Tensor, Y: np.ndarray) -> torch.Tensor:
    """The rows of V combined by the columns of the host matrix Y: row p of
    the result is sum_k Y[k, p] V[k] (X = V_cols Y in the reference's
    layout), one K4 rotation; a complex Y on a real V (the eigenvectors of
    a real Schur form) is two, for its real and imaginary parts; on a
    complex V it is one K4c rotation (a real Y there is a real K4 on the
    real view of V)."""
    def rot(M):
        M = torch.from_numpy(np.ascontiguousarray(M)).to(V.device)
        return rotate(M.to(V.dtype if M.is_complex() or not V.is_complex()
                           else V.real.dtype), V)

    if np.iscomplexobj(Y) and not V.is_complex():
        return torch.complex(rot(Y.real), rot(Y.imag))
    return rot(Y)


def normalize_rows(X: torch.Tensor) -> torch.Tensor:
    """Each row of X over its 2-norm (a zero row stays zero)."""
    nrm = torch.linalg.vector_norm(X, dim=1, keepdim=True)
    return X / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
