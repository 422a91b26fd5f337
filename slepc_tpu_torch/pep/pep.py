"""PEP -- polynomial eigenvalue problems P(lambda) x = 0
(``slepc_tpu/pep/pep.py``).

Reference: src/pep/ -- P(lambda) = sum_i phi_i(lambda) A_i over
monomial/Chebyshev/... bases with scaling, extraction and refinement.
Solvers: toar (default; two-level orthogonal Arnoldi on the companion
linearization with the basis held compactly in a tensor BV, ptoar.c),
stoar, qarnoldi, linear (explicit linearization -> inner EPS, linear.c),
jd, ciss.

Here: 'linear' builds the companion pencil as composable shell operators
(no assembly) and delegates to the EPS engine; 'toar' is the compact
solver of ``pep/toar.py``, 'qarnoldi' the memory-saving quadratic
recurrence of ``pep/qarnoldi.py``, 'stoar' the symmetric linearization
through EPS GHIEP (``pep/stoar.py``), and an interval
(``set_interval``) runs the inertia-certified slicing of
``pep/qslice.py``.  Scaling (sfactor) follows pepimpl.h:17-19 (scalar
scaling).

The coefficient matrices live on one device and every apply is theirs
(``p_apply``, ``compute_error``); eigenvectors are the rows of an
(nconv, n) tensor there (``get_eigenvectors`` returns the reference's
(n, nconv) columns, a transposed view), eigenvalues and error estimates
host numpy.  The Jacobi-Davidson loop and the refinements work on host
numpy bases sized for the small problems they serve (as the reference),
with the applies on the device.

P(sigma) is factorized when every coefficient has an explicit matrix
(``LinearOperator.explicit``: DIA, CSR, dense, diagonal, identity, and
scaled or summed ones): a failed factorization raises.  A shell coefficient
takes BiCGStab on the summed operator.  (The reference tries the
factorization and falls back to BiCGStab on any exception.)  The
contour-integral 'ciss' runs the nonlinear contour solver of
``nep/nep.py`` on T(z) = P(z), the coefficients as the split matrices of
monomial ``FNRational`` functions, as the reference does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..eps.base import EPS, ProblemType, op_mult, op_mult_block
from ..ksp import KSP
from ..mat.linop import (AIJOperator, DenseOperator, LinearOperator,
                         ShellOperator, SumOperator, aslinearoperator)
from ..st.st import ST
from ..sys.options import apply_module_options
from ..sys.sort import SortCriterion, Which


def operator_of(M, device) -> LinearOperator:
    """A host matrix of ``LinearOperator.explicit`` as a CSR or dense
    operator on ``device``."""
    import scipy.sparse as sp

    if sp.issparse(M):
        return AIJOperator.from_scipy(sp.csr_matrix(M), device=device)
    return DenseOperator(np.asarray(M), device=device)


def psigma_ksp(mats: Sequence[LinearOperator], sigma) -> KSP:
    """A KSP on P(sigma) = sum sigma^i A_i (the reference's ST
    factorization of the transformed polynomial): the direct factorization
    of the explicit matrix (a failed one raises) when every coefficient
    has one, else BiCGStab on the summed operator."""
    P = SumOperator(tuple(mats), tuple(sigma ** i for i in range(len(mats))))
    M = P.explicit()
    if M is not None:
        return KSP(operator_of(M, mats[0].device), method="direct")
    return KSP(P, method="bicgstab")


def _vec(x, device, dtype=None) -> torch.Tensor:
    """A host vector (or tensor) on ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = x.to(device)
    return x if dtype is None else x.to(dtype)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class PEP:
    """Polynomial eigensolver: (sum_i lambda^i A_i) x = 0."""

    def __init__(self, mats: Optional[Sequence[LinearOperator]] = None, *,
                 nev: int = 1, ncv: Optional[int] = None,
                 which: str | Which = Which.LARGEST_MAGNITUDE,
                 target: Optional[complex] = None,
                 tol: Optional[float] = None, max_it: Optional[int] = None,
                 solver: str = "toar", basis: str = "monomial",
                 scale: str = "none"):
        self.mats: List[LinearOperator] = list(mats) if mats else []
        self.nev = nev
        self.ncv = ncv
        self.which = Which(which) if isinstance(which, str) else which
        self.target = target
        self.tol = tol
        self.max_it = max_it
        self.solver = solver
        self.basis = basis
        self.scale = scale
        self.sfactor = 1.0
        self.nconv = 0
        self.its = 0
        self.eigenvalues = np.array([])
        self.errests = np.array([])
        self._eigenvectors: Optional[torch.Tensor] = None
        apply_module_options(self, "pep_", int_keys=("nev", "ncv", "max_it"),
                             float_keys=("tol",),
                             str_keys=("type", "basis", "scale"))

    def set_operators(self, mats: Sequence[LinearOperator]):
        self.mats = list(mats)
        return self

    def set_type(self, name: str):
        self.solver = name
        return self

    def set_target(self, t: complex):
        self.target = t
        self.which = Which.TARGET_MAGNITUDE
        return self

    def set_dimensions(self, nev=None, ncv=None):
        if nev is not None:
            self.nev = nev
        if ncv is not None:
            self.ncv = ncv
        return self

    def set_tolerances(self, tol=None, max_it=None):
        if tol is not None:
            self.tol = tol
        if max_it is not None:
            self.max_it = max_it
        return self

    def set_interval(self, a: float, b: float):
        """All eigenvalues of a hyperbolic symmetric QEP in [a, b]
        (reference: PEPSetInterval + the STOAR QSlice variant)."""
        self.interval = (float(a), float(b))
        return self

    @property
    def degree(self) -> int:
        return len(self.mats) - 1

    @property
    def n(self) -> int:
        return self.mats[0].shape[0]

    @property
    def device(self) -> torch.device:
        return self.mats[0].device

    def compute_scale(self) -> float:
        """Scalar scaling: sfactor = (||A_0|| / ||A_d||)^(1/d)
        (reference: PEPComputeScaleFactor)."""
        if self.scale != "scalar":
            return 1.0

        def nrm(op):
            return float(np.linalg.norm(_np(op.to_dense()), np.inf)) \
                if op.shape[0] <= 4096 else 1.0

        n0, nd = nrm(self.mats[0]), nrm(self.mats[-1])
        d = self.degree
        if n0 > 0 and nd > 0:
            return (n0 / nd) ** (1.0 / d)
        return 1.0

    def _host_sparse(self, A):
        import scipy.sparse as sp

        M = A.explicit()
        if M is None:
            M = _np(A.to_dense())
        return sp.csr_matrix(M)

    def compute_diagonal_scaling(self, sits: int = 5, slambda: float = 1.0):
        """Two-sided diagonal balancing Dl P(lambda) Dr (reference:
        PEP_SCALE_DIAGONAL, PEPBuildDiagonalScaling pepdefault.c:191):
        build M = sum_k w^k |A_k|.^2 (w = slambda^2 * sfactor) and balance
        its row/column sums with POWERS OF TWO (Lemonnier-Van Dooren) so
        the scaling is roundoff-free.  Returns (Dl, Dr) 1-D arrays."""
        import scipy.sparse as sp

        n = self.n
        w = 1.0
        M = None
        for k, A in enumerate(self.mats):
            Sq = self._host_sparse(A).copy()
            Sq.data = np.abs(Sq.data) ** 2
            M = Sq if M is None else M + w * Sq
            w *= slambda * slambda * max(self.sfactor, 1e-300)
        Dl = np.ones(n)
        Dr = np.ones(n)
        for _ in range(sits):
            rsum = np.asarray(M.sum(axis=1)).ravel()
            csum = np.asarray(M.sum(axis=0)).ravel()
            er = np.where(rsum > 0, np.round(-np.log2(np.sqrt(rsum))), 0.0)
            ec = np.where(csum > 0, np.round(-np.log2(np.sqrt(csum))), 0.0)
            if np.all(er == 0) and np.all(ec == 0):
                break
            sl = 2.0 ** er
            sr = 2.0 ** ec
            Dl *= sl
            Dr *= sr
            M = sp.diags(sl ** 2) @ M @ sp.diags(sr ** 2)
        return Dl, Dr

    def _apply_diagonal_scaling(self):
        """Swap in the balanced coefficient matrices (CSR on the same
        device); remember Dr for eigenvector unscaling."""
        import scipy.sparse as sp

        self.sfactor = max(self.compute_scale(), 1e-300) \
            if self.scale == "both" else 1.0
        Dl, Dr = self.compute_diagonal_scaling()
        self.Dl, self.Dr = Dl, Dr
        self._unscaled_mats = self.mats
        self.mats = [aslinearoperator(
            sp.csr_matrix(sp.diags(Dl) @ self._host_sparse(A) @ sp.diags(Dr)),
            device=A.device) for A in self.mats]

    def _undo_diagonal_scaling(self):
        self.mats = self._unscaled_mats
        if self._eigenvectors is not None and self._eigenvectors.numel():
            X = self._eigenvectors
            X = X * _vec(self.Dr, X.device, X.real.dtype)[None, :]
            nrm = torch.linalg.vector_norm(X, dim=1, keepdim=True)
            self._eigenvectors = X / torch.where(nrm > 0, nrm,
                                                 torch.ones_like(nrm))

    def _basis_to_monomial(self):
        """Convert coefficient matrices from the configured polynomial
        basis to monomial (reference: PEP bases, pepimpl.h pbc):
        P(lam) = sum_i B_i phi_i(lam) = sum_k (sum_i c_ik B_i) lam^k."""
        if self.basis == "monomial":
            return
        import numpy.polynomial as npoly

        conv = {
            "chebyshev1": npoly.chebyshev.cheb2poly,
            "chebyshev": npoly.chebyshev.cheb2poly,
            "legendre": npoly.legendre.leg2poly,
            "laguerre": npoly.laguerre.lag2poly,
            "hermite": npoly.hermite.herm2poly,
            "hermite_e": npoly.hermite_e.herme2poly,
        }
        if self.basis == "chebyshev2":
            # U_i via the recurrence U_0=1, U_1=2x, U_{i+1}=2x U_i - U_{i-1}
            d = self.degree
            C = np.zeros((d + 1, d + 1))
            C[0, 0] = 1.0
            if d >= 1:
                C[1, 1] = 2.0
            for i in range(1, d):
                C[i + 1, 1:] += 2.0 * C[i, :-1]
                C[i + 1, :] -= C[i - 1, :]
        elif self.basis in conv:
            d = self.degree
            C = np.zeros((d + 1, d + 1))
            for i in range(d + 1):
                e = np.zeros(i + 1)
                e[i] = 1.0
                ck = conv[self.basis](e)
                C[i, : len(ck)] = ck
        else:
            raise ValueError(f"unknown polynomial basis {self.basis!r}")
        newmats = []
        for k in range(self.degree + 1):
            coeffs = C[:, k]
            nz = [(c, m) for c, m in zip(coeffs, self.mats) if c != 0.0]
            newmats.append(SumOperator(tuple(m for _, m in nz),
                                       tuple(float(c) for c, _ in nz)))
        self._basis_mats = self.mats
        self.mats = newmats
        self.basis = "monomial"

    def solve(self):
        self._basis_to_monomial()
        if self.scale in ("diagonal", "both"):
            self._apply_diagonal_scaling()
            try:
                self.scale = "none" if self.scale == "diagonal" else "scalar"
                return self.solve()
            finally:
                self.scale = "diagonal" if self.scale == "none" else "both"
                self._undo_diagonal_scaling()
        if getattr(self, "interval", None) is not None:
            if self.tol is None:
                self.tol = 1e-8
            from .qslice import qslice_solve

            qslice_solve(self)
            return self
        if self.solver == "linear":
            self._solve_linear()
        elif self.solver == "toar":
            from .toar import toar_solve

            toar_solve(self)
        elif self.solver == "qarnoldi":
            # memory-saving Q-Arnoldi recurrence (quadratic only)
            from .qarnoldi import qarnoldi_solve
            from .toar import toar_solve

            (qarnoldi_solve if self.degree == 2 else toar_solve)(self)
        elif self.solver == "stoar":
            # symmetric pseudo-Lanczos on the symmetric linearization
            from .stoar import stoar_solve

            stoar_solve(self)
        elif self.solver == "jd":
            self._solve_jd()
        elif self.solver == "ciss":
            self._solve_ciss()
        else:
            raise ValueError(f"unknown PEP solver {self.solver!r}")
        return self

    def set_rg(self, rg):
        self.rg = rg
        return self

    def set_extraction(self, kind: str):
        """Eigenvector extraction from the linearization's stacked blocks
        (reference PEPSetExtraction, slepcpep.h PEPExtract): 'none' (first
        block), 'norm' (largest block), 'residual' (block with smallest
        true residual), 'structured' (mu-weighted average)."""
        if kind not in ("none", "norm", "residual", "structured"):
            raise ValueError(f"unknown PEP extraction {kind!r}")
        self.extract = kind
        return self

    def refine(self, steps: int = 3, scheme: str = "simple"):
        """Newton iterative refinement of converged pairs (reference:
        PEPSetRefine, interface/peprefine.c).  scheme='simple' refines
        each pair independently (thread-parallel); scheme='multiple'
        refines the joint invariant pair (X, H) -- robust for clustered
        or defective eigenvalues."""
        if scheme == "multiple":
            refine_pep_multiple(self, steps)
        else:
            refine_pep(self, steps)
        return self

    def _set_results(self, lams, errs, X_rows: torch.Tensor):
        """Store the pairs: eigenvalues and errors on the host, the vectors
        as the rows of a tensor on the coefficients' device."""
        self.eigenvalues = np.asarray(lams)
        self.errests = np.asarray(errs)
        self._eigenvectors = X_rows.to(self.device)

    def _mult_np(self, op, x: np.ndarray) -> np.ndarray:
        """op x for a host vector, applied on the operator's device."""
        return _np(op_mult(op, _vec(x, op.device)))

    def _solve_jd(self):
        """Polynomial Jacobi-Davidson (reference: src/pep/impls/jd/pjd.c):
        Davidson loop with the projected polynomial problem solved by
        DSPEP and expansion by the preconditioned polynomial residual.
        The search space is a host (n, m) array; its applies run on the
        coefficients' device, one block apply per coefficient."""
        from ..ds.types import DSPEP
        from ..ksp.ksp import _jacobi_precond

        n = self.n
        d = self.degree
        ncv = self.ncv or 20
        tol = self.tol if self.tol is not None else 1e-8
        max_it = self.max_it or 200
        target = complex(self.target) if self.target is not None else 0.0
        sc = SortCriterion(Which.TARGET_MAGNITUDE, target)

        dev_precond = _jacobi_precond(
            SumOperator(tuple(self.mats), tuple(target**i for i in range(d + 1))))
        precond = (lambda r: r) if dev_precond is None else \
            (lambda r: _np(dev_precond(_vec(r, self.device))))

        rng = np.random.default_rng(0)
        v = rng.standard_normal(n)
        V = (v / np.linalg.norm(v))[:, None]
        found = []
        theta_prev = None
        self.its = 0

        def restart_space():
            v = rng.standard_normal(n).astype(float)
            for f, _, xf in found:
                v = v - xf.real * (xf.real @ v) / max(xf.real @ xf.real, 1e-300)
            return (v / np.linalg.norm(v))[:, None]

        while self.its < max_it and len(found) < self.nev:
            self.its += 1
            Vr = _vec(np.ascontiguousarray(V.T), self.device)
            G = [V.conj().T @ _np(op_mult_block(m, Vr)).T for m in self.mats]
            lam_all, Y = DSPEP().solve(G)
            finite = np.isfinite(lam_all)
            lam_all, Y = lam_all[finite], Y[:, finite]
            # skip already-found eigenvalues
            keys = sc.keys(lam_all)
            for f, _, _ in found:
                keys = keys + np.where(np.abs(lam_all - f)
                                       < 1e-6 * max(1.0, abs(f)), np.inf, 0.0)
            # sticky selection: once tracking a Ritz value, follow it
            # (prevents target-equidistant pairs from flip-flopping)
            if theta_prev is not None:
                j = int(np.argmin(np.abs(lam_all - theta_prev)
                                  + np.where(np.isinf(keys), np.inf, 0.0)))
            else:
                j = int(np.argmin(keys))
            theta = lam_all[j]
            x = V @ Y[:, j]
            x = x / np.linalg.norm(x)
            r = _np(self.p_apply(complex(theta), _vec(x, self.device)))
            e = np.linalg.norm(r) / max(np.linalg.norm(x), 1e-300)
            if e < 0.3:
                theta_prev = theta  # start tracking once roughly locked on
            if e < tol:
                found.append((complex(theta), e, x))
                theta_prev = None
                # deflation: restart space orthogonal to found vectors
                V = restart_space()
                continue
            # JD correction: approximately solve the projected equation
            # (I-xx^H) P(theta) (I-xx^H) t = -r  (reference dvdimprovex role)
            t = _pjd_correct(self, complex(theta), x, r, precond)
            if np.iscomplexobj(t) and not np.iscomplexobj(V):
                V = V.astype(complex)
            t = t - V @ (V.conj().T @ t)
            t = t - V @ (V.conj().T @ t)
            nt = np.linalg.norm(t)
            if nt < 1e-13:
                if e < 1e-4:
                    # correction space exhausted near convergence: polish by
                    # inverse iteration on P(theta) + polynomial Rayleigh
                    # functional, then lock
                    theta_p, x_p, e_p = _pjd_polish(self, complex(theta), x, tol)
                    if e_p < tol:
                        found.append((theta_p, e_p, x_p))
                        theta_prev = None
                        V = restart_space()
                        continue
                t = rng.standard_normal(n)
                t = t - V @ (V.conj().T @ t)
                nt = np.linalg.norm(t)
            if V.shape[1] >= ncv:
                # restart keeping the tracked Ritz vector + best few
                best = np.argsort(keys)[: max(2, self.nev)]
                V = V @ Y[:, best]
                V, _ = np.linalg.qr(V)
            V = np.column_stack([V, t / nt])
        self.nconv = len(found)
        X = np.stack([f[2] for f in found]) if found \
            else np.zeros((0, n), dtype=complex)
        self._set_results([f[0] for f in found], [f[1] for f in found],
                          _vec(X, self.device))

    def _pjd_correct_op(self, theta):
        coeffs = tuple(theta**i for i in range(self.degree + 1))
        return SumOperator(tuple(self.mats), coeffs)

    def _solve_ciss(self):
        """Polynomial contour-integral solver (reference:
        src/pep/impls/ciss/pciss.c) -- delegates to the shared nonlinear
        contour machinery with T(z) = P(z)."""
        from ..fn.fn import FNRational
        from ..nep.nep import NEP

        nep = NEP(nev=self.nev, tol=self.tol or 1e-9, solver="ciss",
                  target=self.target if self.target is not None else 0.0)
        fns = [FNRational([1.0] + [0.0] * i)  # x^i
               for i in range(self.degree + 1)]
        nep.set_split_operators(self.mats, fns)
        if getattr(self, "rg", None) is not None:
            nep.set_rg(self.rg)
        nep.solve()
        self.its = nep.its
        self.nconv = nep.nconv
        self._set_results(nep.eigenvalues.copy(), nep.errests.copy(),
                          nep._eigenvectors)

    # ---- linear: companion pencil -> EPS (reference impls/linear/linear.c)
    def _companion(self):
        """The companion pencil (L0, L1) of P as shell operators on the
        coefficients' device."""
        mats = self.mats
        d = self.degree
        n = self.n
        dtype = mats[0].dtype
        for m in mats[1:]:
            dtype = torch.promote_types(dtype, m.dtype)
        Nn = d * n

        def mvA(x):
            # L0 x: blocks [x_1, ..., x_{d-1}, -sum A_i x_i]
            xs = [x[i * n: (i + 1) * n] for i in range(d)]
            out = [xs[i + 1] for i in range(d - 1)]
            last = -op_mult(mats[0], xs[0])
            for i in range(1, d):
                last = last - op_mult(mats[i], xs[i])
            out.append(last)
            return torch.cat(out)

        def mvB(x):
            xs = [x[i * n: (i + 1) * n] for i in range(d)]
            out = xs[: d - 1] + [op_mult(mats[d], xs[d - 1])]
            return torch.cat(out)

        L0 = ShellOperator((Nn, Nn), dtype, mvA, nnz=sum(m.nnz for m in mats),
                           device=self.device)
        L1 = ShellOperator((Nn, Nn), dtype, mvB,
                           nnz=mats[d].nnz + (d - 1) * n, device=self.device)
        return L0, L1

    def _solve_linear(self):
        n = self.n
        L0, L1 = self._companion()
        target = self.target if self.target is not None else 0.0
        eps = EPS(L0, L1, problem_type=ProblemType.GNHEP, which=self.which,
                  nev=self.nev, ncv=self.ncv, tol=self.tol, max_it=self.max_it)
        if self.which in (Which.TARGET_MAGNITUDE, Which.TARGET_REAL,
                          Which.TARGET_IMAGINARY) or self.target is not None:
            eps.set_target(target)
            # sinvert on the pencil: (L0 - sigma L1)^{-1} L1 -- one
            # P(sigma) solve per apply, from the polynomial structure
            eps.set_st(_CompanionSinvert([L0, L1], self, sigma=target))
        eps.solve()
        self.its = eps.its
        self.nconv = eps.nconv
        Xp = eps._eigenvectors[: eps.nconv, :n]
        nrm = torch.linalg.vector_norm(Xp, dim=1, keepdim=True)
        self._set_results(eps.eigenvalues[: eps.nconv].copy(),
                          eps.errests[: eps.nconv].copy(),
                          Xp / torch.where(nrm > 0, nrm, torch.ones_like(nrm)))

    # ---- results --------------------------------------------------------
    def get_converged(self):
        return self.nconv

    def get_eigenpair(self, i: int):
        """(lambda_i, x_i) with x_i a tensor on the coefficients' device."""
        return self.eigenvalues[i], self._eigenvectors[i]

    def get_eigenvectors(self) -> torch.Tensor:
        """The converged eigenvectors as the reference's (n, nconv)
        columns: a transposed view of the device rows."""
        return self._eigenvectors[: self.nconv].T

    def p_apply(self, lam: complex, x: torch.Tensor) -> torch.Tensor:
        """P(lam) x, on the coefficients' device."""
        y = None
        mu = 1.0
        for A in self.mats:
            t = op_mult(A, x) * mu
            y = t if y is None else y + t
            mu = mu * lam
        return y

    def compute_error(self, i: int) -> float:
        """Polynomial backward error (Tisseur):
        ||P(lam)x|| / (sum_k |lam|^k ||A_k|| * ||x||)."""
        lam, x = self.get_eigenpair(i)
        r = self.p_apply(complex(lam), x)
        if not hasattr(self, "_coef_norms"):
            self._coef_norms = [m.norm_estimate() for m in self.mats]
        den = sum(abs(lam) ** k * nk
                  for k, nk in enumerate(self._coef_norms))
        nr, nx = torch.stack([torch.linalg.vector_norm(r),
                              torch.linalg.vector_norm(x)]).tolist()
        return nr / max(den * nx, 1e-300)


class _CompanionSinvert(ST):
    """Shift-and-invert on the companion pencil exploiting the block
    structure: solving (L0 - sigma L1) z = w reduces to one P(sigma) solve
    plus back-substitution through the companion blocks (the reference's
    PEP linear + ST factors P(sigma) the same way via STCoeffs)."""

    name = "companion-sinvert"

    def __init__(self, matrices, pep: PEP, sigma: complex = 0.0):
        super().__init__(matrices, sigma)
        self.pep = pep

    def _compute_operator(self):
        pep = self.pep
        d = pep.degree
        n = pep.n
        sigma = self.sigma
        Nn = d * n
        ksp = self.ksp = psigma_ksp(pep.mats, sigma)
        mats = pep.mats
        L1 = self.mats[1]

        def mv(x):
            # solve (L0 - sigma L1) z = L1 x  (the sinvert operator):
            # substituting z_i = sigma^i z_0 + t_i with t_0 = 0,
            # t_{i+1} = w_i + sigma t_i gives
            # P(sigma) z_0 = -(w_{d-1} + sum_i A_i t_i + sigma A_d t_{d-1})
            w = L1.mult(x)
            ws = [w[i * n: (i + 1) * n] for i in range(d)]
            ts = [torch.zeros_like(ws[0])]
            for i in range(d - 1):
                ts.append(ws[i] + sigma * ts[i])
            rhs = -ws[d - 1]
            for i in range(1, d):
                rhs = rhs - op_mult(mats[i], ts[i])
            rhs = rhs - sigma * op_mult(mats[d], ts[d - 1])
            z0 = ksp.solve(rhs)
            zs = [z0]
            for i in range(d - 1):
                zs.append(sigma * zs[i] + ws[i])
            return torch.cat(zs)

        return self._shell(mv, nnz=sum(m.nnz for m in mats))

    def back_transform(self, eigs):
        return 1.0 / np.asarray(eigs) + self.sigma

    def eig_map(self, lam):
        return 1.0 / (lam - self.sigma)


def _pjd_correct(pep, theta, x, r, precond, iters: int = 12):
    """Approximate JD correction for PEP: projected preconditioned
    steepest-descent iterations on (I-xx^H) P(theta) (I-xx^H) t = -r
    (host vectors; P(theta) applied on the device)."""
    P = pep._pjd_correct_op(theta)
    cplx = np.iscomplexobj(r) or isinstance(theta, complex) and theta.imag != 0
    xc = x.astype(complex) if cplx else x

    def proj(v):
        return v - xc * (np.conj(xc) @ v)

    def apply(v):
        return proj(pep._mult_np(P, proj(v)))

    t = np.zeros_like(r, dtype=complex if cplx else r.dtype)
    res = -r.astype(t.dtype)
    for _ in range(iters):
        z = proj(np.asarray(precond(res)))
        Az = apply(z)
        denom = np.vdot(Az, Az)
        if abs(denom) < 1e-300:
            break
        alpha = np.vdot(Az, res) / denom
        t = t + alpha * z
        res = res - alpha * Az
    return t


def _pjd_polish(pep, theta, x, tol, steps: int = 5):
    """Inverse-iteration polish for a nearly-converged PEP Ritz pair:
    x <- P(theta)^{-1} x (one dense factorization), theta <- polynomial
    Rayleigh functional root of x^H P(z) x."""
    lam = complex(theta)
    xc = x.astype(complex)
    e = np.inf
    for _ in range(steps):
        Pd = _np(pep._pjd_correct_op(lam).to_dense()).astype(complex)
        try:
            xn = np.linalg.solve(Pd, xc)
        except np.linalg.LinAlgError:
            break
        xc = xn / np.linalg.norm(xn)
        Ax = [pep._mult_np(m, xc) for m in pep.mats]
        # Newton on g(z) = x^H P(z) x
        for _ in range(20):
            g = sum(lam**i * np.vdot(xc, Ax[i]) for i in range(len(Ax)))
            gp = sum(i * lam**(i - 1) * np.vdot(xc, Ax[i])
                     for i in range(1, len(Ax)))
            if abs(gp) < 1e-300:
                break
            dz = g / gp
            lam = lam - dz
            if abs(dz) < 1e-15 * max(1.0, abs(lam)):
                break
        e = np.linalg.norm(_np(pep.p_apply(lam, _vec(xc, pep.device))))
        if e < tol:
            break
    if abs(lam.imag) < 1e-13:
        lam = complex(lam.real)
    return lam, xc, e


def _bordered_newton_refine(apply_T, apply_Tprime, lam, x, steps=3,
                            solve_dense=None):
    """Newton iterative refinement on the bordered system
    [T(lam), T'(lam)x; x^H, 0] [dx; dlam] = [-r; 0]
    (reference: the 'simple' scheme of peprefine.c / neprefine.c).
    ``apply_T(lam, x)`` / ``apply_Tprime(lam, x)`` take and return host
    vectors; ``solve_dense(lam)`` gives the dense host T(lam)."""
    lam = complex(lam)
    x = np.asarray(x, dtype=complex)
    x = x / np.linalg.norm(x)
    n = x.shape[0]
    for _ in range(steps):
        if solve_dense is None:
            return lam, x  # no dense path available
        r = np.asarray(apply_T(lam, x))
        tp = np.asarray(apply_Tprime(lam, x))
        M = np.zeros((n + 1, n + 1), dtype=complex)
        M[:n, :n] = solve_dense(lam)
        M[:n, n] = tp
        M[n, :n] = x.conj()
        rhs = np.concatenate([-r, [0.0]])
        try:
            sol = np.linalg.solve(M, rhs)
        except np.linalg.LinAlgError:
            break
        x = x + sol[:n]
        lam = lam + sol[n]
        x = x / np.linalg.norm(x)
    return lam, x


def refine_pep(pep, steps: int = 3) -> None:
    """Iterative refinement of all converged PEP pairs (PEPSetRefine
    'simple' analog).  Dense bordered solves on the host; sized for the
    projected/moderate-n problems where refinement matters."""
    if pep.nconv == 0 or pep.n > 4096:
        return

    def apply_T(lam, x):
        return _np(pep.p_apply(lam, _vec(x, pep.device)))

    def apply_Tp(lam, x):
        xj = _vec(x, pep.device)
        y = None
        for i, m in enumerate(pep.mats):
            if i == 0:
                continue
            t = (i * lam ** (i - 1)) * op_mult(m, xj)
            y = t if y is None else y + t
        return _np(y)

    dense = [_np(m.to_dense()) for m in pep.mats]

    def dense_T(lam):
        return sum(lam**i * D for i, D in enumerate(dense))

    # per-eigenpair refinements are independent: thread-pool parallel
    # (the reference's refinement subcommunicators, peprefine.c npart)
    from ..parallel.tasks import thread_map

    X = _np(pep._eigenvectors)

    def refine_one(i):
        return _bordered_newton_refine(apply_T, apply_Tp, pep.eigenvalues[i],
                                       X[i], steps=steps, solve_dense=dense_T)

    results = thread_map(refine_one, range(pep.nconv))
    pep.eigenvalues = pep.eigenvalues.astype(complex)
    X = X.astype(complex)
    for i, (lam2, x2) in enumerate(results):
        pep.eigenvalues[i] = lam2
        X[i] = x2
    pep._eigenvectors = _vec(X, pep.device)


def refine_pep_multiple(pep, steps: int = 2) -> None:
    """Invariant-pair Newton refinement (reference: PEPSetRefine with
    PEP_REFINE_MULTIPLE, peprefine.c -- Betcke/Kressner invariant-pair
    correction): refine ALL converged pairs jointly as (X, H) with
    residual R(X,H) = sum_i A_i X H^i and normalization W^H dX = 0.
    Unlike the 'simple' per-pair scheme this handles clustered and
    defective eigenvalues (the Jacobian stays nonsingular when single
    pairs are ill-defined).

    Dense Kronecker formulation on the host, sized for moderate n*k (the
    projected regime where refinement is used); the correction solves the
    (nk + k^2) linear system built from sum_i (H^i)^T kron A_i and the
    dH-coupling columns."""
    k = pep.nconv
    n = pep.n
    if k == 0 or n * k > 6000:
        return
    d = pep.degree
    Amats = [_np(m.to_dense()).astype(complex) for m in pep.mats]
    X = _np(pep._eigenvectors[:k]).T.astype(complex)
    H = np.diag(pep.eigenvalues[:k].astype(complex))
    W = X.copy()  # normalization basis (minimality: W^H X = I after scale)

    def resid(X, H):
        R = np.zeros((n, k), dtype=complex)
        Hp = np.eye(k, dtype=complex)
        for i in range(d + 1):
            R += Amats[i] @ X @ Hp
            Hp = Hp @ H
        return R

    for _ in range(steps):
        R = resid(X, H)
        if np.linalg.norm(R) < 1e-15 * max(np.linalg.norm(X), 1.0):
            break
        # Jacobian blocks
        Hpows = [np.eye(k, dtype=complex)]
        for i in range(d):
            Hpows.append(Hpows[-1] @ H)
        # M_XX = sum_i (H^i)^T kron A_i   (acts on vec(dX), column-major)
        MXX = np.zeros((n * k, n * k), dtype=complex)
        for i in range(d + 1):
            MXX += np.kron(Hpows[i].T, Amats[i])
        # M_XH: columns indexed by dH entries E_pq
        AX = [Amats[i] @ X for i in range(d + 1)]
        MXH = np.zeros((n * k, k * k), dtype=complex)
        for p in range(k):
            for q in range(k):
                E = np.zeros((k, k), dtype=complex)
                E[p, q] = 1.0
                col = np.zeros((n, k), dtype=complex)
                for i in range(1, d + 1):
                    D = np.zeros((k, k), dtype=complex)
                    for j in range(i):
                        D += Hpows[j] @ E @ Hpows[i - 1 - j]
                    col += AX[i] @ D
                MXH[:, p + q * k] = col.reshape(-1, order="F")
        # normalization rows: W^H dX = 0  (k^2 equations)
        CW = np.kron(np.eye(k, dtype=complex), W.conj().T)  # (k^2, nk)
        Mfull = np.block([[MXX, MXH],
                          [CW, np.zeros((k * k, k * k), dtype=complex)]])
        rhs = np.concatenate([-R.reshape(-1, order="F"),
                              np.zeros(k * k, dtype=complex)])
        try:
            sol = np.linalg.solve(Mfull, rhs)
        except np.linalg.LinAlgError:
            sol, *_ = np.linalg.lstsq(Mfull, rhs, rcond=None)
        X = X + sol[: n * k].reshape(n, k, order="F")
        H = H + sol[n * k:].reshape(k, k, order="F")

    # extract refined eigenpairs from the pair (X, H)
    wv, Y = np.linalg.eig(H)
    Xr = X @ Y
    nrm = np.linalg.norm(Xr, axis=0)
    nrm[nrm == 0] = 1
    Xr = Xr / nrm
    # keep the locked ordering: match each old eigenvalue to a new one
    used = np.zeros(k, bool)
    pep.eigenvalues = pep.eigenvalues.astype(complex)
    Xout = _np(pep._eigenvectors).astype(complex)
    for i in range(k):
        dmatch = np.abs(wv - pep.eigenvalues[i]) + np.where(used, np.inf, 0)
        j = int(np.argmin(dmatch))
        used[j] = True
        pep.eigenvalues[i] = wv[j]
        Xout[i] = Xr[:, j]
    pep._eigenvectors = _vec(Xout, pep.device)
