"""NEP -- general nonlinear eigenproblems T(lambda) x = 0
(``slepc_tpu/nep/nep.py``).

Reference: src/nep/ -- user interface via callbacks (Function/Jacobian) or
*split form* T(lambda) = sum_i f_i(lambda) A_i with FN scalar functions
(nepimpl.h).  Solvers: rii (residual inverse iteration), slp (successive
linear problems), narnoldi, nleigs (rational Krylov on rational
interpolation; the compact basis of ``nep/nleigs_toar.py`` by default, the
full d*n basis as an option), interpol (Chebyshev interpolation -> inner
PEP), ciss (contour).  Deflation of converged pairs: Effenberger's
minimal invariant pairs for SLP on small problems, orthogonal projection
otherwise.

The split operators stay on their device and every T(lambda) x is their
SpMVs there (a real DIA term on a complex vector takes K2 by parts), with
the complex scaling and sums as tensor ops; n-long vectors are device
tensors and each convergence test reads two norms (a Rayleigh-functional
Newton step two inner products) at once.  Eigenvectors are the rows of an
(k, n) tensor on that device (``get_eigenpair`` returns a row,
``get_eigenvectors`` the reference's (n, k) columns as a transposed view);
eigenvalues and error estimates are host numpy.  What the reference does on
small dense matrices in numpy stays host numpy here: the Effenberger
pencils (n <= 2048), the projected problems (``DSNEP``), the contour
quadrature with one host factorization a point, the Leja-Bagby points and
the rational divided differences, the left vectors and the bordered
refinement (n <= 4096).  A direct solve with T takes the explicit matrix
of the split form (``SumOperator.explicit``: dense LU on the device for a
dense sum, host sparse LU for a sparse one, as PEP's P(sigma)); the dense
T(lambda) of the contour and Newton polish is assembled on the operators'
device and solved there.  The reference's host callbacks (its full-basis
shell runs through ``pure_callback``) have no counterpart in eager torch.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..bv.orthog import orthogonalize_vec
from ..eps.base import EPS, ProblemType, basis_combine
from ..fn.fn import FN
from ..ksp import KSP
from ..mat.linop import (DenseOperator, DIAOperator, LinearOperator,
                         ScaledOperator, ShellOperator, SumOperator)
from ..ops.rotate import rotate
from ..pep.pep import _np, _vec, operator_of
from ..pep.toar import _complex_of
from ..sys.events import log_event
from ..sys.options import apply_module_options
from ..sys.sort import Which


def _norms(*vs) -> List[float]:
    """The 2-norms of device vectors, read in one host transfer."""
    return torch.stack([torch.linalg.vector_norm(v) for v in vs]).tolist()


def _add_dense(M: torch.Tensor, op: LinearOperator, c: complex) -> None:
    """M += c * op, assembled on M's device: a DIA operator by its
    diagonals, a dense one by its matrix, sums and scalings term by term;
    anything else by its explicit host matrix, else one mult per column."""
    c = complex(c)
    if isinstance(op, SumOperator):
        for cc, o in zip(op.coeffs, op.ops):
            _add_dense(M, o, c * complex(cc))
    elif isinstance(op, ScaledOperator):
        _add_dense(M, op.op, c * complex(op.alpha))
    elif isinstance(op, DenseOperator):
        M += c * op.A.to(M.device)
    elif isinstance(op, DIAOperator):
        n = op.shape[0]
        for k, off in enumerate(op.offsets):
            # A[i, i + off] = diags[k, i] for the rows with 0 <= i + off < n
            M.diagonal(off).add_(
                c * op.diags[k, max(0, -off): n - max(0, off)].to(M.device))
    else:
        import scipy.sparse as sp

        E = op.explicit()
        if E is None:
            D = op.to_dense()
        else:
            D = torch.from_numpy(np.ascontiguousarray(
                E.toarray() if sp.issparse(E) else np.asarray(E)))
        M += c * D.to(M.device)


def dense_of(op: LinearOperator, dtype: torch.dtype,
             device) -> torch.Tensor:
    """``op`` as a dense (n, n) tensor of ``dtype`` on ``device``."""
    M = torch.zeros(op.shape, dtype=dtype, device=device)
    _add_dense(M, op, 1.0)
    return M


def direct_ksp(op: LinearOperator) -> KSP:
    """A direct KSP on ``op``: the factorization of its explicit matrix
    (dense LU on the device for a dense one, host sparse LU for a sparse
    one) when it has one, else the operator itself."""
    M = op.explicit()
    if M is not None:
        return KSP(operator_of(M, op.device), method="direct")
    return KSP(op, method="direct")


class NEP:
    """Nonlinear eigensolver (split form or callback form)."""

    def __init__(self, *, nev: int = 1, tol: Optional[float] = None,
                 max_it: int = 100, solver: str = "slp",
                 target: complex = 0.0):
        self.split_A: List[LinearOperator] = []
        self.split_f: List[FN] = []
        self.fun: Optional[Callable[[complex], LinearOperator]] = None
        self.jac: Optional[Callable[[complex], LinearOperator]] = None
        self.nev = nev
        self.tol = tol
        self.max_it = max_it
        self.solver = solver
        self.target = target
        self.rg = None
        self.nconv = 0
        self.its = 0
        self.two_sided = False
        self.nleigs_full_basis = False
        apply_module_options(self, "nep_", int_keys=("nev", "max_it"),
                             float_keys=("tol",), str_keys=("type",),
                             bool_keys=("two_sided", "nleigs_full_basis"))
        self.eigenvalues = np.array([], dtype=complex)
        self.errests = np.array([])
        self._eigenvectors: Optional[torch.Tensor] = None
        self._left_eigenvectors: Optional[torch.Tensor] = None

    # -- problem definition -----------------------------------------------
    def set_split_operators(self, mats: Sequence[LinearOperator],
                            fns: Sequence[FN]):
        if len(mats) != len(fns):
            raise ValueError(f"set_split_operators: {len(mats)} matrices "
                             f"and {len(fns)} functions")
        self.split_A = list(mats)
        self.split_f = list(fns)
        return self

    def set_function(self, fun: Callable[[complex], LinearOperator],
                     jac: Optional[Callable[[complex], LinearOperator]] = None):
        self.fun = fun
        self.jac = jac
        return self

    def set_target(self, t: complex):
        self.target = t
        return self

    def set_type(self, name: str):
        self.solver = name
        return self

    def set_dimensions(self, nev=None):
        if nev is not None:
            self.nev = nev
        return self

    def set_tolerances(self, tol=None, max_it=None):
        if tol is not None:
            self.tol = tol
        if max_it is not None:
            self.max_it = max_it
        return self

    def set_rg(self, rg):
        self.rg = rg
        return self

    # -- T(lambda), T'(lambda) as operators --------------------------------
    def _probe(self) -> LinearOperator:
        return self.split_A[0] if self.split_A else self.fun(self.target)

    @property
    def n(self) -> int:
        return self._probe().shape[0]

    @property
    def device(self) -> torch.device:
        return self._probe().device

    @property
    def cdtype(self) -> torch.dtype:
        """The complex type of the vectors: the operators' type made
        complex."""
        ops = self.split_A or [self.fun(self.target)]
        dt = ops[0].dtype
        for o in ops[1:]:
            dt = torch.promote_types(dt, o.dtype)
        return _complex_of(dt)

    def T(self, lam: complex) -> LinearOperator:
        if self.fun is not None:
            return self.fun(lam)
        coeffs = tuple(complex(f.eval(lam)) for f in self.split_f)
        return SumOperator(tuple(self.split_A), coeffs)

    def Tprime(self, lam: complex) -> LinearOperator:
        if self.jac is not None:
            return self.jac(lam)
        if self.fun is not None:
            # finite-difference Jacobian fallback
            h = 1e-7 * max(1.0, abs(lam))
            Tp = self.fun(lam + h)
            Tm = self.fun(lam - h)
            return SumOperator((Tp, Tm), (0.5 / h, -0.5 / h))
        coeffs = tuple(complex(f.eval_deriv(lam)) for f in self.split_f)
        return SumOperator(tuple(self.split_A), coeffs)

    def _dense_T_dev(self, lam: complex) -> torch.Tensor:
        """The dense T(lam) on the operators' device (complex)."""
        return dense_of(self.T(lam), self.cdtype, self.device)

    def _dense_T(self, lam: complex) -> np.ndarray:
        """The dense T(lam) as a host array (the small dense paths)."""
        return _np(self._dense_T_dev(lam))

    def _dense_np(self, op: LinearOperator) -> np.ndarray:
        return _np(dense_of(op, self.cdtype, self.device))

    # -- solve -------------------------------------------------------------
    def solve(self):
        if self.tol is None:
            self.tol = 1e-9
        if self.solver == "slp":
            self._solve_newton(improve="slp")
        elif self.solver == "rii":
            self._solve_newton(improve="rii")
        elif self.solver == "narnoldi":
            self._solve_narnoldi()
        elif self.solver == "interpol":
            self._solve_interpol()
        elif self.solver == "ciss":
            self._solve_ciss()
        elif self.solver == "nleigs":
            self._solve_nleigs()
        else:
            raise ValueError(f"unknown NEP solver {self.solver!r}")
        if self.two_sided:
            _attach_two_sided(self)
        return self

    def set_two_sided(self, flg: bool = True):
        self.two_sided = flg
        return self

    def get_left_eigenvector(self, i: int) -> torch.Tensor:
        """y_i with y_i^H T(lambda_i) = 0, a tensor on the operators'
        device (two-sided solves)."""
        if self._left_eigenvectors is None:
            raise ValueError("no left eigenvectors (enable set_two_sided)")
        return self._left_eigenvectors[i]

    def apply_resolvent(self, z: complex, v) -> torch.Tensor:
        """Action of the resolvent from the computed eigentriplets
        (reference: NEPApplyResolvent, interface/nepresolv.c):
        R(z) v = sum_i x_i (y_i^H v) / ((z - lam_i) * (y_i^H T'(lam_i) x_i)).
        ``v`` a host vector or a tensor; the result a tensor on the
        operators' device."""
        if self._left_eigenvectors is None:
            _attach_two_sided(self)
        v = _vec(v, self.device).to(self.cdtype)
        out = torch.zeros_like(v)
        for i in range(self.nconv):
            lam = complex(self.eigenvalues[i])
            x = self._eigenvectors[i].to(self.cdtype)
            y = self._left_eigenvectors[i]
            tp = self.Tprime(lam).mult(x)
            ytp, yv = torch.stack([torch.vdot(y, tp),
                                   torch.vdot(y, v)]).tolist()
            denom = (z - lam) * ytp
            if abs(denom) < 1e-300:
                continue
            out = out + x * (yv / denom)
        return out

    def _residual(self, lam, x: torch.Tensor) -> float:
        r = self.T(lam).mult(x)
        nr, nx = _norms(r, x)
        return nr / max(nx, 1e-300)

    def _set_results(self, lams, errs, rows: Sequence[torch.Tensor]):
        """Store the pairs: values and errors on the host, the vectors as
        the rows of a tensor on the operators' device."""
        self.eigenvalues = np.array(lams)
        self.errests = np.array(errs)
        self._eigenvectors = torch.stack(list(rows)) if len(rows) else \
            torch.zeros((0, self.n), dtype=self.cdtype, device=self.device)

    def _solve_newton(self, improve: str):
        """SLP (reference slp.c: eigen-correction mu from the pencil
        (T(lam), T'(lam))) and RII (reference rii.c: fixed preconditioner
        T(sigma)^{-1}, Rayleigh-functional update).

        Deflation of converged pairs: for SLP with a dense path available,
        Effenberger minimal-invariant-pair deflation (reference:
        nepdefl.c) -- the extended problem
          T~(lam) = [[T(lam), T(lam) X (lam I - H)^{-1}], [X^H, 0]]
        is analytic, removes exactly the deflated eigenvalues, and stays
        well-posed for multiple/clustered eigenvalues where orthogonal
        projection fails; the converged pair extends (X, H).  Its dense
        pencils are host numpy (n <= 2048), as in the reference.  RII and
        the large-n path keep orthogonal-projection deflation, on the
        device."""
        import scipy.linalg as sla

        n = self.n
        dev = self.device
        found_lam: List[complex] = []
        found_x: List[torch.Tensor] = []
        errs: List[float] = []
        self.its = 0
        rng = np.random.default_rng(0)
        use_defl = (improve == "slp" and n <= 2048
                    and getattr(self, "deflation", "effenberger")
                    == "effenberger")
        Xp = np.zeros((n, 0), dtype=complex)  # invariant-pair basis
        Hp = np.zeros((0, 0), dtype=complex)  # invariant-pair H

        for pair in range(self.nev):
            k = Xp.shape[1]
            lam = complex(self.target) + (0.0 if use_defl and k else
                                          (0.01 * pair if found_lam else 0.0))
            if use_defl and k:
                # ---- SLP on the Effenberger-extended problem ----
                Ik = np.eye(k, dtype=complex)

                def Ttil(z):
                    Td = self._dense_T(z)
                    G = np.linalg.solve(z * Ik - Hp, Ik)
                    U = Td @ Xp @ G
                    return np.block([[Td, U],
                                     [Xp.conj().T,
                                      np.zeros((k, k), dtype=complex)]])

                def Ttil_prime(z):
                    Td = self._dense_T(z)
                    Tp = self._dense_np(self.Tprime(z))
                    G = np.linalg.solve(z * Ik - Hp, Ik)
                    Up = Tp @ Xp @ G - Td @ Xp @ (G @ G)
                    return np.block([[Tp, Up],
                                     [np.zeros((k, n + k), dtype=complex)]])

                y = None
                converged = False
                for it in range(self.max_it):
                    self.its += 1
                    mu_, Yp = sla.eig(Ttil(lam), Ttil_prime(lam))
                    fin = np.isfinite(mu_)
                    mu_, Yp = mu_[fin], Yp[:, fin]
                    if mu_.size == 0:
                        break
                    j = int(np.argmin(np.abs(mu_)))
                    lam = lam - mu_[j]
                    y = Yp[:, j] / np.linalg.norm(Yp[:, j])
                    rext = np.linalg.norm(Ttil(lam) @ y)
                    if rext < self.tol:
                        converged = True
                        break
                if y is None:
                    break
                s = np.linalg.solve(lam * Ik - Hp, y[n:])
                xt = y[:n] + Xp @ s
                nx = np.linalg.norm(xt)
                if nx < 1e-12:
                    break
                xt, s = xt / nx, s / nx
                # extend the minimal invariant pair
                Xp = np.concatenate([Xp, xt[:, None]], axis=1)
                Hp = np.block([[Hp, s[:, None]],
                               [np.zeros((1, k), dtype=complex),
                                np.array([[lam]], dtype=complex)]])
                found_lam.append(complex(lam))
                xtj = _vec(xt, dev).to(self.cdtype)
                found_x.append(xtj)
                errs.append(self._residual(complex(lam), xtj))
                if not converged:
                    break
                continue

            x = _vec(rng.standard_normal(n) + 0j, dev).to(self.cdtype)
            # deflate: orthogonalize against converged vectors
            for xf in found_x:
                x = x - xf * torch.vdot(xf, x)
            xj = x / torch.linalg.vector_norm(x)
            ksp_rii = None
            if improve == "rii":
                ksp_rii = direct_ksp(self.T(lam))
            converged = False
            for it in range(self.max_it):
                self.its += 1
                Tl = self.T(lam)
                res = Tl.mult(xj)
                nr, nx = _norms(res, xj)
                if nr / max(nx, 1e-300) < self.tol:
                    converged = True
                    break
                if improve == "slp":
                    # mu = smallest eigenvalue of T(lam) y = mu T'(lam) y
                    mu, y = _smallest_pencil_eig(self, Tl, self.Tprime(lam))
                    lam = lam - mu
                    xj = y
                else:  # rii
                    # x <- x - T(sigma)^{-1} T(lam) x; Rayleigh update
                    xj = xj - ksp_rii.solve(res)
                    for xf in found_x:
                        xj = xj - xf * torch.vdot(xf, xj)
                    xj = xj / torch.linalg.vector_norm(xj)
                    lam = _rayleigh_functional(self, lam, xj)
            xj = xj / torch.linalg.vector_norm(xj)
            found_lam.append(lam)
            found_x.append(xj)
            errs.append(self._residual(lam, xj))
            if use_defl:
                # seed the invariant pair from the first converged vector
                Xp = np.concatenate([Xp, _np(xj)[:, None]], axis=1)
                Hp = np.array([[lam]], dtype=complex)
            if not converged:
                break

        self.nconv = sum(1 for e in errs if e < self.tol * 100)
        self._set_results(found_lam, errs, found_x)

    def _solve_narnoldi(self):
        """Nonlinear Arnoldi (reference narnoldi.c): project T(lambda) on a
        growing subspace, solve the projected NEP (``DSNEP.solve_slp``),
        expand with the preconditioned residual.  The subspace is a device
        row basis: the projections V^H (T(z) V) are one small product
        there, the Ritz vector one K4 combination and the expansion one
        classical Gram-Schmidt sweep on K3 (the reference's Gram-Schmidt
        loop, equal to rounding)."""
        from ..ds.types import DSNEP

        n = self.n
        dev = self.device
        rng = np.random.default_rng(0)
        v = rng.standard_normal(n) + 0j
        v /= np.linalg.norm(v)
        V = _vec(v, dev).to(self.cdtype)[None, :]
        lam = complex(self.target)
        ksp = direct_ksp(self.T(lam))
        self.its = 0
        err = np.inf
        x = V[0]
        for it in range(self.max_it):
            self.its += 1

            def project(op):
                return _np(V.conj() @ op.mult_block(V).T)

            lam, y = DSNEP().solve_slp(lambda z: project(self.T(z)),
                                       lambda z: project(self.Tprime(z)),
                                       lam)
            x = basis_combine(V, np.asarray(y)[:, None])[0]
            res = self.T(lam).mult(x)
            nr, nx = _norms(res, x)
            err = nr / max(nx, 1e-300)
            if err < self.tol:
                break
            d, _, _, nd = orthogonalize_vec(V, ksp.solve(res), passes=1)
            nd = float(nd)
            if nd < 1e-14:
                break
            V = torch.cat([V, (d / nd)[None, :]])
        self.nconv = 1 if err < self.tol else 0
        self._set_results([lam], [err], [x / torch.linalg.vector_norm(x)])

    def _solve_interpol(self):
        """Chebyshev interpolation -> PEP (reference interpol.c): sample the
        split scalar functions on an interval around the target, build a
        polynomial approximation, and solve the PEP (the port's
        ``PEP(..., solver="linear")`` on the same operators)."""
        if not self.split_f:
            raise ValueError("interpol requires split form")
        from ..pep.pep import PEP

        deg = 12
        # interpolation interval around the target (real interval)
        t = complex(self.target).real
        rad = max(abs(t) * 0.5, 1.0)
        a, b = t - rad, t + rad
        # Chebyshev nodes and monomial-coefficient fit per scalar function
        nodes = np.cos(np.pi * (np.arange(deg + 1) + 0.5) / (deg + 1))
        xs = 0.5 * (b - a) * nodes + 0.5 * (b + a)
        # build polynomial coefficient matrices: P(lam) = sum_k lam^k C_k
        Vand = np.vander(xs, deg + 1, increasing=True)
        coef_per_fn = []
        for f in self.split_f:
            vals = np.array([f.eval(xi) for xi in xs])
            c, *_ = np.linalg.lstsq(Vand, vals, rcond=None)
            coef_per_fn.append(c)
        mats = []
        for k in range(deg + 1):
            coeffs = tuple(c[k].item() for c in coef_per_fn)
            mats.append(SumOperator(tuple(self.split_A), coeffs))
        pep = PEP(mats, nev=self.nev, target=self.target,
                  tol=max(self.tol * 0.01, 1e-12), solver="linear")
        pep.solve()
        self.its = pep.its
        lams, errs, xs_ = [], [], []
        for i in range(pep.nconv):
            lam_i, x_i = pep.get_eigenpair(i)
            x_i = x_i.to(self.cdtype)
            lams.append(complex(lam_i))
            errs.append(self._residual(complex(lam_i), x_i))
            xs_.append(x_i)
        self.nconv = sum(1 for e in errs if e < self.tol * 100)
        self._set_results(lams, errs, xs_)

    def _solve_at_factory(self):
        """Returns solve_at(z, R) = T(z)^{-1} R (host numpy, factorizing
        per point: sparse LU of the summed split matrices, or a dense
        solve)."""
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        if self.split_A:
            mats_sc = [m.explicit() for m in self.split_A]
            mats_sc = [m.to_scipy() if M is None else M
                       for m, M in zip(self.split_A, mats_sc)]
            sparse = any(sp.issparse(M) for M in mats_sc)

            def solve_at(z, R):
                coeffs = [complex(f.eval(z)) for f in self.split_f]
                Tz = sum(c * (M if not sparse or sp.issparse(M)
                              else sp.csr_matrix(M))
                         for c, M in zip(coeffs, mats_sc))
                if sparse:
                    return spla.splu(sp.csc_matrix(Tz, dtype=complex)).solve(
                        R.astype(complex))
                return np.linalg.solve(np.asarray(Tz, dtype=complex),
                                       R.astype(complex))

            return solve_at

        def solve_at(z, R):
            return np.linalg.solve(self._dense_T(z), R.astype(complex))

        return solve_at

    def _solve_ciss(self, rg=None):
        """Contour-integral NEP solver (reference: src/nep/impls/ciss/
        nciss.c): block-Hankel Beyn extraction from the moments
        S_k = (1/2 pi i) oint z^k T(z)^{-1} V dz (``sys/contour.py``, one
        host factorization a quadrature point) -- only eigenvalues enclosed
        by the contour survive; Newton polishing (one solve with the dense
        T(lambda), assembled and factorized on the operators' device, then
        the Rayleigh functional) brings each pair to tolerance."""
        from ..rg.rg import RGEllipse
        from ..sys.contour import contour_moments

        rg = rg or getattr(self, "rg", None)
        if rg is None:
            rg = RGEllipse(center=self.target,
                           radius=max(abs(self.target) * 0.5, 1.0))
        self.rg = rg
        n = self.n
        dev = self.device
        L = min(24, n)
        mhat = 2
        M = 2 * mhat
        npt = 48
        z, w = rg.contour(npt)
        rng = np.random.default_rng(0)
        V = rng.standard_normal((n, L))
        solve_at = self._solve_at_factory()
        with log_event("NEP_ContourSolves"):  # a host LU a point
            S = contour_moments(solve_at, V, z, w, M)
        Sk = [S[:, k * L: (k + 1) * L] for k in range(M)]
        H0 = np.block([[Sk[i + j] for j in range(mhat)] for i in range(mhat)])
        H1 = np.block([[Sk[i + j + 1] for j in range(mhat)]
                       for i in range(mhat)])
        U, sv, Wh = np.linalg.svd(H0, full_matrices=False)
        r = int(np.sum(sv > 1e-10 * max(sv[0] if sv.size else 0.0, 1e-300)))
        r = max(r, 1)
        U1, sv1, W1 = U[:, :r], sv[:r], Wh[:r, :].conj().T
        Bm = U1.conj().T @ H1 @ W1 / sv1[None, :]
        mu, Y = np.linalg.eig(Bm)
        X = U1[:n, :] @ Y  # first block row carries the eigenvectors
        keep = []
        for i, lmb in enumerate(mu):
            if rg.check_inside(lmb) < 0:
                continue
            x = X[:, i]
            nx = np.linalg.norm(x)
            if nx < 1e-12:
                continue
            x = _vec(x / nx, dev).to(self.cdtype)
            lmb = complex(lmb)
            # Newton polish (Rayleigh functional + one inverse step)
            for _ in range(10):
                e = self._residual(lmb, x)
                if e < self.tol:
                    break
                r_ = self.T(lmb).mult(x)
                try:
                    with log_event("NEP_DenseSolve", sync=True):
                        dx = torch.linalg.solve(self._dense_T_dev(lmb), r_)
                except torch.linalg.LinAlgError:
                    break
                x = x - dx
                x = x / torch.linalg.vector_norm(x)
                lmb = _rayleigh_functional(self, lmb, x)
            e = self._residual(lmb, x)
            if all(abs(lmb - kk[0]) > 1e-8 * max(1.0, abs(lmb))
                   for kk in keep):
                keep.append((lmb, e, x))
        c = complex(getattr(rg, "center", self.target))
        keep.sort(key=lambda t: abs(t[0] - c))
        self.its = 1
        self._set_results([t[0] for t in keep], [t[1] for t in keep],
                          [t[2] for t in keep])
        self.nconv = int(np.sum(self.errests < max(self.tol * 100, 1e-8)))

    def set_singularities(self, points):
        """Discretized singularity set Xi of T (reference:
        NEPNLEIGSSetSingularitiesFunction) -- the pole candidates for the
        Leja-Bagby rational interpolation.  Without it, poles are detected
        automatically from the AAA approximation of a scalar surrogate."""
        self._singularities = np.asarray(points, dtype=complex)
        return self

    def _nleigs_surrogate(self, samples: np.ndarray) -> np.ndarray:
        """Scalar surrogate of T on sample points (random combination of
        the split scalar functions, or a random bilinear form of T)."""
        rng = np.random.default_rng(1)
        if self.split_f:
            coeffs_r = rng.standard_normal(len(self.split_f))
            return np.sum([cr * np.asarray([f.eval(s) for s in samples])
                           for cr, f in zip(coeffs_r, self.split_f)], axis=0)
        n = self.n
        u = _vec(rng.standard_normal(n) + 0j, self.device).to(self.cdtype)
        v = rng.standard_normal(n)
        return np.array([v @ _np(self.T(s).mult(u)) for s in samples])

    def _solve_nleigs(self, rg=None):
        """NLEIGS (reference: src/nep/impls/nleigs/nleigs.c; Guettel, Van
        Beeumen, Meerbergen, Michiels, SISC 2014): rational interpolation
        of T on Leja-Bagby nodes s_j (target set) with poles xi_j
        (singularity set), T(lam) ~ Q_d(lam) = sum_j D_j b_j(lam) in the
        rational Newton basis b_{j+1}(z) = b_j(z)(z-s_j)/(beta_{j+1}
        (1-z/xi_j)); the d*n companion-with-poles linearization is solved
        by shift-invert Arnoldi at sigma=target with ONE factorization of
        Q_d(sigma).  The default keeps the Krylov basis compact
        (``nep/nleigs_toar.py``); ``nleigs_full_basis`` runs EPS on the
        d*n shell, its apply on device tensors of d*n entries."""
        from ..rg.rg import RGEllipse

        rg = rg or getattr(self, "rg", None)
        if rg is None:
            rg = RGEllipse(center=self.target,
                           radius=max(abs(self.target) * 0.5, 1.0))
        self.rg = rg
        c = complex(getattr(rg, "center", self.target))
        sigma = complex(self.target)
        n = self.n
        dev = self.device
        ddmaxit = 100  # LBPOINTS (reference nleigs.h:16)
        ddtol = max(self.tol / 10.0, 1e-14)

        # --- discretize target boundary and singularity set ---
        ds, _w = rg.contour(128)
        ds = np.asarray(ds, dtype=complex)
        dxi = getattr(self, "_singularities", None)
        self.nleigs_poles = None
        if dxi is None:
            dxi = _aaa_singularities(self, ds)
            self.nleigs_poles = "no AAA" if dxi is _NO_AAA else \
                (0 if dxi is None else len(dxi))
            if dxi is _NO_AAA:
                dxi = None
        dxi = np.asarray(dxi, dtype=complex) if dxi is not None else \
            np.zeros(0, dtype=complex)

        # --- Leja-Bagby points / poles / scalings ---
        s, xi, beta = _leja_bagby(ds, dxi, ddmaxit)

        # --- rational divided differences (split or dense callback) ---
        if self.split_f:
            nt = len(self.split_f)
            fvals = np.array([[complex(f.eval(sk)) for f in self.split_f]
                              for sk in s])  # (ddmaxit, nt)
            coeffD = np.zeros((ddmaxit, nt), dtype=complex)
            coeffD[0] = fvals[0] * beta[0]
            norm0 = np.abs(coeffD[0]).max()
            nmat = ddmaxit
            for k in range(1, ddmaxit):
                b = _rational_basis(s, xi, beta, k, s[k])
                coeffD[k] = (fvals[k] - b[:k] @ coeffD[:k]) / b[k]
                if k > 1 and np.abs(coeffD[k]).max() / norm0 < ddtol:
                    nmat = k + 1
                    break
            Dmats = None
        else:
            if n > 2048:
                # matrix divided differences need explicit D_j; keep the
                # matrix-free Newton path for very large callback problems
                self._solve_newton(improve="slp")
                return
            Td = [self._dense_T(s[0])]
            Dmats = [Td[0] * beta[0]]
            norm0 = np.linalg.norm(Dmats[0], np.inf)
            nmat = ddmaxit
            for k in range(1, ddmaxit):
                b = _rational_basis(s, xi, beta, k, s[k])
                Dk = self._dense_T(s[k])
                for j in range(k):
                    Dk = Dk - b[j] * Dmats[j]
                Dmats.append(Dk / b[k])
                if k > 1 and np.linalg.norm(Dmats[k], np.inf) / norm0 < ddtol:
                    nmat = k + 1
                    break
            Dmats = Dmats[:nmat]
            coeffD = None
        d = nmat - 1  # linearization degree
        self.nleigs_degree = d

        if d < 2:
            # interpolant is (near-)linear: plain Newton is exact
            self._solve_newton(improve="slp")
            return

        # --- Q_d(sigma) and its factorization (the only n x n solve) ---
        bsig = _rational_basis(s, xi, beta, d, sigma)
        lu = ksp = None
        if coeffD is not None:
            alph = bsig @ coeffD[:nmat]  # (nt,)
            Nsig = SumOperator(tuple(self.split_A),
                               tuple(complex(a) for a in alph))
            ksp = direct_ksp(Nsig)
        else:
            import scipy.linalg as sla

            lu = sla.lu_factor(sum(bj * Dj for bj, Dj in zip(bsig, Dmats)))

        # inf pole => no pole: beta/xi -> 0 and (1 - sigma/xi) -> 1
        b_over_xi = np.array([0.0 if np.isinf(xi[j]) else beta[j + 1] / xi[j]
                              for j in range(d)], dtype=complex)
        one_m_sx = np.array([1.0 if np.isinf(xi[j]) else 1.0 - sigma / xi[j]
                             for j in range(d)], dtype=complex)

        if not getattr(self, "nleigs_full_basis", False):
            # DEFAULT: compact TOAR-style basis -- memory per Krylov vector
            # independent of the interpolation degree d (reference
            # nleigs.c default; nleigs-fullb.c is the full-basis OPTION,
            # nep.nleigs_full_basis = True / -nep_nleigs_full_basis)
            from .nleigs_toar import nleigs_toar_krylov

            nleigs_toar_krylov(
                self, sigma=sigma, d=d, beta=beta, s=s, bsig=bsig,
                b_over_xi=b_over_xi, one_m_sx=one_m_sx, coeffD=coeffD,
                Dmats=Dmats, ksp=ksp, lu=lu, rg=rg, center=c)
            return

        cdt = self.cdtype
        if coeffD is not None:
            # q's combinations: row i of C^T [w_0 .. w_{d-2}, z_{d-1}/beta_d]
            # is sum_j coeffD[j, i] w_j + coeffD[d, i] z_{d-1}/beta_d (K4)
            combo = _vec(np.vstack([coeffD[: d - 1], coeffD[d: d + 1]]),
                         dev).to(cdt)

        def shinv_apply(zflat):
            """w = (A - sigma B)^{-1} B z on the d*n linearization:
            backward substitution through the companion-with-poles block
            rows, then one Q_d(sigma) solve for the rational-basis
            component (reference NEPTOARExtendBasis semantics)."""
            Z = zflat.reshape(d, n)
            Wb = [None] * (d - 1)
            # last block row (D_d truncation folded into the first row)
            Wb[d - 2] = (Z[d - 2] + complex(b_over_xi[d - 2]) * Z[d - 1]) \
                / complex(s[d - 2] - sigma)
            for k in range(d - 2, 0, -1):
                Wb[k - 1] = (Z[k - 1] + complex(b_over_xi[k - 1]) * Z[k]
                             - complex(beta[k] * one_m_sx[k - 1]) * Wb[k]) \
                    / complex(s[k - 1] - sigma)
            # q = sum_j D_j w_j + D_d z_{d-1}/beta_d  (first block row)
            zlast = Z[d - 1] / float(beta[d])
            if coeffD is not None:
                Vc = rotate(combo, torch.stack(Wb + [zlast]))
                q = None
                for i, Ai in enumerate(self.split_A):
                    t = Ai.mult(Vc[i])
                    q = t if q is None else q + t
                t_new = -ksp.solve(q)
            else:
                import scipy.linalg as sla

                Zh = _np(torch.stack(Wb + [zlast]))
                q = Dmats[d] @ Zh[d - 1]
                for j in range(d - 1):
                    q = q + Dmats[j] @ Zh[j]
                t_new = _vec(-sla.lu_solve(lu, q), dev)
            # w_j += b_j(sigma) * t  (t is the new Krylov direction)
            out = [Wb[j] + complex(bsig[j]) * t_new for j in range(d - 1)]
            out.append(complex(bsig[d - 1]) * t_new)
            return torch.cat(out)

        Lop = ShellOperator((d * n, d * n), cdt, shinv_apply, device=dev)

        # --- shift-invert Arnoldi on the linearization ---
        eps = EPS(Lop, problem_type=ProblemType.NHEP, nev=self.nev + 2,
                  which=Which.LARGEST_MAGNITUDE)
        eps.set_tolerances(tol=max(self.tol * 1e-2, 1e-13),
                           max_it=self.max_it)
        eps.solve()
        self.its = eps.its

        found = []
        for i in range(eps.nconv):
            th, zvec = eps.get_eigenpair(i)
            th = complex(th)
            if abs(th) < 1e-300:
                continue
            lam = sigma + 1.0 / th
            x = zvec[:n]
            nx = float(torch.linalg.vector_norm(x))
            if nx < 1e-12:
                continue
            x = x / nx
            # polish on the true T (interpolation error -> full precision)
            for _ in range(10):
                e = self._residual(lam, x)
                if e < self.tol:
                    break
                lam, x = _nep_newton_step(self, lam, x)
            e = self._residual(complex(lam), x)
            if e < max(self.tol * 100, 1e-8) and rg.check_inside(lam) >= 0:
                if all(abs(lam - f[0]) > 1e-8 * max(1, abs(lam))
                       for f in found):
                    found.append((complex(lam), e, x))
        found.sort(key=lambda t: abs(t[0] - c))
        self._set_results([t[0] for t in found], [t[1] for t in found],
                          [t[2] for t in found])
        self.nconv = len(found)

    def refine(self, steps: int = 3):
        """Newton iterative refinement of converged pairs (reference:
        NEPSetRefine simple scheme, interface/neprefine.c): the bordered
        dense solves of PEP's ``_bordered_newton_refine`` on the host
        (n <= 4096), the applies on the operators' device."""
        if self.nconv == 0 or self.n > 4096:
            return self
        from ..pep.pep import _bordered_newton_refine

        dev = self.device

        def apply_T(lam, x):
            return _np(self.T(lam).mult(_vec(x, dev)))

        def apply_Tp(lam, x):
            return _np(self.Tprime(lam).mult(_vec(x, dev)))

        self.eigenvalues = self.eigenvalues.astype(complex)
        X = _np(self._eigenvectors).astype(complex)
        for i in range(self.nconv):
            lam2, x2 = _bordered_newton_refine(
                apply_T, apply_Tp, self.eigenvalues[i], X[i], steps=steps,
                solve_dense=self._dense_T)
            self.eigenvalues[i] = lam2
            X[i] = x2
            self.errests[i] = self._residual(complex(lam2), _vec(x2, dev))
        self._eigenvectors = _vec(X, dev)
        return self

    # -- results ----------------------------------------------------------
    def get_converged(self):
        return self.nconv

    def get_eigenpair(self, i: int):
        """(lambda_i, x_i) with x_i a tensor on the operators' device."""
        return self.eigenvalues[i], self._eigenvectors[i]

    def get_eigenvectors(self) -> torch.Tensor:
        """The converged eigenvectors as the reference's (n, nconv)
        columns: a transposed view of the device rows."""
        return self._eigenvectors[: self.nconv].T

    def compute_error(self, i: int) -> float:
        lam, x = self.get_eigenpair(i)
        return self._residual(complex(lam), x)


def _leja_bagby(ds: np.ndarray, dxi: np.ndarray, maxit: int):
    """Greedy Leja-Bagby node/pole selection (reference:
    NEPNLEIGSLejaBagbyPoints, nleigs.c:346): s_k maximizes |prod of scaled
    basis| over the target discretization, xi_k minimizes it over the
    singularity discretization; beta_k are the sup-norm scalings."""
    ndpt = len(ds)
    s = np.zeros(maxit, dtype=complex)
    xi = np.full(maxit, np.inf, dtype=complex)
    beta = np.ones(maxit)
    s[0] = ds[0]
    if len(dxi):
        if abs(dxi[0]) < 1e-12:
            raise ValueError("singularity point nearly zero; shift the problem")
        xi[0] = dxi[0]
    nrs = np.ones(ndpt, dtype=complex)
    nrxi = np.ones(len(dxi), dtype=complex)

    def pole_fac(z, p):  # 1 - z/p, with p=inf meaning "no pole"
        return np.ones_like(z) if np.isinf(p) else 1.0 - z / p

    for k in range(1, maxit):
        nrs = nrs * ((ds - s[k - 1]) / pole_fac(ds, xi[k - 1])) / beta[k - 1]
        imax = int(np.argmax(np.abs(nrs)))
        s[k] = ds[imax]
        beta[k] = max(np.abs(nrs[imax]), 1e-300)
        if len(dxi) > k:
            # a candidate equal to the current pole divides by zero; it
            # becomes inf and is never selected by the argmin below
            with np.errstate(divide="ignore", invalid="ignore"):
                nrxi = nrxi * ((dxi - s[k - 1])
                               / pole_fac(dxi, xi[k - 1])) / beta[k - 1]
            nrxi = np.where(np.isfinite(nrxi), nrxi, np.inf)
            imin = 1 + int(np.argmin(np.abs(nrxi[1:])))
            if abs(dxi[imin]) < 1e-12:
                raise ValueError("singularity point nearly zero; "
                                 "shift the problem")
            xi[k] = dxi[imin]
    return s, xi, beta


def _rational_basis(s, xi, beta, k: int, z: complex) -> np.ndarray:
    """b_0..b_k of the rational Newton basis at z (reference:
    NEPNLEIGSEvalNRTFunct): b_{j+1}(z)=b_j(z)(z-s_j)/(beta_{j+1}(1-z/xi_j))."""
    b = np.zeros(k + 1, dtype=complex)
    b[0] = 1.0 / beta[0]
    for i in range(k):
        pf = 1.0 if np.isinf(xi[i]) else 1.0 - z / xi[i]
        b[i + 1] = (z - s[i]) * b[i] / (beta[i + 1] * pf)
    return b


_NO_AAA = "scipy has no AAA"


def _aaa_singularities(nep: "NEP", ds: np.ndarray):
    """Automatic singularity discretization: poles of the AAA rational
    approximation of a scalar surrogate of T on the target boundary
    (reference: NEPNLEIGSAAASingularities, nleigs.c:299).  Without
    ``scipy.interpolate.AAA`` (scipy < 1.15) it returns ``_NO_AAA`` and
    the interpolation has no poles, as the reference's ImportError
    branch."""
    try:
        from scipy.interpolate import AAA
    except ImportError:
        return _NO_AAA
    vals = nep._nleigs_surrogate(ds)
    try:
        aaa = AAA(ds, vals, rtol=1e-13)
        poles = np.asarray(aaa.poles(), dtype=complex)
    except Exception:
        return None
    poles = poles[np.isfinite(poles)]
    if poles.size == 0:
        return None
    # order by distance to the target set (closest poles matter most)
    dmin = np.min(np.abs(poles[:, None] - ds[None, :]), axis=1)
    return poles[np.argsort(dmin)]


def _nep_newton_step(nep: "NEP", lam: complex, x: torch.Tensor):
    """One residual-inverse Newton step + Rayleigh-functional update: the
    dense T(lam) solved on the operators' device for n <= 2048, else a
    direct KSP on its explicit matrix.  A singular T(lam) leaves the pair
    as it is."""
    Tl = nep.T(lam)
    r = Tl.mult(x)
    try:
        if nep.n <= 2048:
            with log_event("NEP_DenseSolve", sync=True):
                dx = torch.linalg.solve(nep._dense_T_dev(lam), r)
        else:
            dx = direct_ksp(Tl).solve(r)
    except RuntimeError:  # a singular factorization (LinAlgError included)
        return lam, x
    x2 = x - dx
    nx = float(torch.linalg.vector_norm(x2))
    if nx < 1e-300:
        return lam, x
    x2 = x2 / nx
    lam2 = _rayleigh_functional(nep, lam, x2)
    return complex(lam2), x2


def _smallest_pencil_eig(nep: "NEP", Tl: LinearOperator, Tp: LinearOperator):
    """Smallest-|mu| eigenpair of T y = mu T' y: dense QZ on the host for
    n <= 2048, else EPS GNHEP at target 0 (shift-and-invert on the explicit
    T, factorized on the host)."""
    n = Tl.shape[0]
    if n <= 2048:
        import scipy.linalg as sla

        mu, Y = sla.eig(nep._dense_np(Tl), nep._dense_np(Tp))
        finite = np.isfinite(mu)
        mu, Y = mu[finite], Y[:, finite]
        j = int(np.argmin(np.abs(mu)))
        y = Y[:, j]
        return complex(mu[j]), _vec(y / np.linalg.norm(y), nep.device)
    ops = [operator_of(M, Tl.device) if M is not None else op
           for op, M in ((Tl, Tl.explicit()), (Tp, Tp.explicit()))]
    eps = EPS(*ops, problem_type=ProblemType.GNHEP, nev=1,
              which=Which.TARGET_MAGNITUDE, target=0.0)
    eps.solve()
    mu, y = eps.get_eigenpair(0)
    return complex(mu), y.to(nep.cdtype)


def _rayleigh_functional(nep: NEP, lam: complex, x: torch.Tensor,
                         maxit: int = 20) -> complex:
    """Newton on g(z) = x^H T(z) x = 0 near lam (the Rayleigh functional);
    one host read a step."""
    z = lam
    for _ in range(maxit):
        g, gp = torch.stack([torch.vdot(x, nep.T(z).mult(x)),
                             torch.vdot(x, nep.Tprime(z).mult(x))]).tolist()
        if abs(gp) < 1e-300:
            break
        dz = complex(g) / complex(gp)
        z = z - dz
        if abs(dz) < 1e-14 * max(1.0, abs(z)):
            break
    return z


def _nep_left_vector(nep: "NEP", lam: complex) -> np.ndarray:
    """Left eigenvector y: y^H T(lam) = 0, via inverse iteration on
    T(lam)^H (reference: NEP two-sided support, nepimpl.h twosided), on
    the dense host T(lam)."""
    n = nep.n
    Td = nep._dense_T(lam)
    rng = np.random.default_rng(7)
    y = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y /= np.linalg.norm(y)
    M = Td.conj().T + 1e-13 * np.eye(n)  # tiny regularization at the root
    for _ in range(5):
        try:
            y = np.linalg.solve(M, y)
        except np.linalg.LinAlgError:
            break
        y /= np.linalg.norm(y)
    return y


def _attach_two_sided(nep: "NEP") -> None:
    """Compute left eigenvectors for all converged pairs (device rows)."""
    if nep.nconv == 0 or nep.n > 4096:
        nep._left_eigenvectors = None
        return
    Y = np.stack([_nep_left_vector(nep, complex(nep.eigenvalues[i]))
                  for i in range(nep.nconv)])
    nep._left_eigenvectors = _vec(Y, nep.device).to(nep.cdtype)
