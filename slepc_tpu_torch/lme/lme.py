"""LME -- linear matrix equations with low-rank right-hand sides
(``slepc_tpu/lme/lme.py``).

Reference: src/lme/ -- A X + X A^H + C = 0 (Lyapunov; also Sylvester /
Stein / generalized Lyapunov, include/slepclme.h:52-57) with C = -C1 C1^H
low rank, solved by Krylov projection with compressed factors
(impls/krylov/lmekrylov.c:48-205) and dense kernels for small operators
(interface/lmedense.c -- here scipy solve_lyapunov / solve_sylvester).

The result is returned factored: X ~ Z Z^H (Lyapunov, Stein) or X ~ L R^H
(Sylvester, Krylov route), as (n, k) tensors on the operator's device --
transposed views of (k, n) row blocks, Z^T = L_Y^T V for the row basis V
of the Arnoldi loop (``bv/krylov.py``: the SpMV kernel and K3), one kernel
K4 rotation.  The projected equations and the factor of their solution Y
stay on the host (the DS tier); the dense kernels below 600 rows return
an (n, m) tensor as well.

``compute_residual`` never forms X: with S = [A Z, Z, C1] (n x (2k + r))
and the constant block permutation J = [[0, I, 0], [I, 0, 0], [0, 0, I]],
A X + X A^H + C1 C1^H = S J S^H, so its Frobenius norm is that of the
small core R_S J R_S^H of one thin QR S = Q R_S.  A Z is a block apply
(``mult_block`` on the rows of Z^T: kernel K5 for a DIA operator).

Where the port differs from slepc_tpu: the Lyapunov factor of the
projected solution symmetrizes with the conjugate transpose,
0.5 (Y + Y^H) (the reference's 0.5 (Y + Y^T) takes Re Y for a complex
operator, and its residual stalls at ~1e-4).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import scipy.linalg as sla
import torch

from ..bv.krylov import arnoldi_extend, extend_dispatch
from ..eps.base import basis_combine, op_mult_block
from ..mat.linop import AdjointOperator, LinearOperator


class LMEProblemType(enum.Enum):
    LYAPUNOV = "lyapunov"  # A X + X A^T + C C^H = 0
    SYLVESTER = "sylvester"  # A X + X B + C = 0
    GEN_LYAPUNOV = "gen_lyapunov"  # A X E^T + E X A^T + C C^H = 0
    STEIN = "stein"  # A X A^T - X + C = 0


DENSE_MAX = 600  # operators up to this size take the dense kernels


def _rows(C, n: int, device, dtype) -> torch.Tensor:
    """The columns of the right-hand side factor C ((n, r), (r, n) or
    (n,); numpy or tensor) as the rows of an (r, n) tensor."""
    if not torch.is_tensor(C):
        C = torch.from_numpy(np.ascontiguousarray(np.asarray(C)))
    C = C.to(device)
    if C.dim() == 1:
        C = C[None]
    elif C.shape[0] == n:
        C = C.T
    if C.is_complex() and not dtype.is_complex:
        dtype = torch.promote_types(dtype, C.dtype)
    return C.to(dtype).contiguous()


def _host(C) -> np.ndarray:
    return C.detach().cpu().numpy() if torch.is_tensor(C) else np.asarray(C)


def _factor_psd(Y: np.ndarray) -> np.ndarray:
    """L with Y ~ L L^H from the Hermitian part of Y, negative
    eigenvalues clipped and negligible directions dropped."""
    w, P = np.linalg.eigh(0.5 * (Y + Y.conj().T))
    w = np.maximum(w, 0.0)
    keep = np.sqrt(w) > 1e-14 * max(np.sqrt(w).max(), 1e-300)
    return (P * np.sqrt(w)[None, :])[:, keep]


def _basis(v: torch.Tensor, m: int):
    """An (m + 1, n) row basis with v / ||v|| in row 0 and its host
    Hessenberg array."""
    V = torch.zeros((m + 1, v.shape[0]), dtype=v.dtype, device=v.device)
    V[0] = v
    return V, np.zeros((m + 1, m), dtype=complex if v.is_complex() else float)


class LME:
    """Krylov projection solver for low-rank matrix equations."""

    def __init__(self, A: Optional[LinearOperator] = None, *,
                 B: Optional[LinearOperator] = None,
                 problem_type: str | LMEProblemType = LMEProblemType.LYAPUNOV,
                 ncv: int = 30, tol: Optional[float] = None, max_it: int = 100):
        self.A = A
        self.B = B
        self.problem_type = (LMEProblemType(problem_type)
                             if isinstance(problem_type, str) else problem_type)
        self.ncv = ncv
        self.tol = tol
        self.max_it = max_it
        self.its = 0
        self.errest = np.inf

    def set_coefficients(self, A: LinearOperator, B: Optional[LinearOperator] = None):
        self.A = A
        self.B = B
        return self

    def set_dimensions(self, ncv: int):
        self.ncv = ncv
        return self

    def set_tolerances(self, tol=None, max_it=None):
        if tol is not None:
            self.tol = tol
        if max_it is not None:
            self.max_it = max_it
        return self

    def _default_tol(self):
        if self.tol is None:
            self.tol = 1e-8 if self.A.dtype in (torch.float64,
                                                torch.complex128) else 1e-5

    def solve(self, C1, C2=None):
        """Solve the configured equation (reference LMESolve).

        LYAPUNOV: A X + X A^H + C1 C1^H = 0 -> returns Z, X ~ Z Z^H.
        GEN_LYAPUNOV: A X E^H + E X A^H + C1 C1^H = 0 (E = self.B) ->
          reduced to standard form with F = E^{-1}A, C~ = E^{-1}C1.
        SYLVESTER: A X + X B + C1 C2^H = 0 -> Krylov-projected two-sided
          solve for large operators (returns (L, R): X ~ L R^H) or the
          dense kernel for small ones.
        STEIN: A X A^H - X + C1 C1^H = 0 -> Krylov projection (returns Z)
          for large operators, the dense kernel for small ones.
        """
        if self.problem_type == LMEProblemType.GEN_LYAPUNOV:
            return self._solve_gen_lyapunov(C1)
        n = self.A.shape[0]
        if self.problem_type == LMEProblemType.SYLVESTER and n > DENSE_MAX:
            return self._solve_sylvester_krylov(C1, C2)
        if self.problem_type == LMEProblemType.STEIN and n > DENSE_MAX:
            return self._solve_stein_krylov(C1)
        if self.problem_type != LMEProblemType.LYAPUNOV:
            C = _host(C1)
            if C2 is not None:
                C = np.atleast_2d(C) @ np.atleast_2d(_host(C2)).conj().T
            return self._solve_dense(C)
        return self._solve_lyapunov(C1)

    def _solve_gen_lyapunov(self, C1):
        from ..ksp import KSP
        from ..mat.linop import ShellOperator

        E, A0 = self.B, self.A
        ksp = KSP(E, method="direct")
        n = A0.shape[0]
        F = ShellOperator((n, n), A0.dtype, lambda x: ksp.solve(A0.mult(x)),
                          device=A0.device)
        Crows = _rows(C1, n, A0.device, A0.dtype)
        Ct = torch.stack([ksp.solve(Crows[j]) for j in range(Crows.shape[0])])
        sub = LME(F, ncv=self.ncv, tol=self.tol, max_it=self.max_it)
        Z = sub.solve(Ct)
        self.its, self.errest = sub.its, sub.errest
        return Z

    def _solve_lyapunov(self, C1) -> torch.Tensor:
        pairs = self.lyapunov_factors(C1)
        n = self.A.shape[0]
        if not pairs:
            return torch.zeros((0, n), dtype=self.A.dtype,
                               device=self.A.device).T
        return torch.cat([basis_combine(V, L) for V, L in pairs]).T

    def lyapunov_factors(self, C1):
        """The Lyapunov solution in its Krylov form: a list of (V, L), one
        for each column of C1, with V an orthonormal (m, n) row basis on
        the operator's device and L an (m, k) host factor; the term's
        factor is Z = V^T L (``solve`` stacks the rows L^T V, one K4
        rotation each), so the thin SVD of Z is V^T times that of L."""
        A = self.A
        n = A.shape[0]
        self._default_tol()
        Crows = _rows(C1, n, A.device, A.dtype)
        cnorms = torch.linalg.vector_norm(Crows, dim=1).tolist()
        m = min(self.ncv, n)
        self.its = 0
        pairs = []
        # X = sum_j X_j with X_j solving against the rank-1 rhs c_j c_j^H
        # (linearity; cross terms of C1 C1^H vanish in the sum)
        for j, cnorm in enumerate(cnorms):
            if cnorm == 0:
                continue
            v0 = Crows[j] / cnorm
            mm = m
            for attempt in range(4):
                self.its += 1
                V, H = _basis(v0, mm)
                V, H, beta, _ = arnoldi_extend(A, V, H, 0, mm, nc=0)
                Hm = H[:mm, :mm]
                e1 = np.zeros(mm)
                e1[0] = cnorm
                # projected: Hm Y + Y Hm^H + e1 e1^T = 0
                Y = sla.solve_lyapunov(Hm, -np.outer(e1, e1))
                # residual estimate: || beta * e_m^T Y || * 2
                res = 2.0 * float(beta) * np.linalg.norm(Y[-1, :])
                self.errest = res / max(np.linalg.norm(Y), 1e-300)
                if self.errest < self.tol or mm >= n:
                    break
                mm = min(2 * mm, n)
            pairs.append((V[:mm], _factor_psd(Y)))
        return pairs

    def _solve_sylvester_krylov(self, C1, C2):
        """Two-sided Krylov projection for large Sylvester equations with
        low-rank rhs C = C1 C2^H (reference lmekrylov.c:48-199 strategy
        applied two-sided): per rank-1 term c1 c2^H build V = K_m(A, c1),
        W = K_m(B^H, c2), solve the projected Sylvester
        HA Y + Y HB^H + ||c1|| ||c2|| e1 e1^T = 0, and stop on the EXACT
        factored residual
           R = betaA v_{m+1} (e_m^T Y) W^H + (V Y e_m) betaB w_{m+1}^H
           ||R||_F = sqrt(betaA^2 ||Y[m-1,:]||^2 + betaB^2 ||Y[:,m-1]||^2)
        (both Arnoldi relations exact, the rhs lies in the bases); the
        basis doubles until the relative residual meets tol.  B^H applies
        through ``mult_h`` (the SpMV kernel on the adjoint's diagonals for
        a DIA operator).  Returns (L, R): X ~ L R^H."""
        A, Bop = self.A, self.B
        n, m2 = A.shape[0], Bop.shape[0]
        self._default_tol()
        Ar = _rows(C1, n, A.device, A.dtype)
        Br = _rows(C2, m2, Bop.device, Bop.dtype)
        n1s = torch.linalg.vector_norm(Ar, dim=1).tolist()
        n2s = torch.linalg.vector_norm(Br, dim=1).tolist()
        Bh = AdjointOperator(Bop)
        self.its = 0
        Ls, Rs = [], []
        for j in range(min(len(n1s), len(n2s))):
            n1, n2 = n1s[j], n2s[j]
            if n1 == 0 or n2 == 0:
                continue
            mdim = min(self.ncv, n, m2)
            while True:
                self.its += 1
                V, HA = _basis(Ar[j] / n1, mdim)
                W, HB = _basis(Br[j] / n2, mdim)
                V, HA, bA, _ = extend_dispatch(A, V, HA, 0, mdim)
                W, HB, bB, _ = extend_dispatch(Bh, W, HB, 0, mdim)
                Ap = HA[:mdim, :mdim]
                Bp = HB[:mdim, :mdim].conj().T  # W^H B W
                Cp = np.zeros((mdim, mdim), dtype=Ap.dtype)
                Cp[0, 0] = n1 * n2
                Y = sla.solve_sylvester(Ap, Bp, -Cp)
                res = np.hypot(float(bA) * np.linalg.norm(Y[-1, :]),
                               float(bB) * np.linalg.norm(Y[:, -1]))
                self.errest = res / max(n1 * n2, 1e-300)
                if (self.errest < self.tol or mdim >= min(n, m2)
                        or self.its >= self.max_it):
                    break
                mdim = min(2 * mdim, min(n, m2))
            Ls.append(basis_combine(V[:mdim], Y))
            Rs.append(W[:mdim])
        if not Ls:
            return (torch.zeros((0, n), dtype=A.dtype, device=A.device).T,
                    torch.zeros((0, m2), dtype=Bop.dtype,
                                device=Bop.device).T)
        return torch.cat(Ls).T, torch.cat(Rs).T

    def _solve_stein_krylov(self, C1):
        """Krylov projection for large Stein equations
        A X A^H - X + C1 C1^H = 0 (reference slepclme.h LME_STEIN; same
        lmekrylov.c projection pattern): per rhs column, V = K_m(A, c),
        projected discrete Lyapunov Hm Y Hm^H - Y + c c^T = 0, residual
        from the Arnoldi cross terms
          ||R|| <= 2 beta ||Hm Y e_m|| + beta^2 |Y[m-1,m-1]|.
        Returns Z with X ~ Z Z^H (C1 C1^H rhs keeps X PSD)."""
        A = self.A
        n = A.shape[0]
        self._default_tol()
        Crows = _rows(C1, n, A.device, A.dtype)
        cns = torch.linalg.vector_norm(Crows, dim=1).tolist()
        self.its = 0
        Zs = []
        for j, cn in enumerate(cns):
            if cn == 0:
                continue
            mdim = min(self.ncv, n)
            while True:
                self.its += 1
                V, H = _basis(Crows[j] / cn, mdim)
                V, H, beta, _ = extend_dispatch(A, V, H, 0, mdim)
                Hm = H[:mdim, :mdim]
                E = np.zeros((mdim, mdim))
                E[0, 0] = cn * cn
                Y = sla.solve_discrete_lyapunov(Hm, E)
                b = float(beta)
                res = (2.0 * b * np.linalg.norm(Hm @ Y[:, -1])
                       + b * b * abs(Y[-1, -1]))
                self.errest = res / max(cn * cn, 1e-300)
                if (self.errest < self.tol or mdim >= n
                        or self.its >= self.max_it):
                    break
                mdim = min(2 * mdim, n)
            Zs.append(basis_combine(V[:mdim], _factor_psd(Y)))
        if not Zs:
            return torch.zeros((0, n), dtype=A.dtype, device=A.device).T
        return torch.cat(Zs).T

    def _solve_dense(self, C: np.ndarray) -> torch.Tensor:
        """The dense kernels for Sylvester / Stein (small n; reference
        interface/lmedense.c), on the host; the (n, m) solution comes back
        as a tensor on the operator's device."""
        A = self.A.to_dense().cpu().numpy()
        if self.problem_type == LMEProblemType.SYLVESTER:
            X = sla.solve_sylvester(A, self.B.to_dense().cpu().numpy(), -C)
        elif self.problem_type == LMEProblemType.STEIN:
            # A X A^H - X + C = 0  -> discrete Lyapunov
            X = sla.solve_discrete_lyapunov(A, C)
        else:
            raise ValueError(self.problem_type)
        return torch.from_numpy(np.ascontiguousarray(X)).to(self.A.device)

    def compute_residual(self, Z, C1) -> float:
        """||A X + X A^H + C1 C1^H||_F / ||C1 C1^H||_F with X = Z Z^H, in
        factored form: one block apply A Z, one thin QR of the n x (2k + r)
        stack [A Z, Z, C1] on the operator's device, the norm of the small
        core; X is never formed."""
        A = self.A
        n = A.shape[0]
        Zr = _rows(Z, n, A.device, A.dtype)
        Cr = _rows(C1, n, A.device, A.dtype)
        dt = torch.promote_types(Zr.dtype, Cr.dtype)
        Zr, Cr = Zr.to(dt), Cr.to(dt)
        k, r = Zr.shape[0], Cr.shape[0]
        AZ = op_mult_block(A, Zr).to(dt)
        S = torch.cat([AZ, Zr, Cr]).T  # (n, 2k + r)
        Rs = torch.linalg.qr(S, mode="r")[1]
        p = torch.arange(2 * k + r, device=Rs.device)
        perm = torch.where(p < k, p + k, torch.where(p < 2 * k, p - k, p))
        core = Rs[:, perm] @ Rs.mH  # R_S J R_S^H
        Rc = torch.linalg.qr(Cr.T, mode="r")[1]
        num, den = torch.stack([torch.linalg.matrix_norm(core),
                                torch.linalg.matrix_norm(Rc @ Rc.mH)]).tolist()
        return num / max(den, 1e-300)
