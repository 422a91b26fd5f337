"""DS -- dense projected solvers (``slepc_tpu/ds/types.py``).

Host-side classes over numpy / LAPACK, as in the reference: the small
(ncv x ncv) projected problem of each outer iteration is solved on the
host.  Ported: :class:`DS` (registry), :class:`DSHEP` (with the block
divide-and-conquer of ``ds/bdc.py`` behind ``solve_block_tridiag``),
:class:`DSGHEP` (the Hermitian Krylov-Schur loop), :class:`DSNHEP` (real or
complex Schur form, ``ds/schur.py``), :class:`DSNHEPTS` (right and left
pairs, two-sided), :class:`DSGHIEP` (the symmetric / signature pencil of
pseudo-Lanczos, by the hyperbolic-Jacobi stand-in for the HZ iteration,
:func:`_hz_hyperbolic_jacobi`), :class:`DSGNHEP` (ordered QZ) and the SVD
types of the SVD module, :class:`DSSVD`, :class:`DSHSVD` and
:class:`DSGSVD`, and :class:`DSPEP` (the projected polynomial problem of
PEP's Jacobi-Davidson).  The nonlinear type ``DSNEP`` waits for its solver
(ROADMAP.md, queue 1, item 15).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import scipy.linalg as sla

from . import schur as _schur


class DS:
    """Base: registry + common helpers."""

    registry = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        DS.registry[cls.__name__.lower().replace("ds", "", 1)] = cls

    @staticmethod
    def create(name: str) -> "DS":
        return DS.registry[name.lower()]()


class DSHEP(DS):
    """Hermitian eigenproblem: full diagonalization of the projected H.
    The Schur form is diagonal, so 'truncate' / 'sort' are column
    selections."""

    def solve(self, H: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        H = np.asarray(H)
        return np.linalg.eigh(0.5 * (H + H.conj().T))

    def solve_tridiag(self, alpha: np.ndarray, beta: np.ndarray):
        """Tridiagonal fast path (steqr analog); LAPACK's divide and
        conquer (stevd) for large projected problems."""
        return sla.eigh_tridiagonal(
            alpha, beta,
            lapack_driver="stevd" if len(alpha) >= 256 else "auto")

    def solve_block_tridiag(self, Ds, Es, tau: float = 0.0,
                            force: bool = False):
        """Symmetric block-tridiagonal projected problem (diagonal blocks
        Ds, subdiagonal blocks Es), the blocked-Lanczos DS shape: the block
        divide-and-conquer with deflation (``ds/bdc.py``) when ``force`` or
        a truncation ``tau`` > 0 asks for it, else a dense eigh (LAPACK's
        dsyevd wins for full-rank couplings at DS sizes)."""
        from .bdc import bdc_eig, block_tridiag_dense

        if force or tau > 0.0:
            return bdc_eig(Ds, Es, tau=tau)
        return np.linalg.eigh(block_tridiag_dense(Ds, Es))

    def sort(self, w, Q, keys):
        perm = np.argsort(np.asarray(keys), kind="stable")
        return w[perm], Q[:, perm]


class DSGHEP(DS):
    """Generalized Hermitian (A, B) with B > 0: sygvd analog."""

    def solve(self, A: np.ndarray, B: np.ndarray):
        w, X = sla.eigh(0.5 * (A + A.conj().T), 0.5 * (B + B.conj().T))
        return w, X  # X^H B X = I


class DSNHEP(DS):
    """Non-Hermitian: Hessenberg -> (real / complex) Schur form, sorted by
    keys, eigenvectors from the Schur form (gehrd / hseqr / trexc /
    trevc analog)."""

    def solve(self, H: np.ndarray):
        return _schur.schur(H)  # (T, Q, eigs)

    def sort(self, T, Q, keys):
        return _schur.sort_schur(T, Q, keys)

    def vectors(self, T, Q):
        return _schur.schur_eigvectors(T, Q)  # (eigs, X)


class DSNHEPTS(DS):
    """NHEP with left eigenvectors (two-sided): right pairs from the Schur
    form of A, left from that of A^H, matched by eigenvalue (each right
    lambda takes the unused left value nearest conj(lambda))."""

    def solve(self, A: np.ndarray):
        T, Q, _ = _schur.schur(A)
        w, X = _schur.schur_eigvectors(T, Q)
        Tl, Ql, _ = _schur.schur(np.asarray(A).conj().T)
        wl, Y = _schur.schur_eigvectors(Tl, Ql)
        return w, X, Y[:, match_conj(w, wl)]


def match_conj(w_right, w_left) -> np.ndarray:
    """pick with w_left[pick[i]] the unused left value nearest
    conj(w_right[i]), taken in the order of w_right."""
    w_left = np.asarray(w_left)
    used = np.zeros(len(w_left), bool)
    pick = np.zeros(len(w_right), int)
    for i, lam in enumerate(np.asarray(w_right)):
        j = int(np.argmin(np.abs(w_left - np.conj(lam))
                          + np.where(used, np.inf, 0.0)))
        used[j] = True
        pick[i] = j
    return pick


def _hz_hyperbolic_jacobi(T: np.ndarray, omega: np.ndarray,
                          max_sweeps: int = 30, tol: float = 1e-14):
    """The HZ iteration's role for the real symmetric / signature pencil
    (T, Omega), Omega = diag(+-1): one-sided trigonometric-hyperbolic
    Jacobi (Veselic).  It accumulates an Omega-orthogonal G (G^T Omega G =
    Omega) with G^T T G diagonal: same-sign index pairs take Givens
    rotations, opposite-sign pairs hyperbolic ones, so the signature is
    kept exactly and the eigenvectors come out Omega-orthonormal.

    Needs T definite (the definite-type GHIEP regime): then every
    hyperbolic pivot has |2 T_ij| < T_ii + T_jj and the sweeps converge
    quadratically; an indefinite T (complex pairs possible) stops with
    converged=False.  Returns (w, G, converged), w real with T g = w Omega
    g."""
    A = np.array(T, dtype=float, copy=True)
    n = A.shape[0]
    om = np.asarray(omega).real
    G = np.eye(n)
    nrm0 = max(np.linalg.norm(A, "fro"), 1e-300)

    def off_norm():
        return np.sqrt(max(np.linalg.norm(A, "fro") ** 2
                           - np.linalg.norm(np.diag(A)) ** 2, 0.0))

    for _ in range(max_sweeps):
        if off_norm() <= tol * nrm0:
            return np.diag(A) * om, G, True
        for i in range(n - 1):
            for j in range(i + 1, n):
                aij = A[i, j]
                if abs(aij) <= 1e-30:
                    continue
                aii, ajj = A[i, i], A[j, j]
                if om[i] == om[j]:  # trigonometric: symmetric Jacobi
                    tau = (ajj - aii) / (2.0 * aij)
                    t = np.sign(tau) / (abs(tau) + np.hypot(1.0, tau)) \
                        if tau != 0 else 1.0
                    c = 1.0 / np.sqrt(1.0 + t * t)
                    s = t * c
                    R = np.array([[c, s], [-s, c]])
                else:
                    # hyperbolic [[ch, sh], [sh, ch]] (Omega-orthogonal for
                    # opposite signs): tanh(2y) = -2 aij / (aii + ajj)
                    den = aii + ajj
                    if abs(2.0 * aij) >= abs(den):
                        return np.diag(A) * om, G, False
                    th2 = -2.0 * aij / den
                    t = th2 / (1.0 + np.sqrt(1.0 - th2 * th2))  # tanh(y)
                    ch = 1.0 / np.sqrt(1.0 - t * t)
                    R = np.array([[ch, t * ch], [t * ch, ch]])
                idx = [i, j]
                A[idx, :] = R.T @ A[idx, :]
                A[:, idx] = A[:, idx] @ R
                G[:, idx] = G[:, idx] @ R
    return np.diag(A) * om, G, off_norm() <= 1e-8 * nrm0


class DSGHIEP(DS):
    """Generalized Hermitian-indefinite: T x = lambda Omega x with Omega =
    diag(+-1), the pseudo-Lanczos projected problem.  A real symmetric T
    of one sign solves by the hyperbolic-Jacobi stand-in for the HZ
    iteration (:func:`_hz_hyperbolic_jacobi`: real values, Omega-orthonormal
    vectors); any other pencil (or a Jacobi breakdown) by eig(Omega T) with
    each vector Omega-normalized, real when every value is."""

    def solve(self, T: np.ndarray, omega: np.ndarray):
        T = np.asarray(T)
        omega = np.asarray(omega).real
        if not np.iscomplexobj(T):
            Ts = 0.5 * (T + T.T)
            if np.allclose(T, Ts, rtol=1e-12, atol=1e-14):
                sgn = 0  # the sign of T, if it has one
                for s in (1, -1):
                    try:
                        np.linalg.cholesky(s * Ts + 1e-14 * np.eye(len(Ts)))
                        sgn = s
                        break
                    except np.linalg.LinAlgError:
                        pass
                if sgn:
                    w, G, ok = _hz_hyperbolic_jacobi(sgn * Ts, omega)
                    if ok:
                        w = sgn * w
                        order = np.argsort(w)
                        return w[order], G[:, order]
        w, X = np.linalg.eig(omega[:, None] * T)  # Omega T
        for j in range(X.shape[1]):  # x^H Omega x = +-1 where possible
            s = np.real(X[:, j].conj() @ (omega * X[:, j]))
            if abs(s) > np.finfo(float).eps:
                X[:, j] /= np.sqrt(abs(s))
        if np.all(np.abs(w.imag) <= 1e-12 * (1 + np.abs(w.real))):
            w = w.real
            X = X.real if not np.iscomplexobj(T) else X
        return w, X


class DSGNHEP(DS):
    """Generalized non-Hermitian (A, B) by the ordered QZ form (gges /
    tgexc analog); wanted-first is largest magnitude unless ``keys_fn``
    says otherwise."""

    def solve(self, A: np.ndarray, B: np.ndarray,
              keys_fn: Optional[Callable] = None):
        if keys_fn is None:
            keys_fn = lambda ev: -np.abs(ev)
        return _schur.ordered_qz(np.asarray(A), np.asarray(B), keys_fn)

    def vectors(self, S, T, Q, Z):
        """Right eigenvectors of (A, B) from the QZ form: X = Z Y."""
        lam, Y = sla.eig(S, T)
        X = Z @ Y
        nrm = np.linalg.norm(X, axis=0)
        nrm[nrm == 0] = 1
        return lam, X / nrm


class DSSVD(DS):
    """(Bi)diagonal/dense SVD of the projected matrix (gesdd analog)."""

    def solve(self, Bmat: np.ndarray):
        U, s, Vh = np.linalg.svd(np.asarray(Bmat), full_matrices=False)
        return U, s, Vh

    def solve_bidiag(self, alpha: np.ndarray, beta: np.ndarray):
        """Upper-bidiagonal [alpha; superdiag beta] SVD."""
        m = len(alpha)
        B = np.diag(alpha).astype(float)
        for i in range(m - 1):
            B[i, i + 1] = beta[i]
        return self.solve(B)


class DSHSVD(DS):
    """Hyperbolic SVD: A = U Sigma V^H with U^H Omega U = Omega-hat.

    Reference: impls/hsvd/dshsvd.c.  Functional route: eigendecompose
    A^H Omega A (Hermitian, possibly indefinite); sigma = sqrt|lambda|,
    signature from sign(lambda).
    """

    def solve(self, A: np.ndarray, omega: np.ndarray):
        A = np.asarray(A)
        omega = np.asarray(omega).real
        M = A.conj().T @ (omega[:, None] * A)
        lam, V = np.linalg.eigh(0.5 * (M + M.conj().T))
        # descending by |lambda|
        order = np.argsort(-np.abs(lam), kind="stable")
        lam, V = lam[order], V[:, order]
        sigma = np.sqrt(np.abs(lam))
        signs = np.where(lam >= 0, 1.0, -1.0)
        U = np.zeros((A.shape[0], len(sigma)), dtype=A.dtype)
        for j in range(len(sigma)):
            if sigma[j] > 1e-300:
                U[:, j] = A @ V[:, j] / (signs[j] * sigma[j])
        return U, sigma, V.conj().T, signs


class DSGSVD(DS):
    """Generalized SVD of the pair (A, B): A = U C X^-1, B = V S X^-1.

    Reference: impls/gsvd/dsgsvd.c (ggsvd-style).  Functional route via the
    eigen-pencil (A^H A, B^H B) — adequate for the projected sizes used by
    the TRLanczos GSVD solver.
    """

    def solve(self, A: np.ndarray, B: np.ndarray):
        A, B = np.asarray(A), np.asarray(B)
        GA = A.conj().T @ A
        GB = B.conj().T @ B
        # regularize B-gram for the pencil solve
        lam, X = sla.eigh(0.5 * (GA + GA.conj().T),
                          0.5 * (GB + GB.conj().T) + 1e-14 * np.eye(GB.shape[0]))
        order = np.argsort(-lam, kind="stable")
        lam, X = lam[order], X[:, order]
        sigma = np.sqrt(np.maximum(lam, 0.0))  # sigma = c/s
        U = A @ X
        V = B @ X
        for M in (U, V):
            nrm = np.linalg.norm(M, axis=0)
            nrm[nrm == 0] = 1
            M /= nrm
        return U, sigma, V, X


class DSPEP(DS):
    """Polynomial eigenproblem P(lambda) = sum_i lambda^i E_i on the
    projected matrices -- solved on the companion linearization
    (reference: impls/pep/dspep.c, QZ on the d*ld linearization)."""

    def solve(self, coeffs):
        coeffs = [np.asarray(c) for c in coeffs]
        d = len(coeffs) - 1
        k = coeffs[0].shape[0]
        dt = np.result_type(*[c.dtype for c in coeffs])
        # companion pencil (A0 + lambda B0) of size d*k
        A = np.zeros((d * k, d * k), dtype=dt)
        B = np.eye(d * k, dtype=dt)
        for i in range(d - 1):
            A[i * k: (i + 1) * k, (i + 1) * k: (i + 2) * k] = np.eye(k)
        for i in range(d):
            A[(d - 1) * k:, i * k: (i + 1) * k] = -coeffs[i]
        B[(d - 1) * k:, (d - 1) * k:] = coeffs[d]
        lam, X = sla.eig(A, B)
        # eigenvectors of P: leading k block, normalized
        Xp = X[:k, :]
        nrm = np.linalg.norm(Xp, axis=0)
        nrm[nrm == 0] = 1
        return lam, Xp / nrm
