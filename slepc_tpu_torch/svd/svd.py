"""SVD -- singular value decomposition solvers (``slepc_tpu/svd/svd.py``).

Solvers, with the reference's names:

  * ``cross``: EPS on the cross product A^H A (or A A^H when A has more
    columns than rows), a :class:`ShellOperator` on A's device whose apply
    is A's own ``mult`` and ``mult_h`` (K1/K2 on DIA, K6 on CSR, and the
    complex instantiations), through the port's EPS fast path;
  * ``cyclic``: EPS on H = [0 A; A^H 0] (eigenvalues +-sigma);
  * ``trlanczos`` / ``lanczos``: the thick-restart Golub-Kahan
    bidiagonalization of ``svd/trlanczos.py`` on device bases (K3, K4);
  * ``randomized``: the Halko-Martinsson-Tropp sketch, its block products on
    A's kernels, its QR and small SVD library calls as in the reference;
  * ``lapack``: the dense SVD of A on the host;
  * the GSVD of a pair (A, B): the cross pencil (A^H A, B^H B) through EPS
    GHEP, or for ``trlanczos`` the joint bidiagonalization of
    ``svd/trlanczos.py``; the HSVD with a signature ``omega``: EPS on
    A^H Omega A.

Results (``sigma``, ``U``, ``V``, ``X``, ``sign``, ``errests``) are host
numpy arrays, as the reference's; ``compute_error`` applies A and A^H on
the operator's device.  Options ``-svd_nsv``, ``-svd_ncv``,
``-svd_max_it``, ``-svd_tol`` and ``-svd_type`` are read at construction.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from ..eps.base import EPS, ProblemType, op_mult_block
from ..mat.linop import LinearOperator, ShellOperator
from ..sys.options import apply_module_options
from ..sys.sort import Which


class SVDWhich(enum.Enum):
    LARGEST = "largest"
    SMALLEST = "smallest"


def _tensor(x, op: LinearOperator) -> torch.Tensor:
    """A host array as a tensor on ``op``'s device, in its dtype."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(op.device, op.dtype)


def _mult_h_rows(op: LinearOperator, X: torch.Tensor) -> torch.Tensor:
    """op^H applied to each row of X, one ``mult_h`` a row."""
    return torch.stack([op.mult_h(X[i]) for i in range(X.shape[0])]) \
        if X.shape[0] else X.new_empty((0, op.shape[1]))


def _host_cols(X: torch.Tensor) -> np.ndarray:
    """Device rows (k, n) as the reference's host columns (n, k)."""
    return np.ascontiguousarray(X.cpu().numpy().T)


def _scaled_cols(M: np.ndarray, s: np.ndarray) -> np.ndarray:
    return M / np.where(s > 1e-300, s, 1.0)


class SVD:
    """Partial SVD: A ~ U diag(sigma) V^H."""

    def __init__(self, A: Optional[LinearOperator] = None, *,
                 nsv: int = 1, ncv: Optional[int] = None,
                 which: str | SVDWhich = SVDWhich.LARGEST,
                 tol: Optional[float] = None, max_it: Optional[int] = None,
                 solver: str = "trlanczos", B: Optional[LinearOperator] = None,
                 omega: Optional[np.ndarray] = None):
        self.A = A
        self.B = B  # GSVD second matrix
        self.omega = omega  # HSVD signature
        self.nsv = nsv
        self.ncv = ncv
        self.which = SVDWhich(which) if isinstance(which, str) else which
        self.tol = tol
        self.max_it = max_it
        self.solver = solver
        self.nconv = 0
        self.its = 0
        self.sigma = np.array([])
        self.U: Optional[np.ndarray] = None
        self.V: Optional[np.ndarray] = None
        apply_module_options(self, "svd_", int_keys=("nsv", "ncv", "max_it"),
                             float_keys=("tol",), str_keys=("type",))

    def set_operator(self, A, B=None):
        self.A = A
        self.B = B
        return self

    def set_dimensions(self, nsv=None, ncv=None):
        if nsv is not None:
            self.nsv = nsv
        if ncv is not None:
            self.ncv = ncv
        return self

    def set_which(self, which):
        self.which = SVDWhich(which) if isinstance(which, str) else which
        return self

    def set_type(self, name: str):
        self.solver = name
        return self

    def set_tolerances(self, tol=None, max_it=None):
        if tol is not None:
            self.tol = tol
        if max_it is not None:
            self.max_it = max_it
        return self

    def solve(self):
        if self.B is not None:
            if self.solver in ("trlanczos", "lanczos"):
                from .trlanczos import gsvd_jbd_solve

                gsvd_jbd_solve(self)
            else:
                self._solve_gsvd()
        elif self.omega is not None:
            self._solve_hsvd()
        elif self.solver == "cross":
            self._solve_cross()
        elif self.solver == "cyclic":
            self._solve_cyclic()
        elif self.solver in ("trlanczos", "lanczos"):
            from .trlanczos import trlanczos_solve

            trlanczos_solve(self)
        elif self.solver == "randomized":
            self._solve_randomized()
        elif self.solver == "lapack":
            self._solve_lapack()
        else:
            raise ValueError(f"unknown SVD solver {self.solver!r}")
        return self

    def _eps(self, op, B=None, problem_type=ProblemType.HEP, which=None):
        eps = EPS(op, B, problem_type=problem_type,
                  which=which or self._eps_which(), nev=self.nsv,
                  ncv=self.ncv, tol=self.tol, max_it=self.max_it)
        eps.solve()
        self.its = eps.its
        return eps

    def _eps_which(self):
        return Which.LARGEST_REAL if self.which == SVDWhich.LARGEST \
            else Which.SMALLEST_MAGNITUDE

    def _solve_gsvd(self):
        """Generalized SVD of (A, B): sigma from the pencil (A^H A, B^H B)
        through the EPS GHEP engine on shell cross operators (the
        reference's cross-pencil route); U = A X and V = B X with unit
        columns, X the (non-orthogonal) right vectors."""
        A, B = self.A, self.B
        n = A.shape[1]

        def mvA(x):
            return A.mult_h(A.mult(x))

        def mvB(x):
            return B.mult_h(B.mult(x))

        opA = ShellOperator((n, n), A.dtype, mvA, mvA, nnz=2 * A.nnz,
                            device=A.device)
        opB = ShellOperator((n, n), B.dtype, mvB, mvB, nnz=2 * B.nnz,
                            device=B.device)
        eps = self._eps(opA, opB, ProblemType.GHEP)
        k = self.nconv = eps.nconv
        lam = np.maximum(np.real(eps.eigenvalues[:k]), 0.0)
        self.sigma = np.sqrt(lam)  # sigma = c/s (A-part over B-part)
        X = eps.get_eigenvectors().T
        if X.is_complex() and not A.dtype.is_complex:
            X = X.real
        X = X.to(A.dtype).contiguous()
        U = _host_cols(op_mult_block(A, X))
        V = _host_cols(op_mult_block(B, X))
        for M in (U, V):
            nrm = np.linalg.norm(M, axis=0)
            nrm[nrm == 0] = 1
            M /= nrm
        self.U, self.V = U, V
        self.X = _host_cols(X)

    def _solve_hsvd(self):
        """Hyperbolic SVD: A = U Sigma V^H with U^H Omega U = Omega-hat,
        through EPS on the Omega-weighted cross operator A^H Omega A
        (Hermitian indefinite)."""
        A = self.A
        m, n = A.shape
        om = torch.from_numpy(np.asarray(self.omega, dtype=float)).to(
            A.device, A.dtype.to_real() if A.dtype.is_complex else A.dtype)

        def mv(x):
            return A.mult_h(om * A.mult(x))

        op = ShellOperator((n, n), A.dtype, mv, mv, nnz=2 * A.nnz,
                           device=A.device)
        which = (Which.LARGEST_MAGNITUDE if self.which == SVDWhich.LARGEST
                 else Which.SMALLEST_MAGNITUDE)
        eps = self._eps(op, which=which)
        k = self.nconv = eps.nconv
        lam = np.real(eps.eigenvalues[:k])
        self.sigma = np.sqrt(np.abs(lam))
        self.sign = np.where(lam >= 0, 1.0, -1.0)  # signature Omega-hat
        X = eps.get_eigenvectors().T.contiguous()
        self.V = _host_cols(X)
        AV = _host_cols(op_mult_block(A, X))
        denom = np.where(self.sigma > 1e-300, self.sign * self.sigma, 1.0)
        self.U = AV / denom

    # -- results ----------------------------------------------------------
    def get_converged(self):
        return self.nconv

    def get_singular_triplet(self, i: int):
        return self.sigma[i], self.U[:, i], self.V[:, i]

    def compute_error(self, i: int) -> float:
        """sqrt(||A v - s u||^2 + ||A^H u - s v||^2) / s, with A and A^H
        applied on the operator's device."""
        s, u, v = self.get_singular_triplet(i)
        u, v = _tensor(u, self.A), _tensor(v, self.A)
        r1 = self.A.mult(v) - float(s) * u
        r2 = self.A.mult_h(u) - float(s) * v
        num = float(torch.sqrt(torch.linalg.vector_norm(r1) ** 2
                               + torch.linalg.vector_norm(r2) ** 2))
        return num / max(float(s), 1e-300)

    # -- solvers ----------------------------------------------------------
    def _solve_cross(self):
        """EPS on the cross-product operator A^H A (A A^H when A is wide);
        the other side's vectors are A v / sigma (A^H u / sigma)."""
        A = self.A
        m, n = A.shape
        use_ata = n <= m
        dim = n if use_ata else m

        def mv(x):
            return A.mult_h(A.mult(x)) if use_ata else A.mult(A.mult_h(x))

        op = ShellOperator((dim, dim), A.dtype, mv, mv, nnz=2 * A.nnz,
                           device=A.device)
        eps = self._eps(op)
        k = self.nconv = eps.nconv
        lam = np.maximum(np.real(eps.eigenvalues[:k]), 0.0)
        self.sigma = np.sqrt(lam)
        X = eps.get_eigenvectors().T
        if X.is_complex() and not A.dtype.is_complex:
            X = X.real
        X = X.contiguous()
        if use_ata:
            self.V = _host_cols(X)
            self.U = _scaled_cols(_host_cols(op_mult_block(A, X)), self.sigma)
        else:
            self.U = _host_cols(X)
            self.V = _scaled_cols(_host_cols(_mult_h_rows(A, X)), self.sigma)
        self._renormalize()

    def _solve_cyclic(self):
        """EPS on H = [0 A; A^H 0]: eigenvalues +-sigma, eigenvectors
        (u; v) / sqrt 2."""
        A = self.A
        m, n = A.shape

        def mv(x):
            return torch.cat([A.mult(x[m:]), A.mult_h(x[:m])])

        op = ShellOperator((m + n, m + n), A.dtype, mv, mv, nnz=2 * A.nnz,
                           device=A.device)
        eps = self._eps(op)
        lam = np.real(eps.eigenvalues[: eps.nconv])
        X = _host_cols(eps.get_eigenvectors().T)
        pos = lam > 0
        lam, X = lam[pos], X[:, pos]
        order = np.argsort(-lam) if self.which == SVDWhich.LARGEST \
            else np.argsort(lam)
        lam, X = lam[order], X[:, order]
        k = min(self.nsv, len(lam))
        self.nconv = k
        self.sigma = lam[:k]
        self.U = X[:m, :k] * np.sqrt(2.0)
        self.V = X[m:, :k] * np.sqrt(2.0)
        self._renormalize()

    def _solve_randomized(self):
        """Halko-Martinsson-Tropp randomized SVD: a Gaussian start block
        from default_rng(0), two power iterations, the block products on
        A's kernels (rows of the port's layout), the QR and the small SVD
        library calls, as in the reference."""
        A = self.A
        m, n = A.shape
        k = self.nsv
        p = min(2 * k + 10, min(m, n))
        rng = np.random.default_rng(0)
        Om = _tensor(rng.standard_normal((n, p)).T, A)  # (p, n) rows
        Y = op_mult_block(A, Om)
        for _ in range(2):  # power iterations for accuracy
            Q = torch.linalg.qr(Y.T).Q
            Y = op_mult_block(A, _mult_h_rows(A, Q.T.contiguous()))
        Q = torch.linalg.qr(Y.T).Q  # (m, p)
        Bsmall = _mult_h_rows(A, Q.T.contiguous()).conj().cpu().numpy()
        Ub, s, Vh = np.linalg.svd(Bsmall, full_matrices=False)
        U = Q.cpu().numpy() @ Ub
        self.nconv = k
        self.its = 1
        self.sigma = s[:k]
        self.U = U[:, :k]
        self.V = Vh[:k, :].conj().T
        self._renormalize()

    def _solve_lapack(self):
        A = self.A.to_dense().cpu().numpy()
        U, s, Vh = np.linalg.svd(A, full_matrices=False)
        if self.which == SVDWhich.SMALLEST:
            U, s, Vh = U[:, ::-1], s[::-1], Vh[::-1, :]
        k = min(self.nsv, len(s))
        self.nconv = k
        self.its = 1
        self.sigma = s[:k]
        self.U, self.V = U[:, :k], Vh[:k, :].conj().T

    def _renormalize(self):
        if self.U is not None and self.U.size:
            self.U = np.array(self.U, copy=True)
            self.V = np.array(self.V, copy=True)
            for M in (self.U, self.V):
                nrm = np.linalg.norm(M, axis=0)
                nrm[nrm == 0] = 1
                M /= nrm
