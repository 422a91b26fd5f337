"""ST -- spectral transformations (``slepc_tpu/st/st.py``).

The object holding the problem matrices {A_i}, the shift sigma and a KSP,
presenting solvers with the transformed operator (``op()``) and undoing the
transform on eigenvalues (``back_transform``).  The transformed operator is
a composition of LinearOperators on the matrices' device; the linear solves
inside it are a direct factorization (``ksp/direct.py``: on the device for
dense, tridiagonal and banded matrices, on the host otherwise) or an
iterative KSP.  The device iterative tier is ``st/sinvert_jit.py``; the
polynomial filter ``STFilter`` (interior eigenvalues by SpMVs alone) is
``st/filter.py``.  A complex operator, or a complex shift of a real one,
makes the transformed operator complex: the host-direct factors are
complex (scipy's LU), the iterative KSPs run in complex arithmetic, and
the solvers work in the promoted dtype (``op().dtype``).  There are no
structured transforms: GHIEP runs through these STs with B as an
indefinite metric, and BSE applies its operator with the metric alone
(``eps/bse.py``, a shift that does no B-solve).

Where the reference quietly falls back to an iterative KSP when the direct
route raises (``slepc_tpu/st/st.py:107-108``), the port goes iterative only
for an operator without an explicit matrix (a shell) and lets a failed
factorization raise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ksp.ksp import KSP, _jacobi_precond
from ..mat.linop import (AIJOperator, DenseOperator, DIAOperator,
                         IdentityOperator, LinearOperator, ShellOperator,
                         SumOperator, _with_coeffs, as_operand)


class ST:
    """Base spectral transformation.

    Holds matrices [A] (standard) or [A, B] (generalized).  ``op()``
    returns the transformed operator the Krylov loop multiplies by;
    ``back_transform`` maps transformed eigenvalues back.
    """

    name = "shell"
    requires_rayleigh = False

    def __init__(self, matrices: Sequence[LinearOperator], sigma: complex = 0.0,
                 ksp_opts: Optional[dict] = None):
        self.mats: List[LinearOperator] = list(matrices)
        self.sigma = sigma
        self.ksp_opts = dict(ksp_opts or {})
        self._op: Optional[LinearOperator] = None
        self.ksp: Optional[KSP] = None
        self.nullspace: Optional[torch.Tensor] = None

    # ---- shared helpers --------------------------------------------------
    @property
    def A(self) -> LinearOperator:
        return self.mats[0]

    @property
    def B(self) -> Optional[LinearOperator]:
        return self.mats[1] if len(self.mats) > 1 else None

    def set_shift(self, sigma: complex) -> None:
        if sigma != self.sigma:
            self.sigma = sigma
            self._op = None
            self.ksp = None

    def _identity(self) -> IdentityOperator:
        return IdentityOperator(self.A.shape[0], self.A.dtype, self.A.device)

    def _shifted_operator(self, sigma) -> LinearOperator:
        """A - sigma*B (or A - sigma*I) as a composable operator."""
        if sigma == 0:
            return self.A
        B = self.B if self.B is not None else self._identity()
        return SumOperator((self.A, B), (1.0, -sigma))

    def _has_explicit_matrix(self) -> bool:
        explicit = (AIJOperator, DenseOperator, DIAOperator)
        return all(isinstance(M, explicit) for M in self.mats)

    def _shifted_explicit(self, sigma, keep_dia: bool = False) -> LinearOperator:
        """A - sigma*B with an explicit matrix, for direct factorization:
        a CSR or dense operator built from the host scipy matrix (the host
        LDL^T / LU tier).  With ``keep_dia`` (spectrum slicing), a real DIA
        A with no or a diagonal B keeps its DIA structure, so a tridiagonal
        or banded operator takes the unpivoted device factorizations of
        ``ksp/tridiag_device.py``."""
        import scipy.sparse as sp

        A, B = self.A, self.B
        if (keep_dia and isinstance(A, DIAOperator)
                and not A.dtype.is_complex and np.imag(sigma) == 0
                and 0 in A.offsets
                and (B is None or (isinstance(B, DIAOperator)
                                   and B.offsets == (0,)))):
            dd = A.diags.clone()
            dd[A.offsets.index(0)] -= float(np.real(sigma)) * (
                1.0 if B is None else B.diags[0])
            return DIAOperator(A.offsets, dd, shape=A.shape)
        As = A.to_scipy()
        n = A.shape[0]
        if sigma == 0:
            S = As
        elif B is not None:
            S = As - sigma * B.to_scipy()
        elif sp.issparse(As):
            S = As - sigma * sp.eye(n, dtype=As.dtype, format="csr")
        else:
            S = As - sigma * np.eye(n, dtype=As.dtype)
        if sp.issparse(S):
            return AIJOperator.from_scipy(sp.csr_matrix(S), device=A.device)
        return DenseOperator(np.asarray(S), device=A.device)

    def _make_ksp(self, sigma, hermitian=False) -> KSP:
        """KSP on (A - sigma*B).  Default: direct factorization of the
        explicit matrix; 'ksp_type' in ksp_opts selects an iterative method
        instead, and an operator without an explicit matrix (a shell) takes
        cg / bicgstab."""
        opts = dict(self.ksp_opts)
        method = opts.pop("ksp_type", "direct")
        if method == "direct":
            if self._has_explicit_matrix():
                return KSP(self._shifted_explicit(sigma), method="direct",
                           hermitian=hermitian, **opts)
            method = "cg" if hermitian else "bicgstab"
        return KSP(self._shifted_operator(sigma), method=method,
                   hermitian=hermitian, **opts)

    def _op_dtype(self) -> torch.dtype:
        """The transformed operator's dtype: the matrices', complex when a
        shift (or Cayley's nu) is."""
        dt = self.A.dtype
        if self.B is not None:
            dt = torch.promote_types(dt, self.B.dtype)
        return _with_coeffs(dt, (self.sigma, getattr(self, "nu", 0.0)))

    def _shell(self, mv, rmv=None, nnz=None) -> ShellOperator:
        n = self.A.shape[0]
        return ShellOperator((n, n), self._op_dtype(), mv, rmv, nnz=nnz,
                             device=self.A.device)

    # ---- interface -------------------------------------------------------
    def op(self) -> LinearOperator:
        if self._op is None:
            self._op = self._compute_operator()
        return self._op

    def apply(self, x):
        op = self.op()
        if not torch.is_tensor(x):
            x = as_operand(x, f"{type(self).__name__}.apply", op.dtype,
                           op.device, op.shape[1])
        return op.mult(x)

    def _compute_operator(self) -> LinearOperator:
        raise NotImplementedError

    def back_transform(self, eigs: np.ndarray) -> np.ndarray:
        return eigs

    def eig_map(self, lam: np.ndarray) -> np.ndarray:
        """Forward map original -> transformed spectrum."""
        return lam

    def get_bilinear(self) -> Optional[LinearOperator]:
        """Inner-product matrix for the solver's BV (B for GHEP)."""
        return None

    def check_null_space(self, vectors) -> int:
        """Test deflation-space vectors (the columns of an (n, c) array, or
        one (n,) vector) for membership in the nullspace of A - sigma*B;
        passing vectors are attached to the KSP as a nullspace so singular
        pencils solve cleanly.  Returns the number found."""
        V = np.asarray(vectors.detach().cpu() if torch.is_tensor(vectors)
                       else vectors)
        if V.ndim == 1:
            V = V[:, None]
        S = self._shifted_operator(self.sigma)
        dev, dt = self.A.device, self.A.dtype
        norms = np.array([float(torch.linalg.vector_norm(S.mult(
            torch.from_numpy(np.ascontiguousarray(V[:, j])).to(dev, dt))))
            for j in range(V.shape[1])])
        vnorms = np.linalg.norm(V, axis=0)
        tolzero = 10.0 * np.sqrt(float(torch.finfo(dt).eps))
        keep = norms < tolzero * np.maximum(vnorms, 1e-300)
        c = int(np.sum(keep))
        if c == 0:
            self.nullspace = None
            return 0
        Nq, _ = np.linalg.qr(V[:, keep])  # orthonormal nullspace basis
        self.nullspace = torch.from_numpy(np.ascontiguousarray(Nq)).to(dev, dt)
        if self.ksp is None:
            self.op()  # builds the KSP for factorizing transforms
        if self.ksp is not None:
            self.ksp.set_nullspace(self.nullspace)
        return c


class STShift(ST):
    """Op = A - sigma I (standard) / B^{-1}(A - sigma B) (generalized);
    lambda = theta + sigma."""

    name = "shift"

    def _compute_operator(self) -> LinearOperator:
        S = self._shifted_operator(self.sigma)
        if self.B is None:
            return S
        opts = dict(self.ksp_opts)
        method = opts.pop("ksp_type", "direct")
        ksp = self.ksp = KSP(self.B, method=method, hermitian=True, **opts)
        rmv = (lambda x: S.mult_h(ksp.solve_h(x))) if method == "direct" \
            else None
        return self._shell(lambda x: ksp.solve(S.mult(x)), rmv,
                           nnz=self.A.nnz + self.B.nnz)

    def back_transform(self, eigs):
        return np.asarray(eigs) + self.sigma

    def eig_map(self, lam):
        return lam - self.sigma


class STSinvert(ST):
    """Shift-and-invert: Op = (A - sigma B)^{-1} B (generalized) or
    (A - sigma I)^{-1} (standard); lambda = 1/theta + sigma."""

    name = "sinvert"

    def __init__(self, matrices, sigma: complex = 0.0, ksp_opts=None,
                 hermitian: bool = False, ksp=None):
        super().__init__(matrices, sigma, ksp_opts)
        self.hermitian = hermitian
        # prebuilt KSP: spectrum slicing reuses ONE factorization per shift
        # for both inertia and the sinvert solves
        self._ksp_prebuilt = ksp

    def _compute_operator(self) -> LinearOperator:
        ksp = self._ksp_prebuilt if self._ksp_prebuilt is not None else \
            self._make_ksp(self.sigma,
                           hermitian=self.hermitian and self.B is None)
        self.ksp = ksp
        B = self.B
        direct = ksp.method == "direct"
        if B is None:
            mv, rmv = ksp.solve, (ksp.solve_h if direct else None)
        else:
            mv = lambda x: ksp.solve(B.mult(x))
            rmv = (lambda x: B.mult_h(ksp.solve_h(x))) if direct else None
        return self._shell(mv, rmv, nnz=self.A.nnz + (B.nnz if B else 0))

    def back_transform(self, eigs):
        return 1.0 / np.asarray(eigs) + self.sigma

    def eig_map(self, lam):
        return 1.0 / (lam - self.sigma)


class STCayley(ST):
    """Op = (A - sigma B)^{-1} (A + nu B);
    lambda = (sigma*theta + nu) / (theta - 1)."""

    name = "cayley"

    def __init__(self, matrices, sigma: complex = 0.0,
                 nu: Optional[complex] = None, ksp_opts=None):
        super().__init__(matrices, sigma, ksp_opts)
        self.nu = nu if nu is not None else sigma

    def _compute_operator(self) -> LinearOperator:
        ksp = self.ksp = self._make_ksp(self.sigma)
        B = self.B if self.B is not None else self._identity()
        M = SumOperator((self.A, B), (1.0, self.nu))
        return self._shell(lambda x: ksp.solve(M.mult(x)),
                           nnz=2 * self.A.nnz)

    def back_transform(self, eigs):
        eigs = np.asarray(eigs)
        return (self.sigma * eigs + self.nu) / (eigs - 1.0)

    def eig_map(self, lam):
        return (lam + self.nu) / (lam - self.sigma)


class STPrecond(ST):
    """No transform; only supplies a preconditioner to preconditioned
    eigensolvers."""

    name = "precond"

    def _compute_operator(self) -> LinearOperator:
        return self.A

    def preconditioner(self, sigma: Optional[complex] = None):
        """Approximate inverse of (A - sigma B) as a closure."""
        sig = self.sigma if sigma is None else sigma
        if sig != 0 and self._has_explicit_matrix():
            # the diagonal of the explicit A - sigma B (at sigma 0, A's own:
            # no host round trip)
            M = _jacobi_precond(self._shifted_explicit(sig))
        else:
            M = _jacobi_precond(self._shifted_operator(sig))
        return M if M is not None else (lambda x: x)


class STShell(ST):
    """User-defined transform: ``apply_fn`` takes and returns (n,) tensors
    on the matrices' device."""

    name = "shellst"

    def __init__(self, matrices, apply_fn, backtransform_fn=None, sigma=0.0,
                 apply_trans_fn=None):
        super().__init__(matrices, sigma)
        self._apply_fn = apply_fn
        self._bt = backtransform_fn
        self._apply_trans = apply_trans_fn

    def _compute_operator(self) -> LinearOperator:
        return self._shell(self._apply_fn, self._apply_trans)

    def back_transform(self, eigs):
        return self._bt(eigs) if self._bt is not None else eigs
