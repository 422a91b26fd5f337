"""Direct factorization backends + inertia (``slepc_tpu/ksp/direct.py``).

ST sinvert and spectrum slicing factor ``A - sigma B`` once per shift,
solve with it many times and read the matrix inertia off the factors.
Backends of :class:`DirectSolver`:

  * ``dense``: ``torch.linalg.lu_factor`` / ``lu_solve`` on the operator's
    device, for small or projected operators;
  * ``tridiag_device`` / ``btridiag_device``: the scanned (block-)
    tridiagonal LDL^T of ``ksp/tridiag_device.py``, on the operator's
    device, with inertia;
  * ``ldl``: the native host sparse LDL^T with inertia (``native/ldl.py``);
  * ``splu``: host sparse LU (scipy SuperLU).

The host backends move one vector each way per solve; the transfers are
explicit (``.cpu().numpy()`` / ``torch.from_numpy(...).to(device)``) and
logged as the events ``KSP_HostSolve_d2h`` / ``_h2d``.  PyTorch runs
eagerly, so the reference's ``pure_callback`` arms have no counterpart.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..mat.linop import (AIJOperator, DenseOperator, DIAOperator,
                          LinearOperator, apply_by_parts)
from ..sys.events import log_event
from .tridiag_device import (btridiag_inertia, btridiag_of_operator,
                             btridiag_pivots, btridiag_solve,
                             tridiag_inertia as _tridiag_inertia_device,
                             tridiag_of_operator, tridiag_pivots,
                             tridiag_solve)


class DirectSolver:
    """Factorize once, solve many times.  ``solve`` takes and returns an
    (n,) or (n, k) tensor on the operator's device."""

    def __init__(self, A: LinearOperator, backend: str = "auto"):
        self.A = A
        self.n = A.shape[0]
        self.dtype = A.dtype
        self.device = A.device
        self._td = self._btd = self._ldl = None
        if backend == "auto":
            if isinstance(A, DenseOperator):
                backend = "dense"
            elif self._is_tridiag_device():
                backend = "tridiag_device"
            elif self._is_btridiag_device():
                backend = "btridiag_device"
            elif isinstance(A, (DIAOperator, AIJOperator)):
                backend = "ldl" if self._is_symmetric_real() else "splu"
            else:
                backend = "dense" if self.n <= 4096 else "splu"
        self.backend = backend
        self._factored = False

    def _is_tridiag_device(self) -> bool:
        self._td = tridiag_of_operator(self.A)
        return self._td is not None

    def _is_btridiag_device(self) -> bool:
        self._btd = btridiag_of_operator(self.A)
        return self._btd is not None

    def _is_symmetric_real(self) -> bool:
        if self.dtype.is_complex:
            return False
        import scipy.sparse as sp

        As = self.A.to_scipy()
        if not sp.issparse(As):
            return bool(np.allclose(As, As.T, atol=1e-14))
        d = As - As.T
        return d.nnz == 0 or float(abs(d).max()) < 1e-14

    def _factor(self):
        self._factored = True
        if self.backend == "tridiag_device":
            if self._td is None:
                self._td = tridiag_of_operator(self.A)
            self._td_piv = tridiag_pivots(*self._td, 0.0)
            return
        if self.backend == "btridiag_device":
            if self._btd is None or not torch.is_tensor(self._btd[0]):
                Ab, Bb = self._btd or btridiag_of_operator(self.A)
                self._btd = tuple(
                    torch.from_numpy(M).to(self.device, self.dtype)
                    for M in (Ab, Bb))
            self._btd_piv = btridiag_pivots(*self._btd, 0.0)
            return
        if self.backend == "ldl":
            from ..native.ldl import LDLFactorization, ldl_available

            if ldl_available():
                self._ldl = LDLFactorization(self.A.to_scipy())
                neg, zero, pos = self._ldl.inertia()
                if zero == 0 and (neg == 0 or pos == 0):
                    return  # definite: unpivoted LDL^T solve is stable
                # indefinite (or singular leading minors): without 2x2
                # Bunch-Kaufman pivoting the LDL^T solve amplifies error;
                # keep the factor for INERTIA only (the slicing primitive)
                # and solve through LU
            self.backend = "splu"  # degrade the solve path
        if self.backend == "dense":
            Ad = self.A.A if isinstance(self.A, DenseOperator) \
                else self.A.to_dense()
            self._lu, self._piv, info = torch.linalg.lu_factor_ex(Ad)
            if int(info) != 0:  # one host read per factorization
                raise RuntimeError(
                    f"dense LU: the matrix is singular (zero pivot "
                    f"{int(info)})")
        elif self.backend == "splu":
            import scipy.sparse as sp
            import scipy.sparse.linalg as spla

            self._splu = spla.splu(sp.csc_matrix(self.A.to_scipy()))
        else:
            raise ValueError(f"unknown direct backend {self.backend}")

    def _host_solve(self, b: torch.Tensor, fn) -> torch.Tensor:
        """One host solve: device -> host, ``fn`` on numpy, host -> device."""
        with log_event("KSP_HostSolve_d2h"):
            b_np = b.detach().cpu().numpy()
        x = fn(b_np)
        with log_event("KSP_HostSolve_h2d"):
            return torch.from_numpy(np.ascontiguousarray(x)).to(b.device)

    def _splu_solve(self, b_np, trans="N"):
        x = self._splu.solve(b_np.astype(self._splu.U.dtype, copy=False),
                             trans=trans)
        if np.iscomplexobj(x) and not np.iscomplexobj(b_np):
            return x  # complex factor, real rhs: keep the complex result
        return x.astype(b_np.dtype, copy=False)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        if not self._factored:
            self._factor()
        if b.is_complex() and not self.dtype.is_complex:
            # a real factor and a complex right-hand side: two real solves
            return apply_by_parts(self.solve, b, self.dtype)
        if self.backend == "tridiag_device":
            return tridiag_solve(*self._td, 0.0, b.to(self.dtype),
                                 pivots=self._td_piv)
        if self.backend == "btridiag_device":
            if b.dim() == 2:  # the block solve takes one vector at a time
                return torch.stack([self.solve(b[:, j])
                                    for j in range(b.shape[1])], dim=1)
            return btridiag_solve(*self._btd, 0.0, b.to(self.dtype),
                                  pivots=self._btd_piv)
        if self.backend == "dense":
            vec = b.dim() == 1
            x = torch.linalg.lu_solve(self._lu, self._piv,
                                      b[:, None] if vec else b)
            return x[:, 0] if vec else x
        if self.backend == "ldl":
            return self._host_solve(
                b, lambda b_np: self._ldl.solve(
                    np.asarray(b_np, dtype=np.float64)).astype(
                        b_np.dtype, copy=False))
        return self._host_solve(b, self._splu_solve)

    def solve_h(self, b: torch.Tensor) -> torch.Tensor:
        """Solve A^H x = b."""
        if not self._factored:
            self._factor()
        if self.backend in ("ldl", "tridiag_device", "btridiag_device"):
            return self.solve(b)  # symmetric factorization
        if b.is_complex() and not self.dtype.is_complex:
            return apply_by_parts(self.solve_h, b, self.dtype)
        if self.backend == "dense":
            vec = b.dim() == 1
            x = torch.linalg.lu_solve(self._lu, self._piv,
                                      b[:, None] if vec else b, adjoint=True)
            return x[:, 0] if vec else x
        return self._host_solve(b, lambda b_np: self._splu_solve(b_np, "H"))

    def inertia(self) -> Tuple[int, int, int]:
        """(n_neg, n_zero, n_pos) for the symmetric operator."""
        if self.backend in ("tridiag_device", "btridiag_device"):
            if not self._factored:
                self._factor()
            if self.backend == "tridiag_device":
                neg = int(_tridiag_inertia_device(*self._td, 0.0))
            else:
                neg = int(btridiag_inertia(*self._btd, 0.0,
                                           pivots=self._btd_piv))
            return neg, 0, self.n - neg
        if isinstance(self.A, DIAOperator) and set(self.A.offsets) <= {-1, 0, 1}:
            offs = self.A.offsets
            d = self.A.diags[offs.index(0)].cpu().numpy()
            e = self.A.diags[offs.index(1)].cpu().numpy()[:-1] if 1 in offs \
                else np.zeros(self.n - 1)
            return tridiag_inertia(d, e)
        if self.backend == "ldl" and not self._factored:
            self._factor()
        if self._ldl is not None:
            return self._ldl.inertia()
        import scipy.sparse as sp

        As = self.A.to_scipy()
        if sp.issparse(As):
            if self._is_symmetric_real():
                from ..native.ldl import LDLFactorization, ldl_available

                if ldl_available():
                    return LDLFactorization(As).inertia()
            bw = _bandwidth(As)
            if bw <= 64:
                return banded_ldlt_inertia(As, bw)
            As = As.toarray()
        w = np.linalg.eigvalsh(0.5 * (As + As.conj().T))
        tol = np.finfo(float).eps * max(1.0, np.abs(w).max()) * self.n
        return (int(np.sum(w < -tol)), int(np.sum(np.abs(w) <= tol)),
                int(np.sum(w > tol)))


def tridiag_inertia(d: np.ndarray, e: np.ndarray) -> Tuple[int, int, int]:
    """Inertia of a Hermitian tridiagonal matrix by the LDL^H / Sturm
    recurrence on the host: q_1 = Re d_1, q_i = Re d_i - |e_{i-1}|^2 /
    q_{i-1} (a complex Hermitian matrix has a real diagonal; its pivots are
    real).  The reference squares e and compares a complex pivot with 0
    (``slepc_tpu/ksp/direct.py:261-277``), which miscounts a complex
    matrix."""
    d = np.real(np.asarray(d))
    e2 = np.abs(np.asarray(e)) ** 2
    n = len(d)
    neg = zero = pos = 0
    q = 0.0
    tiny = np.finfo(float).tiny
    for i in range(n):
        q = d[i] - (e2[i - 1] / q if i > 0 else 0.0)
        if q == 0.0:
            zero += 1
            q = tiny  # perturb past the singularity
        elif q < 0:
            neg += 1
        else:
            pos += 1
    return neg, zero, pos


def banded_ldlt_inertia(A, bw: int) -> Tuple[int, int, int]:
    """Inertia of a Hermitian banded matrix via unpivoted banded LDL^H on
    the host, on a band of A's dtype: the pivots are real (their real
    parts) and the update takes the conjugate of the column, so a complex
    Hermitian A counts its own inertia (the reference writes A into a real
    band, ``slepc_tpu/ksp/direct.py:296``, and counts Re(A)'s).  Adequate
    for the definite-shifted matrices slicing produces; a zero pivot is
    counted and perturbed."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    band = np.zeros((bw + 1, n), dtype=np.result_type(A.dtype, np.float64))
    Ac = A.tocoo()  # band[i - j, j] = A[i, j], lower part
    lower = (Ac.row - Ac.col >= 0) & (Ac.row - Ac.col <= bw)
    band[(Ac.row - Ac.col)[lower], Ac.col[lower]] = Ac.data[lower]
    neg = zero = pos = 0
    tiny = np.finfo(float).tiny
    for k in range(n):
        piv = float(np.real(band[0, k]))
        if piv == 0.0:
            zero += 1
            piv = tiny
        elif piv < 0:
            neg += 1
        else:
            pos += 1
        lim = min(bw, n - 1 - k)
        if lim > 0:
            col = band[1: lim + 1, k] / piv  # L[k+1..k+lim, k]
            for r in range(lim):
                # column j = k+1+r: A[j+s, j] -= L[j+s,k] piv conj(L[j,k])
                band[: lim - r, k + 1 + r] -= np.conj(col[r]) * \
                    band[r + 1: lim + 1, k]
            band[1: lim + 1, k] = col  # store L
    return neg, zero, pos


def _bandwidth(A) -> int:
    import scipy.sparse as sp

    Ac = sp.coo_matrix(A)
    if Ac.nnz == 0:
        return 0
    return int(np.max(np.abs(Ac.row - Ac.col)))
