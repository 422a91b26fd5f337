"""KSP -- linear system solves for the inner loops
(``slepc_tpu/ksp/ksp.py``).

Iterative methods (CG, MINRES, BiCGStab, restarted GMRES) are plain
functions on tensors over the operator's ``mult`` -- the reference calls
``jax.scipy.sparse.linalg`` there, outside any Pallas kernel -- with its
stopping rule ``||r|| <= max(rtol ||b||, atol)``; the SpMV inside them is
the operator's kernel.  Direct factorization lives in
:class:`~slepc_tpu_torch.ksp.direct.DirectSolver`.

``method="minres"`` runs MINRES (the reference runs CG under that name,
which breaks down on the indefinite systems MINRES is chosen for).  The
Jacobi preconditioner is not applied to MINRES: it must be positive
definite there, and the diagonal of an indefinite shifted matrix is not.
A failed bordered factorization in :meth:`KSP.set_nullspace` raises (the
reference swallows it and solves the singular system unbordered).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..mat.linop import (AIJOperator, DenseOperator, DIAOperator,
                         LinearOperator, as_operand)
from ..ops.csr import row_of_entry
from ..sys.events import log_event
from .direct import DirectSolver


def _jacobi_precond(A: LinearOperator) -> Optional[Callable]:
    """Diagonal (Jacobi) preconditioner closure from the operator's
    diagonal; None when the operator does not expose one."""
    d = None
    if isinstance(A, DenseOperator):
        d = torch.diagonal(A.A)
    elif isinstance(A, DIAOperator):
        if 0 in A.offsets:
            d = A.diags[A.offsets.index(0)][: A.shape[0]]
    elif isinstance(A, AIJOperator):
        rows = row_of_entry(A.rowptr)
        on_diag = A.cols.to(torch.int64) == rows
        d = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
        d.index_add_(0, rows[on_diag], A.vals[on_diag])
    elif A.shape[0] <= 4096:
        d = torch.diagonal(A.to_dense())
    if d is None:
        return None
    dinv = torch.where(d.abs() > 1e-300, 1.0 / d, torch.ones_like(d))
    return lambda x: dinv * x if x.dim() == 1 else dinv[:, None] * x


def _operands(where, b, x0):
    """b and x0 of a free iterative solver under the array rule: a numpy
    one goes to the device of the other when that is a tensor, else to
    :func:`resolve_device`'s."""
    like = b if torch.is_tensor(b) else x0
    dev = like.device if torch.is_tensor(like) else None
    if not torch.is_tensor(b):
        b = as_operand(b, where, None, dev, ndims=(1,))
    if x0 is not None and not torch.is_tensor(x0):
        x0 = as_operand(x0, where, b.dtype, b.device, b.shape[0])
    return b, x0


def _stop_norm(b: torch.Tensor, rtol: float, atol: float) -> float:
    return max(rtol * float(torch.linalg.vector_norm(b)), atol)


def cg(mult, b, x0=None, rtol=1e-10, atol=0.0, maxiter=1000, M=None):
    """Preconditioned conjugate gradients; stops at
    ||r|| <= max(rtol ||b||, atol) or after ``maxiter`` steps."""
    if not (torch.is_tensor(b) and (x0 is None or torch.is_tensor(x0))):
        b, x0 = _operands("cg", b, x0)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - mult(x) if x0 is not None else b.clone()
    z = M(r) if M is not None else r
    p = z.clone()
    gamma = torch.vdot(r, z)
    stop = _stop_norm(b, rtol, atol)
    for _ in range(maxiter):
        if float(torch.linalg.vector_norm(r)) <= stop:
            break
        Ap = mult(p)
        alpha = gamma / torch.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r) if M is not None else r
        gamma_new = torch.vdot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
    return x


def minres(mult, b, x0=None, rtol=1e-10, atol=0.0, maxiter=1000):
    """MINRES (Paige-Saunders) on a symmetric, possibly indefinite
    operator; |eta| is the residual norm, tested against the stopping
    rule each step."""
    if not (torch.is_tensor(b) and (x0 is None or torch.is_tensor(x0))):
        b, x0 = _operands("minres", b, x0)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - mult(x) if x0 is not None else b
    beta = float(torch.linalg.vector_norm(r))
    stop = _stop_norm(b, rtol, atol)
    if beta <= stop:
        return x
    v, v_old = r / beta, torch.zeros_like(b)
    w, w_old = torch.zeros_like(b), torch.zeros_like(b)
    eta = beta
    c = c_old = 1.0
    s = s_old = 0.0
    for _ in range(maxiter):
        Av = mult(v)
        alpha = float(torch.vdot(v, Av).real)
        r_new = Av - alpha * v - beta * v_old
        beta_new = float(torch.linalg.vector_norm(r_new))
        delta = c * alpha - c_old * s * beta
        gamma2 = s * alpha + c_old * c * beta
        epsilon = s_old * beta
        gamma1 = float(np.hypot(delta, beta_new))
        if gamma1 == 0.0:
            break
        c_new, s_new = delta / gamma1, beta_new / gamma1
        w_new = (v - gamma2 * w - epsilon * w_old) / gamma1
        x = x + (c_new * eta) * w_new
        eta = -s_new * eta
        if abs(eta) <= stop or beta_new == 0.0:
            break
        v_old, v = v, r_new / beta_new
        w_old, w = w, w_new
        c_old, c, s_old, s, beta = c, c_new, s, s_new, beta_new
    return x


def bicgstab(mult, b, x0=None, rtol=1e-10, atol=0.0, maxiter=1000, M=None):
    """Preconditioned BiCGStab (van der Vorst), same stopping rule."""
    if not (torch.is_tensor(b) and (x0 is None or torch.is_tensor(x0))):
        b, x0 = _operands("bicgstab", b, x0)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - mult(x) if x0 is not None else b.clone()
    rhat = r.clone()
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    p = q = torch.zeros_like(b)
    stop = _stop_norm(b, rtol, atol)
    prec = M if M is not None else (lambda t: t)
    for _ in range(maxiter):
        if float(torch.linalg.vector_norm(r)) <= stop:
            break
        rho_new = torch.vdot(rhat, r)
        if float(rho_new.abs()) == 0.0:
            break  # breakdown
        p = r + (rho_new / rho) * (alpha / omega) * (p - omega * q)
        phat = prec(p)
        q = mult(phat)
        alpha = rho_new / torch.vdot(rhat, q)
        s = r - alpha * q
        if float(torch.linalg.vector_norm(s)) <= stop:
            x = x + alpha * phat
            break
        shat = prec(s)
        t = mult(shat)
        omega = torch.vdot(t, s) / torch.vdot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
    return x


def gmres(mult, b, x0=None, rtol=1e-10, atol=0.0, maxiter=1000, M=None,
          restart: int = 30):
    """Left-preconditioned restarted GMRES(restart) with modified
    Gram-Schmidt; the small least-squares problem is solved on the host.
    ``maxiter`` counts restarts, as in the reference's call."""
    if not (torch.is_tensor(b) and (x0 is None or torch.is_tensor(x0))):
        b, x0 = _operands("gmres", b, x0)
    prec = M if M is not None else (lambda t: t)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    stop = _stop_norm(b, rtol, atol)
    restart = max(1, min(restart, b.shape[0]))
    for _ in range(maxiter):
        r_true = b - mult(x)
        if float(torch.linalg.vector_norm(r_true)) <= stop:
            break
        r = prec(r_true)
        beta = float(torch.linalg.vector_norm(r))
        Q = [r / beta]
        H = np.zeros((restart + 1, restart), dtype=np.complex128
                     if b.is_complex() else np.float64)
        k = 0
        for k in range(restart):
            w = prec(mult(Q[k]))
            for i in range(k + 1):
                hik = torch.vdot(Q[i], w)
                H[i, k] = hik.item()
                w = w - hik * Q[i]
            hk = float(torch.linalg.vector_norm(w))
            H[k + 1, k] = hk
            if hk <= 1e-300:
                break
            Q.append(w / hk)
        m = k + 1
        e1 = np.zeros(m + 1, dtype=H.dtype)
        e1[0] = beta
        y = np.linalg.lstsq(H[: m + 1, :m], e1, rcond=None)[0]
        for i in range(m):
            x = x + complex(y[i]) * Q[i] if b.is_complex() \
                else x + float(y[i].real) * Q[i]
    return x


_ITERATIVE = {"cg": cg, "bicgstab": bicgstab, "gmres": gmres}


class KSP:
    """A configured linear solver for a fixed operator.

    methods: 'cg', 'minres', 'bicgstab', 'gmres' (iterative, on the
             operator's device), 'preonly' (apply the preconditioner only:
             the STPRECOND path), 'direct' (factorize via DirectSolver),
             'auto' (direct when the operator is small or has an explicit
             matrix, else cg / bicgstab).
    """

    def __init__(self, A: LinearOperator, method: str = "auto",
                 pc: str = "jacobi", rtol: float = 1e-10, atol: float = 0.0,
                 maxiter: Optional[int] = None, hermitian: bool = False,
                 direct_backend: str = "auto"):
        self.A = A
        self.rtol = rtol
        self.atol = atol
        self.maxiter = maxiter if maxiter is not None \
            else min(2 * A.shape[0], 10000)
        self.hermitian = hermitian
        if method == "auto":
            method = "direct" if A.shape[0] <= 8192 or _is_directable(A) \
                else ("cg" if hermitian else "bicgstab")
        if method not in ("cg", "minres", "bicgstab", "gmres", "preonly",
                          "direct"):
            raise ValueError(f"unknown KSP method {method}")
        self.method = method
        self._direct: Optional[DirectSolver] = None
        if method == "direct":
            self._direct = DirectSolver(A, backend=direct_backend)
        self._M = _jacobi_precond(A) \
            if method != "direct" and pc == "jacobi" else None
        self._nullspace: Optional[torch.Tensor] = None
        self._bordered = None

    def solve(self, b: torch.Tensor, x0=None) -> torch.Tensor:
        """Solve A x = b; b may be (n,) or (n, k), a tensor or a numpy
        array (the array rule: it goes to the operator's device)."""
        if not torch.is_tensor(b):
            b = as_operand(b, "KSP.solve", self.A.dtype, self.A.device,
                           self.A.shape[0], axis=0, ndims=(1, 2))
        if x0 is not None and not torch.is_tensor(x0):
            x0 = as_operand(x0, "KSP.solve", b.dtype, b.device,
                            self.A.shape[1], axis=0, ndims=(b.dim(),))
        with log_event(f"KSP_Solve_{self.method}"):
            return self._solve_inner(b, x0)

    def solve_h(self, b: torch.Tensor) -> torch.Tensor:
        """Solve A^H x = b (direct factorizations only)."""
        if self._direct is None:
            raise ValueError("solve_h needs method='direct'")
        if not torch.is_tensor(b):
            b = as_operand(b, "KSP.solve_h", self.A.dtype, self.A.device,
                           self.A.shape[1], axis=0, ndims=(1, 2))
        return self._direct.solve_h(b)

    def set_nullspace(self, N) -> "KSP":
        """Attach an orthonormal nullspace basis N (n x c): right-hand
        sides and solutions are projected onto range(A).  For direct solves
        the factorization switches to the bordered system
        [[A, N], [N^H, 0]] (host LU), nonsingular when N spans the
        nullspace of A."""
        self._bordered = None
        if N is None:
            self._nullspace = None
            return self
        Nn = N.detach().cpu().numpy() if torch.is_tensor(N) else np.asarray(N)
        self._nullspace = torch.from_numpy(np.ascontiguousarray(Nn)).to(
            self.A.device, self.A.dtype)
        if self.method == "direct":
            import scipy.sparse as sp
            import scipy.sparse.linalg as spla

            As = self.A.to_scipy()
            n, c = Nn.shape
            if sp.issparse(As):
                Mb = sp.bmat([[As, sp.csc_matrix(Nn)],
                              [sp.csc_matrix(Nn.conj().T), None]],
                             format="csc")
                self._bordered = ("sparse", spla.splu(Mb), n, c)
            else:
                import scipy.linalg as sla

                Mb = np.block([[np.asarray(As), Nn],
                               [Nn.conj().T, np.zeros((c, c), As.dtype)]])
                self._bordered = ("dense", sla.lu_factor(Mb), n, c)
        return self

    def _project_nullspace(self, v):
        N = self._nullspace
        return v if N is None else v - N @ (N.mH @ v)

    def _solve_inner(self, b, x0=None):
        b = self._project_nullspace(b)
        if self._bordered is not None:
            kind, fac, n, c = self._bordered
            with log_event("KSP_HostSolve_d2h"):
                bn = b.detach().cpu().numpy()
            one_d = bn.ndim == 1
            if one_d:
                bn = bn[:, None]
            rhs = np.concatenate([bn, np.zeros((c, bn.shape[1]), bn.dtype)])
            if kind == "sparse":
                xs = fac.solve(rhs)
            else:
                import scipy.linalg as sla

                xs = sla.lu_solve(fac, rhs)
            xs = np.ascontiguousarray(xs[:n, 0] if one_d else xs[:n])
            with log_event("KSP_HostSolve_h2d"):
                return torch.from_numpy(xs).to(b.device)
        if self.method == "direct":
            return self._project_nullspace(self._direct.solve(b))
        if self.method == "preonly":
            return self._M(b) if self._M is not None else b
        if b.dim() == 2:
            cols = [self._solve_inner(b[:, j],
                                      None if x0 is None else x0[:, j])
                    for j in range(b.shape[1])]
            return torch.stack(cols, dim=1)
        kw = dict(x0=x0, rtol=self.rtol, atol=self.atol, maxiter=self.maxiter)
        if self.method == "minres":
            x = minres(self.A.mult, b, **kw)
        else:
            x = _ITERATIVE[self.method](self.A.mult, b, M=self._M, **kw)
        return self._project_nullspace(x)

    def inertia(self):
        """(n_negative, n_zero, n_positive) of the symmetric operator: the
        spectrum-slicing primitive, read off an LDL^T factorization."""
        if self._direct is None:
            self._direct = DirectSolver(self.A, backend="auto")
        return self._direct.inertia()


def _is_directable(A: LinearOperator) -> bool:
    """Operators that carry an explicit matrix."""
    return isinstance(A, (DenseOperator, DIAOperator, AIJOperator))


def solve_linear(A: LinearOperator, b, method: str = "auto", **kw):
    if not torch.is_tensor(b):
        b = as_operand(b, "solve_linear", A.dtype, A.device, A.shape[0],
                       axis=0, ndims=(1, 2))
    return KSP(A, method=method, **kw).solve(b)
