"""MFN -- action of a matrix function: y = f(A) b (``slepc_tpu/mfn/mfn.py``).

Reference: src/mfn/ -- MFNSolve (interface/mfnsolve.c:81) with solvers
'krylov' (restarted Arnoldi with the Eiermann-Ernst accumulated-Hessenberg
restart, impls/krylov/mfnkrylov.c:42-127) and 'expokit' (phi-padded
exponential action, impls/expokit/mfnexpokit.c).

Per restart: the Arnoldi extension of ``bv/krylov.py`` on the operator's
device (its SpMV kernel, CGS2 on kernel K3) into a row basis; f evaluated
on the small accumulated Hessenberg on the host (the DS/FN tier); the
update ``V_m^T coeff`` is one kernel-K4 rotation at (m, 1) (two, for the
real and imaginary parts of complex coefficients on a real basis).  Besides
the Arnoldi loop's own reads, a restart reads the host once: the update's
norm and the accumulated solution's, together.

The result is a tensor on the operator's device (the reference returns a
JAX array); ``b`` given as numpy goes to the operator's device.  The work
type is the operator's, promoted to complex when ``b`` or the function's
scale is complex.

Where the port differs from slepc_tpu: ``expokit`` steps by |T| in the
direction T/|T| of the time scale T = alpha (the reference steps by T
itself, so a negative scale ran exp(+|T| A) while its clock ran backwards,
returning NaN with ``CONVERGED_TOL``, and a complex scale raised on a
complex comparison); and after an Arnoldi breakdown (an invariant
subspace, where the step is exact for any length) it takes the rest of
the interval in that step, where the reference stopped short of it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..bv.krylov import arnoldi_extend
from ..eps.base import basis_combine
from ..fn.fn import FN, FNExp
from ..mat.linop import LinearOperator
from ..sys.options import apply_module_options


class MFNConvergedReason:
    CONVERGED_TOL = 1
    CONVERGED_ITS = 2
    DIVERGED_ITS = -1
    ITERATING = 0


def _work_dtype(A: LinearOperator, b, *scales) -> torch.dtype:
    """A's dtype, promoted to complex by a complex b or scale."""
    dt = A.dtype
    cplx = (b.is_complex() if torch.is_tensor(b) else np.iscomplexobj(b)) \
        or any(np.imag(s) != 0 for s in scales)
    if cplx and not dt.is_complex:
        dt = torch.promote_types(dt, torch.complex64)
    return dt


def _vector(b, A: LinearOperator, dtype: torch.dtype) -> torch.Tensor:
    """b as a flat tensor of ``dtype`` on A's device."""
    if not torch.is_tensor(b):
        b = torch.from_numpy(np.ascontiguousarray(np.asarray(b)))
    return b.reshape(-1).to(A.device, dtype)


class MFN:
    """y = f(A) b via restarted Krylov approximation."""

    def __init__(self, A: Optional[LinearOperator] = None, fn: Optional[FN] = None,
                 ncv: int = 30, tol: Optional[float] = None, max_it: int = 100,
                 solver: str = "krylov"):
        """solver: 'krylov' (Eiermann-Ernst restarts; any FN) or 'expokit'
        (exp-specialized: adaptive substeps with the phi-function error
        estimate -- reference impls/expokit/mfnexpokit.c)."""
        self.A = A
        self.fn = fn if fn is not None else FNExp()
        self.ncv = ncv
        self.tol = tol
        self.max_it = max_it
        self.solver = solver
        self.its = 0
        self.reason = MFNConvergedReason.ITERATING
        self._options()

    def _options(self):
        apply_module_options(self, "mfn_", int_keys=("ncv", "max_it"),
                             float_keys=("tol",), str_keys=("type",))

    def set_operator(self, A: LinearOperator):
        self.A = A
        return self

    def set_fn(self, fn: FN):
        self.fn = fn
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

    def _default_tol(self, dtype: torch.dtype):
        if self.tol is None:
            self.tol = 1e-8 if dtype in (torch.float64, torch.complex128) \
                else 1e-5

    def solve(self, b, x=None) -> torch.Tensor:
        """Compute y = f(A) b (reference MFNSolve semantics: restarted
        Arnoldi, convergence when the restart update norm falls below tol
        -- the Eiermann-Ernst criterion, mfnkrylov.c:110)."""
        if self.solver == "expokit" and isinstance(self.fn, FNExp):
            return self._solve_expokit(b)
        return self._solve_krylov(b)

    def _arnoldi(self, v: torch.Tensor, m: int):
        """m Arnoldi steps from the unit vector v: the (m + 1, n) row basis,
        the host Hessenberg's leading (m, m) block, beta = |H[m, m-1]| and
        the breakdown flag."""
        V = torch.zeros((m + 1, v.shape[0]), dtype=v.dtype, device=v.device)
        V[0] = v
        H = np.zeros((m + 1, m), dtype=complex if v.is_complex() else float)
        V, H, beta, brk = arnoldi_extend(self.A, V, H, 0, m, nc=0)
        return V, H[:m, :m], float(beta), bool(brk)

    def _solve_expokit(self, b) -> torch.Tensor:
        """Exp-specialized time-stepping (reference mfnexpokit.c / EXPOKIT
        dgexpv): y = beta * exp(alpha A) b via adaptive substeps
        y <- exp(tau s A) y with s = alpha / |alpha| and tau > 0, each a
        fixed-dimension Krylov approximation with the phi-augmented
        Hessenberg supplying the local error estimate."""
        import scipy.linalg as sla

        A = self.A
        n = A.shape[0]
        T = self.fn.alpha  # total "time" (inner scale)
        outer = self.fn.beta
        dtype = _work_dtype(A, b, T)
        self._default_tol(dtype)
        m = min(self.ncv, n, 30)
        T_abs = abs(T)
        sgn = T / T_abs if T_abs > 0 else 1.0  # the direction of the step
        y = _vector(b, A, dtype)
        t_done = 0.0
        tau = T_abs  # try one step first; adapt down on error
        self.its = 0
        self.reason = MFNConvergedReason.ITERATING
        self._options()
        while t_done < T_abs * (1 - 1e-14):
            self.its += 1
            if self.its > self.max_it:
                self.reason = MFNConvergedReason.DIVERGED_ITS
                break
            beta0 = float(torch.linalg.vector_norm(y))
            if beta0 == 0:
                break
            V, Hm, hb, brk = self._arnoldi(y / beta0, m)
            if brk:
                # an invariant subspace: the step is exact for any length
                tau = T_abs - t_done
            cplx = np.iscomplexobj(Hm) or np.imag(sgn) != 0
            while True:
                # phi-augmented: Hbar = [[tau s H, e1],[0, 0]] (size m+1)
                Hbar = np.zeros((m + 1, m + 1), dtype=complex if cplx else float)
                Hbar[:m, :m] = (sgn * tau) * Hm
                Hbar[0, m] = 1.0
                F = sla.expm(Hbar)
                w = F[:m, 0]
                err_loc = abs(beta0 * hb * tau * F[m - 1, m])
                if brk or err_loc <= self.tol * max(beta0, 1e-300) * max(
                        tau / T_abs, 1e-14) or tau < 1e-12 * T_abs:
                    break
                tau *= 0.5
            y = beta0 * basis_combine(V[:m], w[:, None])[0]
            t_done += tau
            tau = min(2 * tau, T_abs - t_done) if T_abs - t_done > 0 else tau
            if T_abs - t_done <= 1e-14 * T_abs:
                self.reason = MFNConvergedReason.CONVERGED_TOL
                break
        return outer * y

    def _solve_krylov(self, b) -> torch.Tensor:
        A = self.A
        n = A.shape[0]
        dtype = _work_dtype(A, b)
        self._default_tol(dtype)
        m = min(self.ncv, n)
        b = _vector(b, A, dtype)
        beta0 = float(torch.linalg.vector_norm(b))
        if beta0 == 0.0:
            self.reason = MFNConvergedReason.CONVERGED_TOL
            return torch.zeros_like(b)
        v = b / beta0
        x_acc = None
        Htot = np.zeros((0, 0), dtype=complex if dtype.is_complex else float)
        beta_prev = 0.0
        self.its = 0
        self.reason = MFNConvergedReason.ITERATING
        self._options()

        for restart in range(self.max_it):
            self.its += 1
            V, Hm, beta, brk = self._arnoldi(v, m)

            # accumulate: Htot <- [[Htot, 0]; [beta_prev e1 e_last^T, Hm]]
            p = Htot.shape[0]
            Hnew = np.zeros((p + m, p + m), dtype=Htot.dtype)
            Hnew[:p, :p] = Htot
            Hnew[p:, p:] = Hm
            if p > 0:
                Hnew[p, p - 1] = beta_prev
            Htot = Hnew

            F = self.fn.eval_mat(Htot)
            coeff = beta0 * F[p: p + m, 0]
            upd = basis_combine(V[:m], coeff[:, None])[0]
            x_acc = upd if x_acc is None else x_acc + upd
            # one host read: the update's norm and the solution's
            err, ref = torch.stack([torch.linalg.vector_norm(upd),
                                    torch.linalg.vector_norm(x_acc)]).tolist()
            if err <= self.tol * max(ref, 1e-300) or brk \
                    or beta < 1e-14 * beta0:
                self.reason = MFNConvergedReason.CONVERGED_TOL
                break
            beta_prev = beta
            v = V[m]
        else:
            self.reason = MFNConvergedReason.DIVERGED_ITS
        return x_acc
