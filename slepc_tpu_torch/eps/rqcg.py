"""EPS RQCG -- Rayleigh quotient minimization by conjugate gradients
(``slepc_tpu/eps/rqcg.py``).

Reference: src/eps/impls/cg/rqcg/rqcg.c (390 LoC): nonlinear CG on the
Rayleigh quotient rho(x) = x^H A x / x^H B x for the smallest eigenvalues,
one pair after another, with a Fletcher-Reeves update, a restart to the
steepest descent every ``reset_every`` steps, an exact line search (a 2 x 2
Rayleigh-Ritz on span{x, p}) and deflation against the locked vectors.

A host loop over vectors on the operator's device: ``A.mult`` (kernel K2 /
K1 for a DIA operator, K6 for CSR) per step, the line search's pair of
products through ``mult_block`` (K5 on DIA) and its B-orthonormalization
by CholeskyQR2 (``bv/orthog.py``).  The start vectors are drawn with
numpy's ``default_rng(0)``, as the reference draws them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bv.orthog import cholqr2
from .base import EPS, EPSSolver, op_mult, op_mult_block


def _vdot_real(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.vdot(a, b).real)


class RQCG(EPSSolver):
    reset_every = 20  # reference -eps_rqcg_reset default

    def solve(self, eps: EPS) -> None:
        if not eps.is_hermitian:
            raise ValueError("rqcg requires a Hermitian problem type")
        if eps.which.value.startswith("largest"):
            raise ValueError("rqcg computes smallest eigenvalues")
        A, B = eps.A, eps.B
        n = eps.n
        dtype, device = A.dtype, A.device
        rng = np.random.default_rng(0)

        def bmult(v):
            return op_mult(B, v) if B is not None else v

        locked: list[torch.Tensor] = []
        lams: list[float] = []
        errs: list[float] = []
        eps.its = 0

        for pair in range(eps.nev):
            x = rng.standard_normal(n)
            if eps.initial_space is not None \
                    and pair < eps.initial_space.shape[1]:
                x = np.asarray(eps.initial_space[:, pair])
            xj = _deflate(torch.from_numpy(np.ascontiguousarray(x)).to(
                device, dtype), locked)
            xj = xj / np.sqrt(_vdot_real(xj, bmult(xj)))
            p = None
            g_prev = None
            rho = 0.0
            err = np.inf
            it_reset = 0
            while eps.its < eps.max_it:
                eps.its += 1
                it_reset += 1
                Ax = op_mult(A, xj)
                Bx = bmult(xj)
                rho = _vdot_real(xj, Ax) / _vdot_real(xj, Bx)
                g = _deflate(Ax - rho * Bx, locked)  # the gradient direction
                err = eps.conv_measure(rho, float(torch.linalg.vector_norm(g)))
                if err < eps.tol:
                    break
                if p is None or it_reset % self.reset_every == 0:
                    p = -g
                else:
                    beta = _vdot_real(g, g) / max(g_prev, 1e-300)  # Fletcher-Reeves
                    p = -g + beta * p
                g_prev = _vdot_real(g, g)
                # exact line search: minimize rho(x + alpha p), a 2 x 2
                # Rayleigh-Ritz on span{x, p}
                Sb = torch.stack([xj, p / torch.linalg.vector_norm(p)])
                Sb, _ = cholqr2(Sb, bmult if B is not None else None)
                G = (Sb.conj() @ op_mult_block(A, Sb).T).cpu().numpy()
                _, C = np.linalg.eigh(0.5 * (G + G.conj().T))
                xj = torch.from_numpy(np.ascontiguousarray(C[:, 0])).to(
                    device, dtype) @ Sb
                xj = xj / np.sqrt(_vdot_real(xj, bmult(xj)))
            locked.append(xj)
            lams.append(rho)
            errs.append(err)
            eps.monitor(eps, eps.its, len([e for e in errs if e < eps.tol]),
                        np.array(lams), np.array(errs))
            if err >= eps.tol:
                break

        eps.nconv = sum(1 for e in errs if e < eps.tol)
        eps.eigenvalues = np.array(lams)
        eps.errests = np.array(errs)
        eps._eigenvectors = (torch.stack(locked) if locked else
                             torch.zeros((0, n), dtype=dtype, device=device))


def _deflate(v: torch.Tensor, X) -> torch.Tensor:
    """v with the locked rows X projected out, one after another."""
    for x in X:
        v = v - x * torch.vdot(x, v)
    return v


EPS.register("rqcg", RQCG)
