"""EPS LyapII -- Lyapunov inverse iteration for rightmost eigenvalues
(``slepc_tpu/eps/lyapii.py``).

Reference: src/eps/impls/lyapii/lyapii.c (793 LoC): to find the rightmost
eigenvalues of A (stability analysis), iterate on the Lyapunov operator:
solve A Y + Y A^H + x x^H = 0 (via LME, low-rank), take the dominant
eigenvector(s) of Y as the next iterate; the dominant invariant subspace of
Y aligns with the eigenvectors of the rightmost (least stable) pair.

Here every n-long vector stays on the operator's device.  The Lyapunov
solves are the port's LME, kept in their Krylov form Z = V^T L
(``LME.lyapunov_factors``), so Z's dominant left singular vectors are
V^T times those of the small host factor L: one K4 rotation.  The
extraction space is a row basis grown by CGS2 on K3, A V is one block
apply (``mult_block``: K5 for a DIA operator), G = V^T A V one K3 dots
sweep, and the Ritz vectors and their residuals K4 rotations.  The host
reads G, the Ritz residual norms and the orthogonalization norms, and
solves G's small eigenproblem, from the reference's ``default_rng(0)``
start.  Real operators only, as the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bv.orthog import gram, orthogonalize_vec
from .base import EPS, EPSConvergedReason, EPSSolver, basis_combine, op_mult_block


def _append_orthonormal(V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The rows of V (orthonormal) followed by those of W orthonormalized
    against them and each other (CGS2 on K3; one host read a row)."""
    for w in W:
        w, _, _, nrm = orthogonalize_vec(V, w, passes=2)
        V = torch.cat([V, (w / float(nrm))[None]])
    return V


class LyapII(EPSSolver):
    rank = 2  # working rank (reference -eps_lyapii_ranks)

    def solve(self, eps: EPS) -> None:
        from ..lme.lme import LME  # lme imports eps.base

        A = eps.A
        n = eps.n
        if A.dtype.is_complex:
            raise ValueError("lyapii implemented for real operators (reference parity)")
        rng = np.random.default_rng(0)
        x0 = rng.standard_normal(n)
        x = torch.from_numpy(x0 / np.linalg.norm(x0)).to(A.device, A.dtype)
        lme = LME(A, ncv=min(30, n), tol=max(eps.tol * 0.01, 1e-12))

        # subspace-accelerated variant: accumulate dominant Lyapunov
        # directions in V (dim <= mmax) and Rayleigh-Ritz on A|V each
        # iteration (the reference's projected EPS inner solve role)
        mmax = max(8, 2 * eps.nev + 2)
        Vsub = x[None]
        lam = None
        xc = None
        err = np.inf
        eps.its = 0
        while eps.its < eps.max_it:
            eps.its += 1
            # A (ZZ^T) + (ZZ^T) A^T + x x^T = 0, Z = Vk^T L
            factors = lme.lyapunov_factors(x)
            if not factors or factors[0][1].shape[1] == 0:
                break
            Vk, L = factors[0]
            Ul = np.linalg.svd(L, full_matrices=False)[0]
            add = basis_combine(Vk, Ul[:, : self.rank])  # Z's dominant rows
            if Vsub.shape[0] + add.shape[0] > mmax and xc is not None:
                # restart the extraction space around the current best pair
                seed = torch.stack([xc.real, xc.imag]) \
                    if abs(lam.imag) > 1e-13 else xc.real[None]
                Vsub = _append_orthonormal(Vsub[:0], seed)
            Vsub = _append_orthonormal(Vsub, add)
            AV = op_mult_block(A, Vsub)
            G = gram(Vsub, AV).cpu().numpy()  # G[a, b] = <V_a, A V_b>
            w, C = np.linalg.eig(G)
            # residuals of ALL Ritz pairs: spurious "rightmost" Ritz values
            # from stale subspace directions must not be selected
            X = basis_combine(Vsub, C)
            wt = torch.from_numpy(w).to(A.device, X.dtype)
            R = basis_combine(AV, C) - wt[:, None] * X
            res_all = torch.linalg.vector_norm(R, dim=1).cpu().numpy() \
                / np.maximum(np.abs(w), 1e-300)
            feas = res_all < 0.2
            if np.any(feas):
                cand = np.where(feas)[0]
                j = int(cand[np.argmax(w.real[cand])])
            else:
                j = int(np.argmin(res_all))
            lam = w[j]
            xc = X[j] / torch.linalg.vector_norm(X[j])
            err = res_all[j]
            eps.monitor(eps, eps.its, int(err < eps.tol), np.array([lam]),
                        np.array([err]))
            if err < eps.tol:
                break
            # next iterate: the DOMINANT direction of the Lyapunov solution
            # (inverse iteration on the Lyapunov operator)
            x = add[0]

        cplx_pair = lam is not None and abs(lam.imag) > 1e-13
        eps.nconv = (2 if cplx_pair else 1) if (lam is not None and err < eps.tol * 100) else 0
        if eps.nconv:
            if cplx_pair:
                eps.eigenvalues = np.array([lam, np.conj(lam)])
                X = torch.stack([xc, xc.conj()])
                eps.errests = np.array([err, err])
            else:
                eps.eigenvalues = np.array([lam.real])
                X = xc.real[None]
                eps.errests = np.array([err])
            eps._eigenvectors = X / torch.linalg.vector_norm(
                X, dim=1, keepdim=True)
        else:
            eps.eigenvalues = np.array([])
            eps.errests = np.array([])
            eps._eigenvectors = torch.zeros((0, n), dtype=A.dtype,
                                            device=A.device)
            eps.reason = EPSConvergedReason.DIVERGED_ITS


EPS.register("lyapii", LyapII)
