"""EPS subspace iteration with Rayleigh-Ritz (``slepc_tpu/eps/subspace.py``).

A block of ncv vectors: V <- Op V on the rows not yet converged, CholeskyQR2
(``bv/orthog.py``: Gram on K3, the triangular solve as a K4 rotation), then
Rayleigh-Ritz: G = V^T Op V (K3 sweeps), the small eigen- or real Schur
problem on the host (2x2 blocks sorted whole), V <- V Q (K4), residuals of
the leading pairs, locking of the converged leading rows.

The block apply is the operator's ``mult_block``: for a DIA operator the
block SpMM K5, in launches of at most 8 rows, so a block of ncv rows runs
as ceil(ncv / 8) launches on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bv.orthog import cholqr2, gram
from ..ds.schur import schur, sort_schur
from ..mat.linop import LinearOperator
from ..ops.rotate import rotate
from .base import EPS, EPSSolver, basis_combine, normalize_rows, work_dtype
from .krylovschur import _pair_keys


class Subspace(EPSSolver):
    def solve(self, eps: EPS) -> None:
        st = eps.st
        op = st.op()
        block = LinearOperator.block_of(op)
        n, ncv = eps.n, eps.ncv
        dtype, device = work_dtype(eps, op), eps.A.device
        cplx = dtype.is_complex
        hermitian = eps.is_hermitian
        sc = eps.sort_criterion()

        def dev(M):
            return torch.from_numpy(np.ascontiguousarray(M)).to(device, dtype)

        rng = np.random.default_rng(0)
        V0 = rng.standard_normal((n, ncv))
        if cplx:  # the reference's complex start block
            V0 = V0 + 1j * rng.standard_normal((n, ncv))
        if eps.initial_space is not None:
            k0 = min(eps.initial_space.shape[1], ncv)
            V0[:, :k0] = eps.initial_space[:, :k0]
        V, _ = cholqr2(dev(V0.T))

        nconv = 0
        lams = np.zeros(ncv, dtype=complex)
        errs = np.full(ncv, np.inf)
        while eps.its < eps.max_it:
            eps.its += 1
            V[nconv:] = block(V[nconv:])  # the converged rows stay fixed
            V, _ = cholqr2(V)
            # Rayleigh-Ritz
            G = gram(V, block(V)).cpu().numpy()
            if hermitian:
                theta, Q = np.linalg.eigh(0.5 * (G + G.conj().T))
                keys = sc.keys(st.back_transform(theta.astype(complex)))
                order = np.argsort(keys, kind="stable")
                theta, Q = theta[order].astype(complex), Q[:, order]
            else:
                T, Q, theta = schur(G)
                keys = sc.keys(st.back_transform(theta))
                if not cplx:  # a complex Schur form has no pairs
                    keys = _pair_keys(T, keys)
                T, Q, theta = sort_schur(T, Q, keys)
            V = rotate(dev(Q), V)
            # residuals of the leading pairs
            AV = block(V)
            if hermitian:
                R = AV - dev(theta.real)[:, None] * V
            else:
                G2 = gram(V, AV).cpu().numpy()
                R = AV - rotate(dev(np.triu(G2)), V)
            rn = torch.linalg.vector_norm(R, dim=1).cpu().numpy()
            errs = np.array([eps.conv_measure(theta[i], rn[i])
                             for i in range(ncv)])
            k2 = 0
            while k2 < ncv and errs[k2] < eps.tol:
                k2 += 1
            nconv = k2
            lams = st.back_transform(theta)
            eps.monitor(eps, eps.its, nconv, lams, errs)
            if nconv >= eps.nev:
                break

        eps.nconv = nconv
        eps.eigenvalues = lams[:nconv].copy()
        if np.all(np.abs(np.imag(eps.eigenvalues)) < 1e-14):
            eps.eigenvalues = eps.eigenvalues.real
        eps.errests = errs[:nconv].copy()
        if hermitian:
            eps._eigenvectors = V[:nconv].clone()
        else:
            # eigenvectors from the leading Schur block
            m = max(nconv, 1)
            G = gram(V[:m], block(V[:m])).cpu().numpy()
            w, Y = np.linalg.eig(G)
            order = np.argsort(sc.keys(st.back_transform(w)), kind="stable")
            eps._eigenvectors = normalize_rows(
                basis_combine(V[:m], Y[:, order[:nconv]]))
            eps.eigenvalues = st.back_transform(w[order[:nconv]])


EPS.register("subspace", Subspace)
