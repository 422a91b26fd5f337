"""EPS dense LAPACK solver (``slepc_tpu/eps/lapack.py``).

Materializes the operators (``to_dense`` on their device), solves the full
dense problem with LAPACK on the host and puts the wanted eigenvectors back
on the operators' device as rows: testing and small-n use, like the
reference's redundant dense solver.  A complex pair of a real problem has
complex eigenvector rows.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from .base import EPS, EPSSolver


class Lapack(EPSSolver):
    def solve(self, eps: EPS) -> None:
        A = eps.A.to_dense().cpu().numpy()
        B = None if eps.B is None else eps.B.to_dense().cpu().numpy()
        if eps.is_hermitian and B is None:
            w, X = np.linalg.eigh(0.5 * (A + A.conj().T))
            w = w.astype(complex)
        elif eps.is_hermitian:
            w, X = sla.eigh(0.5 * (A + A.conj().T), 0.5 * (B + B.conj().T))
            w = w.astype(complex)
        elif B is None:
            w, X = np.linalg.eig(A)
        else:
            w, X = sla.eig(A, B)
        finite = np.isfinite(w)
        w, X = w[finite], X[:, finite]
        order = eps.sort_criterion().argsort(w)
        w, X = w[order], X[:, order]
        k = min(eps.nev, len(w))
        eps.its = 1
        eps.nconv = k
        eps.eigenvalues = w[:k]
        if np.all(np.abs(np.imag(w[:k])) < 1e-14):
            eps.eigenvalues = w[:k].real
        Xk = X[:, :k]
        if not np.iscomplexobj(A) and np.all(Xk.imag == 0):
            Xk = Xk.real
        nrm = np.linalg.norm(Xk, axis=0)
        nrm[nrm == 0] = 1
        eps._eigenvectors = torch.from_numpy(
            np.ascontiguousarray((Xk / nrm).T)).to(eps.A.device)
        eps.errests = np.array([eps.compute_error(i) for i in range(k)])


EPS.register("lapack", Lapack)
