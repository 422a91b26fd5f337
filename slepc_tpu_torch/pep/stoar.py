"""PEP STOAR -- symmetric TOAR for quadratic eigenproblems
(``slepc_tpu/pep/stoar.py``).

Reference: src/pep/impls/krylov/stoar/stoar.c (1,092 LoC): for symmetric
QEPs (hyperbolic/gyroscopic; K, C, M symmetric) run a pseudo-Lanczos
recurrence that preserves the symmetric-indefinite structure of the
linearization, halving memory/work vs general TOAR.

Design here: the symmetric linearization pencil
    A_L = [[-K, 0], [0, M]],   B_L = [[C, M], [M, 0]]
is symmetric / symmetric-indefinite; the pencil eigenproblem
A_L z = lambda B_L z reproduces the QEP with z = [x; lambda x].  The
solve runs through the port's EPS GHIEP arm (pseudo-Lanczos with an
indefinite B_L inner product, omega signature tracking; its SpMVs are the
coefficients' kernels, its sweeps K3) with shift-and-invert on the
assembled pencil A_L - sigma B_L (a host factorization; BiCGStab on the
shell pencil when a coefficient has no explicit matrix).  Where the
reference catches the pseudo-Lanczos' complex-pair assertion and re-runs
the problem by TOAR, the port's GHIEP arm re-solves such a projected
pencil as GNHEP itself (``eps.gnhep_resolve``), so no fallback is taken.
"""

from __future__ import annotations

import numpy as np
import torch


def stoar_solve(pep) -> None:
    import scipy.sparse as sp

    from ..eps.base import EPS, ProblemType, op_mult
    from ..ksp import KSP
    from ..mat.linop import ShellOperator
    from ..st.st import STSinvert
    from .pep import operator_of
    from .toar import toar_solve

    if pep.degree != 2:
        toar_solve(pep)
        return
    K, C, M = pep.mats
    n = pep.n
    dev = pep.device
    dtype = K.dtype

    def mvA(z):
        return torch.cat([-op_mult(K, z[:n]), op_mult(M, z[n:])])

    def mvB(z):
        return torch.cat([op_mult(C, z[:n]) + op_mult(M, z[n:]),
                          op_mult(M, z[:n])])

    AL = ShellOperator((2 * n, 2 * n), dtype, mvA, mvA,
                       nnz=K.nnz + M.nnz, device=dev)
    BL = ShellOperator((2 * n, 2 * n), dtype, mvB, mvB,
                       nnz=C.nnz + 2 * M.nnz, device=dev)

    target = complex(pep.target) if pep.target is not None else 0.0
    if target.imag == 0:
        target = target.real
    eps = EPS(AL, BL, problem_type=ProblemType.GHIEP,
              nev=pep.nev, ncv=pep.ncv and 2 * pep.ncv,
              tol=pep.tol, max_it=pep.max_it)
    eps.set_target(target)

    # sinvert on the assembled symmetric pencil (A_L - sigma B_L is
    # symmetric: the host LDL^T / LU factorization applies) when every
    # coefficient has an explicit matrix; a shell one takes BiCGStab on
    # the shell pencil, as psigma_ksp does
    parts = [x.explicit() for x in (K, C, M)]
    if any(s is None for s in parts):
        st = STSinvert([AL, BL], sigma=target, hermitian=False)
    else:
        Ks, Cs, Ms = (sp.csr_matrix(s) for s in parts)
        ALs = sp.bmat([[-Ks, None], [None, Ms]], format="csr")
        BLs = sp.bmat([[Cs, Ms], [Ms, None]], format="csr")

        class _PencilSinvert(STSinvert):
            def _make_ksp(self, sigma, hermitian=False):
                return KSP(operator_of((ALs - sigma * BLs).tocsr(), dev),
                           method="direct", hermitian=hermitian)

        st = _PencilSinvert([AL, BL], sigma=target, hermitian=False)
    eps.set_st(st)
    eps.solve()

    pep.its = eps.its
    k = eps.nconv
    pep.nconv = k
    X = eps._eigenvectors[:k, :n] if k else \
        torch.zeros((0, n), dtype=dtype, device=dev)
    nrm = torch.linalg.vector_norm(X, dim=1, keepdim=True)
    pep._set_results(eps.eigenvalues[:k].copy(),
                     eps.errests[:k].copy() if len(eps.errests) >= k
                     else np.zeros(k),
                     X / torch.where(nrm > 0, nrm, torch.ones_like(nrm)))
