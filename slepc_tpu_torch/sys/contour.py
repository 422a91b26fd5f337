"""Shared contour-integral machinery (``slepc_tpu/sys/contour.py``; the
SlepcContourData analog).

Reference: src/sys/slepccontour.c -- the common infrastructure of the CISS
solvers (EPS/PEP/NEP): accumulate the moments
S_k = (1/2 pi i) oint z^k F(z)^{-1} G dz . V over the quadrature points, a
rank-revealing basis of them (SlepcCISS_BH_SVD :209) and the block-Hankel
pencil.  Plain numpy on the host, a copy of the reference's (which imports
no JAX either), kept here so the port imports nothing of slepc_tpu.  The
EPS CISS solver (``eps/ciss.py``) runs its own device accumulation; the
nonlinear solver (ROADMAP.md, queue 1, item 15) will use this module.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def contour_moments(
    solve_at: Callable[[complex, np.ndarray], np.ndarray],
    rhs: np.ndarray,
    z: np.ndarray,
    w: np.ndarray,
    n_moments: int,
) -> np.ndarray:
    """S = [S_0 | ... | S_{M-1}], S_k = sum_j w_j z_j^k solve_at(z_j, rhs).

    ``solve_at(z, R)`` returns F(z)^{-1} R (shape of R).
    """
    n, L = rhs.shape
    M = n_moments
    S = np.zeros((n, M * L), dtype=complex)
    for j in range(len(z)):
        Y = solve_at(z[j], rhs)
        zk = 1.0
        for k in range(M):
            S[:, k * L: (k + 1) * L] += (w[j] * zk) * Y
            zk *= z[j]
    return S


def rank_reveal(S: np.ndarray, tol: float = 1e-11) -> np.ndarray:
    """Orthonormal basis of the numerical range of S (BVSVDAndRank)."""
    Q, sv, _ = np.linalg.svd(S, full_matrices=False)
    rank = int(np.sum(sv > tol * max(sv[0] if sv.size else 0.0, 1e-300)))
    return Q[:, : max(rank, 1)]


def hankel_pencil(S: np.ndarray, L: int, M: int) -> Tuple[np.ndarray, np.ndarray]:
    """Block-Hankel pencil (H0, H1) from the moment blocks of S (the Hankel
    extraction variant, reference ciss.c EPS_CISS_EXTRACTION_HANKEL): block
    row i of H0 holds S_i .. S_{i+M/2-1}, of H1 S_{i+1} .. S_{i+M/2}."""
    m2 = M // 2
    H0 = np.concatenate([S[:, (i) * L: (i + m2) * L] for i in range(m2)], axis=0)
    H1 = np.concatenate([S[:, (i + 1) * L: (i + 1 + m2) * L] for i in range(m2)], axis=0)
    return H0, H1
