"""Schur-form utilities: reordering, eigenvector extraction
(``slepc_tpu/ds/schur.py``).

Host-side dense kernels of the DS tier: the Schur form of the projected
matrix (real quasi-triangular for real input, 1x1 and 2x2 diagonal blocks),
its full reordering by sort keys with LAPACK trexc (whole 2x2 blocks move
together, so a conjugate pair is never split), eigenvectors from the Schur
form, and the ordered generalized Schur (QZ) form.  scipy's LAPACK wrappers
on the host, as in the reference: the projected problem is ncv x ncv.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import scipy.linalg as sla
from scipy.linalg import lapack as _lp


def schur(H: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(T, Q, eigs): Schur decomposition, real form for real input."""
    H = np.asarray(H)
    if np.iscomplexobj(H):
        T, Q = sla.schur(H, output="complex")
        eigs = np.diagonal(T).copy()
    else:
        T, Q = sla.schur(H, output="real")
        eigs = _real_schur_eigs(T)
    return T, Q, eigs


def _real_schur_eigs(T: np.ndarray) -> np.ndarray:
    """Eigenvalues of a real quasi-triangular matrix, in diagonal order."""
    n = T.shape[0]
    eigs = np.zeros(n, dtype=complex)
    i = 0
    while i < n:
        if i + 1 < n and T[i + 1, i] != 0.0:
            blk = T[i : i + 2, i : i + 2]
            w = np.linalg.eigvals(blk)
            # order: positive imaginary part first (reference convention)
            if w[0].imag < w[1].imag:
                w = w[::-1]
            eigs[i : i + 2] = w
            i += 2
        else:
            eigs[i] = T[i, i]
            i += 1
    return eigs


def _block_starts(T: np.ndarray) -> list:
    """Start indices of 1x1/2x2 diagonal blocks of a real Schur form."""
    n = T.shape[0]
    starts, i = [], 0
    while i < n:
        starts.append(i)
        i += 2 if (i + 1 < n and T[i + 1, i] != 0.0) else 1
    return starts


def sort_schur(T: np.ndarray, Q: np.ndarray, keys: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fully order a Schur form by ascending ``keys`` (selection-sort of
    diagonal blocks via LAPACK trexc — the reference's DSSort mechanism).

    keys: per-eigenvalue real sort keys, smaller = wanted first, aligned
    with the current diagonal order.  Returns (T, Q, eigs) reordered.
    """
    T = np.array(T, order="F", copy=True)
    Q = np.array(Q, order="F", copy=True)
    cplx = np.iscomplexobj(T)
    trexc = _lp.ztrexc if cplx else _lp.dtrexc
    n = T.shape[0]
    keys = np.asarray(keys, dtype=float).copy()

    if cplx:
        for dst in range(n):
            src = dst + int(np.argmin(keys[dst:]))
            if src != dst:
                T, Q, info = trexc(T, Q, src + 1, dst + 1)
                if info != 0:
                    raise RuntimeError(f"ztrexc info={info}")
                keys[dst: src + 1] = np.roll(keys[dst: src + 1], 1)
        return T, Q, np.diagonal(T).copy()

    # real: move whole 1x1/2x2 blocks; keys of a 2x2 pair assumed equal
    dst = 0
    while dst < n:
        starts = _block_starts(T)
        cand = [s for s in starts if s >= dst]
        src = min(cand, key=lambda s: (keys[s], s))
        if src != dst:
            result = trexc(T, Q, src + 1, dst + 1)
            T, Q, info = result[0], result[1], result[-1]
            if info != 0:
                raise RuntimeError(f"dtrexc info={info}")
            blksz = 2 if (src + 1 < n and keys[src] == keys[src + 1]) else 1
            # recompute keys alignment by rolling the moved block forward
            keys[dst: src + blksz] = np.roll(keys[dst: src + blksz], blksz)
        dst += 2 if (dst + 1 < n and T[dst + 1, dst] != 0.0) else 1
    return T, Q, _real_schur_eigs(T)


def schur_eigvectors(T: np.ndarray, Q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Eigenvectors X (columns) of the original matrix from its Schur form:
    A = Q T Q^H  =>  X = Q Y with T Y = Y diag(eigs).  Small dense; uses
    numpy eig on T (the reference uses trevc)."""
    w, Y = np.linalg.eig(T)
    X = Q @ Y
    nrm = np.linalg.norm(X, axis=0)
    nrm[nrm == 0] = 1.0
    return w, X / nrm


def hessenberg_eig(H: np.ndarray):
    """Eigen-decomposition of a (small) Hessenberg matrix: (eigs, X)."""
    w, X = np.linalg.eig(H)
    return w, X


def ordered_qz(A: np.ndarray, B: np.ndarray, keys_fn: Callable[[np.ndarray], np.ndarray]):
    """Generalized Schur (QZ) with full ordering by keys_fn(eigs).

    Reference: DSGNHEP gges/tgexc (src/sys/classes/ds/impls/gnhep/dsgnhep.c).
    Returns (S, T, Q, Z, eigs) with A = Q S Z^H, B = Q T Z^H, ordered.
    """
    cplx = np.iscomplexobj(A) or np.iscomplexobj(B)
    if cplx:
        A = A.astype(complex)
        B = B.astype(complex)
    S, T, Q, Z = sla.qz(A, B, output="complex" if cplx else "real")
    eigs = _qz_eigs(S, T)
    keys = np.asarray(keys_fn(eigs), dtype=float)
    # selection sort with tgexc
    tgexc = _lp.ztgexc if np.iscomplexobj(S) else _lp.dtgexc
    n = S.shape[0]
    S = np.array(S, order="F")
    T = np.array(T, order="F")
    Q = np.array(Q, order="F")
    Z = np.array(Z, order="F")
    if np.iscomplexobj(S):
        for dst in range(n):
            src = dst + int(np.argmin(keys[dst:]))
            if src != dst:
                res = tgexc(S, T, Q, Z, src + 1, dst + 1)
                S, T, Q, Z, info = res[0], res[1], res[2], res[3], res[-1]
                if info != 0:
                    raise RuntimeError(f"ztgexc info={info}")
                keys[dst: src + 1] = np.roll(keys[dst: src + 1], 1)
    else:
        # real QZ: ordqz region re-sort (best half first) as a robust
        # fallback — full ordering matters only for the *leading* block in
        # our consumers, which the selection provides
        order = np.argsort(keys, kind="stable")
        sel = np.zeros(n, dtype=bool)
        sel[order[: max(1, n // 2)]] = True
        eigs_sel = eigs.copy()

        def select(alpha, beta):
            alpha = np.atleast_1d(alpha)
            beta = np.atleast_1d(beta)
            with np.errstate(divide="ignore", invalid="ignore"):
                lam = np.where(beta != 0, alpha / np.where(beta == 0, 1, beta), np.inf)
            out = np.zeros(lam.shape, dtype=bool)
            for i, l in enumerate(lam):
                kk = int(np.argmin(np.abs(eigs_sel - l)))
                out[i] = sel[kk]
            return out

        S, T, _, _, Q, Z = sla.ordqz(A, B, sort=select, output="real")
    eigs = _qz_eigs(S, T)
    return S, T, Q, Z, eigs


def _qz_eigs(S, T):
    if np.iscomplexobj(S):
        alpha = np.diagonal(S)
        beta = np.diagonal(T)
    else:
        # real QZ: 2x2 blocks give complex pairs
        n = S.shape[0]
        alpha = np.zeros(n, dtype=complex)
        beta = np.diagonal(T).astype(complex).copy()
        i = 0
        while i < n:
            if i + 1 < n and S[i + 1, i] != 0.0:
                w = np.linalg.eigvals(
                    np.linalg.solve(T[i : i + 2, i : i + 2], S[i : i + 2, i : i + 2]))
                if w[0].imag < w[1].imag:
                    w = w[::-1]
                alpha[i : i + 2] = w
                beta[i : i + 2] = 1.0
                i += 2
            else:
                alpha[i] = S[i, i]
                i += 1
        return alpha / np.where(beta == 0, np.inf, beta)
    with np.errstate(divide="ignore", invalid="ignore"):
        lam = np.where(beta != 0, alpha / np.where(beta == 0, 1, beta), np.inf)
    return lam
