"""Compact (tridiagonal + arrow) projected-problem storage for DSHEP
(``slepc_tpu/ds/compact.py``; host numpy, as in the reference), with the
GHIEP arm ``solve_arrow_ghiep`` (the pseudo-Lanczos compact form, solved by
``DSGHIEP`` on the expanded matrix).

Reference: src/sys/classes/ds/impls/hep/dshep.c — the DS tier stores the
projected matrix of a Lanczos / thick-restart recurrence in COMPACT form:
two real vectors d (m,) and e (m-1,), where for i < k the entry e[i] is
the arrow coupling (i <-> k) left by the restart (Ritz values d[:k]
coupled to the first new Lanczos vector) and for i >= k it is the
tridiagonal coupling (i <-> i+1).  DSArrowTridiag (dshep.c:221-261)
reduces the leading arrowhead to tridiagonal with plane rotations plus a
top-left bulge chase, then steqr finishes — never assembling the dense
matrix.  This module implements that scheme on numpy.

Rotation algebra (derived for the symmetric similarity with new basis
q_i = c u_i - s u_{i+1}, q_{i+1} = s u_i + c u_{i+1}):
  * hub couplings (a_i, a_{i+1}) -> (0, r) for (c, s) = (a_{i+1}, a_i)/r
  * diagonals mix as c^2/s^2 with -+2cs t cross terms
  * a bulge (i-1, i+1) = s * T[i-1, i] appears and is chased by the same
    rotation type acting one plane lower.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg as sla


def arrow_expand(d: np.ndarray, e: np.ndarray, k: int) -> np.ndarray:
    """Dense matrix for the compact (d, e, k) arrow+tridiagonal form."""
    d = np.asarray(d, dtype=float)
    e = np.asarray(e, dtype=float)
    m = len(d)
    T = np.diag(d)
    for i in range(min(k, m - 1)):
        T[i, k] = T[k, i] = e[i]
    for i in range(k, m - 1):
        T[i, i + 1] = T[i + 1, i] = e[i]
    return T


def _rot(Q: np.ndarray, i: int, c: float, s: float) -> None:
    qi = c * Q[:, i] - s * Q[:, i + 1]
    Q[:, i + 1] = s * Q[:, i] + c * Q[:, i + 1]
    Q[:, i] = qi


def _arrowhead_tridiag(d: np.ndarray, e: np.ndarray, Q: np.ndarray) -> None:
    """In-place reduce an arrowhead (hub at the LAST index) to tridiagonal.

    On entry e[i] couples i <-> n-1; on exit e[i] couples i <-> i+1.
    Rotations are accumulated into the columns of Q (only columns
    0..n-2 are touched — the hub row never rotates).
    """
    n = len(d)
    for j in range(n - 2):
        a, a1 = e[j], e[j + 1]
        r = np.hypot(a, a1)
        if r == 0.0:
            e[j] = 0.0
            continue
        c, s = a1 / r, a / r
        e[j + 1] = r
        dj, dj1 = d[j], d[j + 1]
        d[j] = c * c * dj + s * s * dj1
        d[j + 1] = s * s * dj + c * c * dj1
        e[j] = c * s * (dj - dj1)  # new tridiagonal coupling (j, j+1)
        _rot(Q, j, c, s)
        # chase the bulge (i, i+2) = s * T[i, i+1] toward the top left
        for i in range(j - 1, -1, -1):
            bl = s * e[i]
            e[i] = c * e[i]
            if bl == 0.0:
                break
            t1 = e[i + 1]
            r2 = np.hypot(bl, t1)
            c, s = t1 / r2, bl / r2
            e[i + 1] = r2
            di, di1, ti = d[i], d[i + 1], e[i]
            d[i] = c * c * di + s * s * di1 - 2.0 * c * s * ti
            d[i + 1] = s * s * di + c * c * di1 + 2.0 * c * s * ti
            e[i] = c * s * (di - di1) + (c * c - s * s) * ti
            _rot(Q, i, c, s)


def arrow_to_tridiag(d: np.ndarray, e: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reduce the compact (d, e, k) form to pure tridiagonal.

    Returns (alpha, beta, Q) with Q^T T Q = tridiag(alpha, beta);
    only the leading arrowhead block (hub at index k) is rotated, the
    tridiagonal tail is untouched.  Reference: DSArrowTridiag.
    """
    d = np.asarray(d, dtype=float).copy()
    e = np.asarray(e, dtype=float).copy()
    m = len(d)
    Q = np.eye(m)
    if k > 1 and m > 2:
        _arrowhead_tridiag(d[: k + 1], e[: k], Q)
    return d, e, Q


def solve_arrow_hep(d: np.ndarray, e: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition (w, Q) of the compact HEP form.

    Plane-rotation arrow reduction + steqr (eigh_tridiagonal) — the
    reference's DSSolve_HEP_QR path (dshep.c:265-300) on compact storage.
    """
    d = np.asarray(d, dtype=float)
    m = len(d)
    if m == 0:
        return np.zeros(0), np.zeros((0, 0))
    if m == 1:
        return d.copy(), np.ones((1, 1))
    alpha, beta, Q0 = arrow_to_tridiag(d, e, k)
    w, Z = sla.eigh_tridiagonal(alpha, beta,
                                lapack_driver="stevd" if len(alpha) >= 256
                                else "auto")
    return w, Q0 @ Z


def extract_compact(S: np.ndarray, rtol: float = 1e-13):
    """Detect arrow+tridiagonal structure in a dense symmetric matrix.

    Returns (d, e, k) when S is numerically of the compact form a
    thick-restarted Lanczos recurrence produces (Ritz diag + arrow row at
    k + tridiagonal tail), else None.  This is the bridge between the
    dense Hessenberg bookkeeping of the host Krylov-Schur loop and the
    reference's always-compact DSHEP storage (dshep.c DS_MAT_T).
    """
    S = np.asarray(S)
    m = S.shape[0]
    if m == 0 or S.shape != (m, m):
        return None
    scale = float(np.abs(S).max()) if S.size else 0.0
    if scale == 0.0:
        return np.zeros(m), np.zeros(max(m - 1, 0)), 0
    tol = rtol * scale
    if np.iscomplexobj(S):
        if np.abs(S.imag).max() > tol:
            return None
        S = S.real
    U = np.triu(np.abs(S), 2)
    rows, cols = np.nonzero(U > tol)
    if len(cols) == 0:
        k = 0
    else:
        k = int(cols[0])
        if not (np.all(cols == k) and np.all(rows < k)):
            return None
        # the arrow block's superdiagonal must be empty
        sup = np.abs(np.diag(S, 1)[: max(k - 1, 0)])
        if sup.size and sup.max() > tol:
            return None
    d = np.diag(S).astype(float).copy()
    e = np.zeros(max(m - 1, 0))
    for i in range(min(k, m - 1)):
        e[i] = S[i, k]
    for i in range(k, m - 1):
        e[i] = S[i, i + 1]
    if np.abs(S - arrow_expand(d, e, k)).max() > 10 * tol:
        return None
    return d, e, k


def solve_arrow_ghiep(d: np.ndarray, e: np.ndarray, omega: np.ndarray,
                      k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Compact GHIEP form: T x = lambda Omega x, Omega = diag(+-1).  The
    indefinite HZ / HR reduction is replaced by ``DSGHIEP`` on the
    expanded matrix (projected sizes are <= mpd); the compact storage stays
    at the interface, so a pseudo-Lanczos recurrence never assembles T
    itself."""
    from .types import DSGHIEP

    return DSGHIEP().solve(arrow_expand(d, e, k), np.asarray(omega))
