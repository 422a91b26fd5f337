"""Block-tridiagonal divide-and-conquer eigensolver with deflation (BDC):
the port's own copy of ``slepc_tpu/ds/bdc.py`` (numpy on the host, like the
rest of the DS tier; the port imports nothing of ``slepc_tpu``).

Role in the reference: the custom approximate block-tridiagonal D&C that
DSHEP uses for large projected problems (impls/hep/bdc/dsbtdc.c +
dibtdc.c/dlaed3m.c/dmerg2.c, ~2,600 LoC) — SLEPc ships it because its
nev>=500 regime sets mpd=500 and the projected matrices become too large
for steqr-class drivers.  This is an independent implementation of the
same (Gansterer–Ward) algorithm, not a translation:

  1. split the block-tridiagonal matrix at a block boundary; the coupling
     block B is removed by writing its SVD B = U diag(s) V^T (truncated at
     the approximation parameter ``tau`` — the defining feature of the
     reference's dsbtdc: accuracy/cost trade) and subtracting
     s_j u_j u_j^T / s_j v_j v_j^T from the adjacent diagonal blocks, so

        M = diag(M1', M2') + sum_j s_j w_j w_j^T,
        w_j = [0.., u_j at the end of half 1 | v_j at the start of half 2]

  2. recurse on the decoupled halves;
  3. merge with ``rank(B)`` sequential rank-one updates: in the current
     eigenbasis each update is diag(d) + rho z z^T, solved by the secular
     equation with LAED-style deflation (small |z_k| and near-identical
     d_k Givens-deflated) and Gu–Eisenstat z-reconstruction for
     numerically orthogonal eigenvectors without reorthogonalization.

Cost: O(sum of cubes of deflated merge sizes) — like the reference, far
below a dense eigh when deflation bites (clustered spectra, small coupling
ranks); exact when ``tau=0`` up to roundoff.

Interfaces:
  dpr1_eig(d, z, rho)           diag(d) + rho z z^T  ->  (w, Q)
  bdc_eig(Ds, Es, tau=0.0)      block tridiag       ->  (w, Q)
  DSHEP.solve_block_tridiag routes here when ``force=True`` or
  ``tau > 0`` (accuracy/cost trade requested); ``tau=0`` takes the
  dense eigh, which wins for full-rank couplings at DS sizes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["dpr1_eig", "bdc_eig", "block_tridiag_dense"]


# ---------------------------------------------------------------------------
# rank-one update: eigen-decomposition of diag(d) + rho * z z^T
# ---------------------------------------------------------------------------

def _secular_roots(d: np.ndarray, z2: np.ndarray, rho: float) -> np.ndarray:
    """Roots of f(lam) = 1 + rho * sum z2_k / (d_k - lam) for rho > 0,
    d strictly increasing, z2 > 0.  f rises from -inf to +inf across each
    interval (d_i, d_{i+1}) (the last bracket is (d_n, d_n + rho*sum z2)),
    so each holds exactly one root.  Solved with a bisection-safeguarded
    Newton iteration on the pole-shifted variable (shift = the nearer
    bracket endpoint, picked by the sign of f at the midpoint — the
    LAED4 trick that keeps d_k - lam cancellation-free where it is
    smallest)."""
    n = d.size
    tiny = np.finfo(float).tiny
    lo = d
    hi = np.append(d[1:], d[n - 1] + rho * float(z2.sum()))
    width = hi - lo

    # ---- pick the shift pole per root from the sign of f at the midpoint
    # (LAED4 trick: keep d_k - lam cancellation-free where it is smallest).
    # All roots iterate TOGETHER: every f evaluation is one (n, n) numpy
    # broadcast instead of n Python-loop scalar solves.
    dm_mid = (d[None, :] - lo[:, None]) - 0.5 * width[:, None]
    dm_mid = np.where(dm_mid == 0.0, tiny, dm_mid)
    f_mid = 1.0 + rho * (z2[None, :] / dm_mid).sum(axis=1)
    left = f_mid >= 0.0
    shift = np.where(left, lo, hi)
    mu_lo = np.where(left, 0.0, -0.5 * width)
    mu_hi = np.where(left, 0.5 * width, 0.0)

    mu = 0.5 * (mu_lo + mu_hi)
    live = np.arange(n)                          # unconverged root subset
    for _ in range(60):
        dm = d[None, :] - shift[live, None] - mu[live, None]
        dm = np.where(dm == 0.0, tiny, dm)
        t = z2[None, :] / dm
        f = 1.0 + rho * t.sum(axis=1)
        fp = rho * (t / dm).sum(axis=1)          # f' > 0 (f increasing)
        neg = f < 0.0
        mu_lo[live] = np.where(neg, mu[live], mu_lo[live])
        mu_hi[live] = np.where(neg, mu_hi[live], mu[live])
        with np.errstate(divide="ignore", invalid="ignore"):
            mu_new = mu[live] - f / fp
        bad = ~((mu_lo[live] < mu_new) & (mu_new < mu_hi[live])) \
            | ~np.isfinite(mu_new)
        mu_new = np.where(bad, 0.5 * (mu_lo[live] + mu_hi[live]), mu_new)
        done = np.abs(mu_new - mu[live]) <= 4e-16 * np.maximum(
            np.maximum(np.abs(mu_new), np.abs(shift[live])), 1e-300)
        mu[live] = mu_new
        live = live[~done]
        if live.size == 0:
            break
    lam = shift + mu
    # strict interlacing (the Gu–Eisenstat reconstruction needs it)
    lam = np.minimum(np.maximum(lam, np.nextafter(lo, np.inf)),
                     np.nextafter(hi, -np.inf))
    return lam


def dpr1_eig(d: np.ndarray, z: np.ndarray, rho: float,
             deflate_tol: float = None,
             basis: np.ndarray = None) -> Tuple[np.ndarray, np.ndarray]:
    """Eigen-decomposition of diag(d) + rho * z z^T (d any order, rho any
    sign) with LAED-style deflation.  Returns (w ascending, Q orthogonal).

    ``basis``: optional (N, n) orthonormal column basis to rotate INTO the
    eigenbasis; returns (w, basis @ Q) computed so deflated columns cost a
    copy/Givens, not a matmul — the BDC merge's cost lever (the reference
    BDC's deflation savings, dlaed3m.c role).  Default: the identity.
    """
    d = np.asarray(d, float).copy()
    z = np.asarray(z, float).copy()
    n = d.size
    if basis is None:
        basis = np.eye(n)
    if n == 0:
        return d, basis.copy()
    if rho == 0.0 or not np.any(z):
        order = np.argsort(d, kind="stable")
        return d[order], basis[:, order]
    if rho < 0.0:
        # diag(d)+rho zz^T = -(diag(-d) + |rho| zz^T): solve the negated
        # problem and flip
        w, Q = dpr1_eig(-d, z, -rho, deflate_tol, basis)
        return -w[::-1], Q[:, ::-1]

    nrm = float(np.linalg.norm(z))
    if nrm == 0.0:
        order = np.argsort(d, kind="stable")
        return d[order], basis[:, order]
    z = z / nrm
    rho = rho * nrm * nrm

    order = np.argsort(d, kind="stable")
    d = d[order]
    z = z[order]
    # accumulated rotations applied to the eigenvector matrix at the end
    # (deflation Givens + permutation)
    Q = basis[:, order].copy()  # maps work coords -> original coords

    tol = deflate_tol
    if tol is None:
        dspread = max(d[-1] - d[0], abs(d[-1]), abs(d[0]), 1.0)
        tol = 8.0 * np.finfo(float).eps * max(dspread, rho)

    # ---- deflation pass 1: tiny z components -> eigenpair (d_k, e_k)
    # LAED2-style criterion on rho*|z_k|, the actual backward
    # perturbation of dropping z_k — the old |z_k|*sqrt(rho) scaling was
    # dimensionally inconsistent and degraded large-rho accuracy
    # (measured ~4e-12 rel at rho ~ 1e12; r4 advisor finding)
    keep = rho * np.abs(z) > tol * 0.1
    # ---- deflation pass 2: near-equal d among kept -> Givens rotate one
    # z component to zero; the rotated column becomes an exact eigenvector
    # sequential scan: for kept indices in ascending d, merge clusters
    kept: List[int] = []
    for k in np.where(keep)[0]:
        if kept and abs(d[k] - d[kept[-1]]) <= tol:
            j = kept[-1]
            # Givens: zero z_k into z_j
            r = np.hypot(z[j], z[k])
            c, s = z[j] / r, z[k] / r
            z[j], z[k] = r, 0.0
            # rotate columns j,k of Q (the similarity keeps diag approx:
            # off-diagonal introduced is <= |d_k - d_j| <= tol, deflated)
            Qj = Q[:, j].copy()
            Q[:, j] = c * Qj + s * Q[:, k]
            Q[:, k] = -s * Qj + c * Q[:, k]
            keep[k] = False
        else:
            kept.append(int(k))

    act = np.where(keep)[0]
    nact = act.size
    if nact == 0:
        w = d.copy()
        order2 = np.argsort(w, kind="stable")
        return w[order2], Q[:, order2]
    if nact == 1:
        k = act[0]
        w = d.copy()
        w[k] = d[k] + rho * z[k] * z[k]
        order2 = np.argsort(w, kind="stable")
        return w[order2], Q[:, order2]

    da = d[act]
    za = z[act]
    # strictly increasing da required by the secular solver: deflation
    # guarantees gaps > tol among the active set
    lam = _secular_roots(da, za * za, rho)

    # ---- Gu–Eisenstat: recompute zhat from the computed lam so that the
    # analytic eigenvector formula gives orthogonal vectors:
    # zhat_k^2 = prod_i (lam_i - d_k) / (rho * prod_{i!=k} (d_i - d_k))
    # (signs of original z kept).  Vectorized in log space: the diagonal
    # of the denominator matrix (k = i) is masked to 1.
    m = nact
    dif_lam = lam[None, :] - da[:, None]         # (k, i): lam_i - d_k
    dif_d = da[None, :] - da[:, None]            # (k, i): d_i - d_k
    np.fill_diagonal(dif_d, 1.0)
    # ratio pairing keeps magnitudes near 1 (lam_i interlaces d_i):
    # pair lam_i - d_k with d_i - d_k for i != k; lam_k - d_k rides rho
    ratio = dif_lam / np.where(dif_d == 0.0, np.finfo(float).tiny, dif_d)
    diag_num = np.diagonal(dif_lam).copy()       # lam_k - d_k
    np.fill_diagonal(ratio, 1.0)
    val = np.prod(ratio, axis=1) * diag_num / rho
    zhat = np.sign(za) * np.sqrt(np.abs(val))

    # eigenvectors in the active subspace: columns zhat_k/(d_k - lam_i)
    Va = zhat[:, None] / (-dif_lam)              # (k, i): zhat/(d_k-lam_i)
    Va = Va / np.linalg.norm(Va, axis=0, keepdims=True)

    w = d.copy()
    w[act] = lam
    Qa = Q[:, act] @ Va                          # only active cols rotate
    Qfull = Q.copy()
    Qfull[:, act] = Qa
    order2 = np.argsort(w, kind="stable")
    return w[order2], Qfull[:, order2]


# ---------------------------------------------------------------------------
# block-tridiagonal divide and conquer
# ---------------------------------------------------------------------------

def block_tridiag_dense(Ds: Sequence[np.ndarray],
                        Es: Sequence[np.ndarray]) -> np.ndarray:
    """Assemble the dense symmetric matrix: diag blocks Ds[i], subdiagonal
    blocks Es[i] (block row i+1, block col i)."""
    sizes = [D.shape[0] for D in Ds]
    n = int(np.sum(sizes))
    off = np.cumsum([0] + sizes)
    M = np.zeros((n, n))
    for i, D in enumerate(Ds):
        M[off[i]:off[i + 1], off[i]:off[i + 1]] = 0.5 * (D + D.T)
    for i, E in enumerate(Es):
        M[off[i + 1]:off[i + 2], off[i]:off[i + 1]] = E
        M[off[i]:off[i + 1], off[i + 1]:off[i + 2]] = E.T
    return M


def bdc_eig(Ds: Sequence[np.ndarray], Es: Sequence[np.ndarray],
            tau: float = 0.0, dense_cutoff: int = 64
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Eigen-decomposition of the symmetric block-tridiagonal matrix with
    diagonal blocks ``Ds`` and subdiagonal blocks ``Es``
    (len(Es) == len(Ds) - 1).

    ``tau``: relative approximation parameter (dsbtdc's tol role) — each
    coupling block's SVD is truncated at ``tau * ||M||_est``; tau=0 keeps
    every singular value (exact to roundoff).  ``dense_cutoff``: subtrees
    at or below this size solve by dense eigh.

    Returns (w ascending, Q orthogonal with columns the eigenvectors).
    """
    Ds = [np.asarray(D, float) for D in Ds]
    Es = [np.asarray(E, float) for E in Es]
    if len(Ds) == 0:
        return np.zeros(0), np.eye(0)
    if len(Es) != len(Ds) - 1:
        raise ValueError("need len(Es) == len(Ds) - 1")
    nrm_est = max([np.abs(D).max() for D in Ds] + [1e-300]
                  + [np.abs(E).max() for E in Es if E.size])
    return _bdc_rec(Ds, Es, tau * nrm_est, dense_cutoff)


def _bdc_rec(Ds, Es, atol, cutoff):
    n = int(sum(D.shape[0] for D in Ds))
    if len(Ds) == 1 or n <= cutoff:
        w, Q = np.linalg.eigh(block_tridiag_dense(Ds, Es))
        return w, Q
    # split at the middle block boundary
    half = len(Ds) // 2
    B = Es[half - 1]  # couples block half-1 (end of left) to half (right)
    U, s, Vt = np.linalg.svd(B, full_matrices=False)
    r = int(np.sum(s > max(atol, 0.0)))
    U, s, Vt = U[:, :r], s[:r], Vt[:r]

    # modified halves: subtract s_j v_j v_j^T from the LAST diag block of
    # the left half (B acts on left-half coords through V^T) and
    # s_j u_j u_j^T from the FIRST diag block of the right half
    DsL = [D.copy() for D in Ds[:half]]
    DsR = [D.copy() for D in Ds[half:]]
    if r:
        DsL[-1] -= (Vt.T * s) @ Vt
        DsR[0] -= (U * s) @ U.T
    wL, QL = _bdc_rec(DsL, list(Es[:half - 1]), atol, cutoff)
    wR, QR = _bdc_rec(DsR, list(Es[half:]), atol, cutoff)

    nL = wL.size
    w = np.concatenate([wL, wR])
    Q = np.zeros((n, n))
    Q[:nL, :nL] = QL
    Q[nL:, nL:] = QR

    # r sequential rank-one updates: w_j = [.. v_j | u_j ..]
    bL = Ds[half - 1].shape[0]
    bR = Ds[half].shape[0]
    for j in range(r):
        wvec = np.zeros(n)
        wvec[nL - bL:nL] = Vt[j]
        wvec[nL:nL + bR] = U[:, j]
        # wvec is nonzero only on the 2 coupled blocks: restrict the
        # projection to those rows
        z = Q[nL - bL:nL + bR].T @ wvec[nL - bL:nL + bR]
        # approximate mode: deflate at the same absolute accuracy the SVD
        # truncation targets (dsbtdc's tol-driven dlaed deflation)
        w, Q = dpr1_eig(w, z, s[j],
                        deflate_tol=atol if atol > 0.0 else None, basis=Q)
    order = np.argsort(w, kind="stable")
    return w[order], Q[:, order]
