"""Orthogonalization on raw row-major basis tensors
(``slepc_tpu/bv/orthog.py``).

Layout: the port's basis is (m, n), row k = basis vector k (the transposed
basis of ``eps/ks_jit.py``), so "the previous columns" of the reference are
a contiguous row prefix ``V[:j]`` and the reference's 0/1 masks have no
counterpart: the caller slices.  A block X is (k, n), its rows the vectors.

  * Column orthogonalization is classical Gram-Schmidt with ``passes``
    sweeps (CGS2 by default), each sweep one ``panel_dots`` + one
    ``panel_update`` on kernel K3 (``ops/bv.py``; for a complex basis the
    dots are conjugate inner products <v_k, w> = v_k^H w and the update
    w - sum_k c_k v_k takes no conjugate); with an identity metric
    the middle sweeps are the fused ``panel_update_dots``.  A B-metric
    passes ``Bmult`` and sweeps ``panel_dots(V, B w)``.
  * Norms come back as 0-d tensors on the basis' device, so a caller that
    wants one host read per column can make it.
  * An indefinite metric (GHIEP's pseudo-Lanczos) passes the signature
    ``omega`` (+-1 a basis row): each sweep's coefficients are scaled,
    h = c * omega, between the dots sweep and the update sweep, so K3 runs
    unchanged; the norms are signed, sign(w^H B w) sqrt|w^H B w|.
  * Block orthonormalization: CholeskyQR / CholeskyQR2 (Gram on K3,
    Cholesky of the small Gram matrix on the host in LAPACK, triangular
    solve as a rotation on kernel K4), SVQB (with a signature too) and
    modified Gram-Schmidt.

Not ported: ``tsqr`` / ``tsqr_shard_map`` (the multi-device TSQR, ROADMAP
queue 1 item 16).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.bv import panel_dots, panel_update, panel_update_dots
from ..ops.rotate import rotate

ETA = 0.7071067811865476  # refinement criterion of the reference's BV
_PANEL = 8  # widest panel kernel K3 takes


def _safe_sqrt(nsq: torch.Tensor) -> torch.Tensor:
    """Signed sqrt of a possibly-indefinite squared norm."""
    return torch.sign(nsq) * torch.sqrt(nsq.abs())


def gram(V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """G[k, m] = <V[k], W[m]> for row blocks V (K, n), W (b, n), on K3 in
    panels of at most 8 rows of W."""
    if W.shape[0] <= _PANEL:
        return panel_dots(V, W)
    return torch.cat([panel_dots(V, W[i: i + _PANEL])
                      for i in range(0, W.shape[0], _PANEL)], dim=1)


def orthogonalize_vec(V: torch.Tensor, w: torch.Tensor,
                      Bmult: Optional[Callable] = None, passes: int = 2,
                      omega: Optional[np.ndarray] = None):
    """Orthogonalize w against the rows of V (CGS, ``passes`` sweeps).

    Returns (w, c_total, norm_before, norm_after): c_total (K,) the summed
    projection coefficients, the norms 0-d tensors in the B metric (signed
    for an indefinite one).  ``omega``: the (K,) signature of V's rows;
    each sweep subtracts sum_k c_k omega_k V[k].  No host read.  With no
    rows in V, w comes back as it is."""
    Bw = w if Bmult is None else Bmult(w)
    norm_before = _safe_sqrt(torch.vdot(w, Bw).real)
    if V.shape[0] == 0:
        return w, torch.zeros(0, dtype=w.dtype, device=w.device), \
            norm_before, norm_before
    om = None if omega is None else torch.from_numpy(
        np.ascontiguousarray(omega, dtype=np.float64)).to(
            w.device, w.real.dtype)[:, None]

    def h(c):
        return c if om is None else c * om

    wp = w[None]
    c = panel_dots(V, Bw[None])
    c_total = c.clone()
    for _ in range(passes - 1):
        if Bmult is None:
            wp, c = panel_update_dots(V, h(c), wp)
        else:
            wp = panel_update(V, h(c), wp)
            c = panel_dots(V, Bmult(wp[0])[None])
        c_total += c
    w = panel_update(V, h(c), wp)[0]
    Bw = w if Bmult is None else Bmult(w)
    return w, c_total[:, 0], norm_before, _safe_sqrt(torch.vdot(w, Bw).real)


# ---------------------------------------------------------------------------
# block orthonormalization (rows of X)
# ---------------------------------------------------------------------------


def _herm(G):
    return 0.5 * (G + G.conj().T)


def _bmult_rows(X: torch.Tensor, Bmult: Optional[Callable]) -> torch.Tensor:
    if Bmult is None:
        return X
    return torch.stack([Bmult(X[i]) for i in range(X.shape[0])])


def _gram_host(X, Bmult) -> np.ndarray:
    return _herm(gram(X, _bmult_rows(X, Bmult)).cpu().numpy())


def _apply_right_inverse(X: torch.Tensor, R: np.ndarray) -> torch.Tensor:
    """Q with X = R^T Q for upper-triangular R (columns: X = Q R): the
    rotation R^{-1} on kernel K4."""
    Rinv = np.linalg.solve(R, np.eye(R.shape[0], dtype=R.dtype))
    return rotate(torch.from_numpy(np.ascontiguousarray(Rinv)).to(
        X.device, X.dtype), X)


def cholqr(X: torch.Tensor, Bmult: Optional[Callable] = None,
           shift: float = 0.0) -> Tuple[torch.Tensor, np.ndarray]:
    """One CholeskyQR sweep of the rows of X: returns (Q, R) with R a host
    array and X = R^T Q (X_cols = Q_cols R)."""
    G = _gram_host(X, Bmult)
    if shift:
        G = G + shift * np.eye(G.shape[0], dtype=G.dtype)
    R = np.linalg.cholesky(G).conj().T  # upper
    return _apply_right_inverse(X, R), R


def cholqr2(X: torch.Tensor, Bmult: Optional[Callable] = None):
    """CholeskyQR2: two sweeps give CGS2-grade orthogonality.  When the
    Gram matrix is numerically indefinite (rank-deficient input) the first
    sweep retries with the diagonal shift 11 (m n eps) ||G||."""
    G = _gram_host(X, Bmult)
    try:
        R1 = np.linalg.cholesky(G).conj().T
    except np.linalg.LinAlgError:
        eps = float(torch.finfo(X.dtype).eps)
        shift = 11.0 * (X.shape[0] * X.shape[1]) * eps * np.linalg.norm(G)
        R1 = np.linalg.cholesky(
            G + shift * np.eye(G.shape[0], dtype=G.dtype)).conj().T
    Q = _apply_right_inverse(X, R1)
    Q, R2 = cholqr(Q, Bmult)
    return Q, R2 @ R1


def svqb(X: torch.Tensor, Bmult: Optional[Callable] = None,
         omega: Optional[np.ndarray] = None):
    """SVQB orthonormalization (Stathopoulos & Wu): scale by the Gram
    diagonal, eigendecompose, Q_cols = X_cols D^-1/2 U Lambda^-1/2; with a
    signature ``omega`` (indefinite metric) the Gram's rows are scaled by
    it first.  Returns (Q, T) with Q = T^T X."""
    eps = float(torch.finfo(X.dtype).eps)
    G = _gram_host(X, Bmult)
    if omega is not None:
        G = G * np.asarray(omega)[:, None]
    ds = 1.0 / np.sqrt(np.abs(np.real(np.diagonal(G))) + eps)
    lam, U = np.linalg.eigh(_herm(G * ds[:, None] * ds[None, :]))
    T = (ds[:, None] * U) * (1.0 / np.sqrt(np.abs(lam) + eps))[None, :]
    return rotate(torch.from_numpy(np.ascontiguousarray(T)).to(
        X.device, X.dtype), X), T


def mgs_block(X: torch.Tensor, Bmult: Optional[Callable] = None):
    """Gram-Schmidt over the rows of X, one row after another (CGS2 per
    row against the rows before it).  Returns (Q, R), R a host array with
    X_cols = Q_cols R."""
    m = X.shape[0]
    Q = X.clone()
    R = np.zeros((m, m), dtype=torch.empty((), dtype=X.dtype).numpy().dtype)
    for j in range(m):
        w, c, _, nrm = orthogonalize_vec(Q[:j], Q[j], Bmult, passes=2)
        nrm = float(nrm)
        Q[j] = w / nrm
        R[:j, j] = c.cpu().numpy()
        R[j, j] = nrm
    return Q, R
