"""Krylov factorization loops (``slepc_tpu/bv/krylov.py``).

Per column j: apply the operator, then orthonormalize against the rows
before it, harvesting the projection coefficients.  The basis is the port's
row-major (nc + mmax + 1, n) tensor, updated in place; H is a host numpy
array.  The SpMV is the operator's kernel, the CGS2 sweeps run on kernel K3
(``bv/orthog.py``), and the host reads one small vector per column (the
coefficients and the two norms).

Full reorthogonalization serves both Arnoldi and Lanczos (Hermitian and
B-Hermitian operators): the Lanczos tridiagonal is read off the projected
coefficients.  The pseudo-Lanczos recurrence of an indefinite B (GHIEP)
passes the signature ``omega`` (host numpy, updated in place): the sweeps
scale their coefficients by it (``bv/orthog.py``), H's subdiagonal takes the
signed norm and omega the sign of each new vector.  Not ported:
``arnoldi_extend_host`` and the ``host_callback`` routing (PyTorch runs
eagerly, so an operator whose apply is a host solve goes through the same
loop).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..sys.events import log_event
from .orthog import orthogonalize_vec


def arnoldi_extend(op, V: torch.Tensor, H: np.ndarray, k: int, m: int,
                   nc: int = 0, Bop=None, passes: int = 2,
                   rng: Optional[np.random.Generator] = None,
                   omega: Optional[np.ndarray] = None):
    """Extend an Arnoldi factorization A V_k = V_k H_k from k to m vectors.

    Args:
      op:   operator with ``mult`` on V's device (possibly ST-transformed).
      V:    (nc + mmax+1, n) basis; rows [0, nc+k] filled (nc constraint
            rows first); updated in place.
      H:    (mmax+1, mmax) host coefficient array, updated in place.
      k, m: extend vectors [k, m).
      Bop:  optional inner-product operator (B metric, GHEP).
      rng:  numpy generator for breakdown restarts (seeded by default).
      omega: optional (nc + mmax+1,) signature for an indefinite B
            (pseudo-Lanczos, GHIEP), updated in place.
    Returns:
      (V, H, beta, breakdown): beta = |H[m, m-1]|, breakdown True if a
      linear dependence forced a random restart vector.
    """
    eps = float(torch.finfo(V.dtype).eps)
    Bmult = None if Bop is None else Bop.mult
    rng = rng if rng is not None else np.random.default_rng(4321)
    brk = False
    for j in range(k, m):
        Vact = V[: nc + j + 1]
        w = op.mult(V[nc + j])
        om = None if omega is None else omega[: nc + j + 1]
        w, c_tot, nb, na = orthogonalize_vec(Vact, w, Bmult, passes=passes,
                                             omega=om)
        host = torch.cat([c_tot, nb[None], na[None]]).cpu().numpy()
        nrm_before, beta = abs(host[-2].real), abs(host[-1].real)
        sgn = -1.0 if host[-1].real < 0 else 1.0
        is_brk = beta < eps ** 0.75 * (nrm_before + eps)
        if is_brk:
            brk = True
            # real normals for a complex basis too, as the reference
            rnd = torch.from_numpy(rng.standard_normal(V.shape[1])).to(
                V.device, V.dtype)
            w, _, _, na2 = orthogonalize_vec(Vact, rnd, Bmult, passes=passes,
                                             omega=om)
            beta = abs(float(na2))
        torch.div(w, beta if beta > 0 else 1.0, out=V[nc + j + 1])
        H[:, j] = 0
        H[: j + 1, j] = host[nc: nc + j + 1]
        H[j + 1, j] = 0.0 if is_brk else sgn * beta
        if omega is not None:
            omega[nc + j + 1] = sgn
    return V, H, (abs(H[m, m - 1]) if m > 0 else 0.0), brk


def lanczos_extend(op, V, alpha: np.ndarray, beta_arr: np.ndarray, k: int,
                   m: int, nc: int = 0, Bop=None):
    """Hermitian Lanczos with full reorthogonalization: runs the Arnoldi
    loop and extracts alpha[j] = H[j, j], beta[j] = H[j+1, j].  Returns
    (V, alpha, beta_arr, beta_m, breakdown)."""
    mmax = alpha.shape[0]
    H = np.zeros((mmax + 1, mmax), dtype=alpha.dtype)
    idx = np.arange(k)
    H[idx, idx] = alpha[:k]
    H[idx + 1, idx] = beta_arr[:k]
    up = idx[idx < mmax - 1]
    H[up, up + 1] = beta_arr[up]
    V, H, beta, brk = arnoldi_extend(op, V, H, k, m, nc, Bop)
    ar = np.arange(mmax)
    return V, H[ar, ar].copy(), H[ar + 1, ar].copy(), beta, brk


def extend_dispatch(op, V, H, k, m, nc=0, Bop=None, omega=None):
    """The extension under its ``BV_MatArnoldi`` event (flops: SpMV + CGS2
    per column); ``omega`` as in :func:`arnoldi_extend`."""
    n = V.shape[1]
    nnz = getattr(op, "nnz", 2 * n)
    with log_event("BV_MatArnoldi",
                   flops=(m - k) * (2.0 * nnz + 8.0 * n * m)):
        return arnoldi_extend(op, V, H, k, m, nc, Bop, omega=omega)
