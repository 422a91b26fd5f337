"""EPS explicitly restarted Arnoldi and Lanczos (``slepc_tpu/eps/explicit.py``).

Both extend the basis with ``bv/krylov.py``'s Arnoldi loop (the operator's
SpMV, then CGS2 on kernel K3 per column), solve the projected problem on
the host (eigh, or the real Schur form sorted with its 2x2 blocks whole),
lock the converged leading vectors and restart from the best unconverged
Ritz vector (one K4 rotation).  No thick restart: that is Krylov-Schur's.
A non-Hermitian run returns eigenvectors, from the projection of the
operator on the locked Schur vectors (the reference returns the Schur
vectors).

Lanczos on a standard Hermitian problem takes the reference's light
reorthogonalizations (``set_reorthogonalization``): 'local' (the bare
three-term recurrence plus CGS2 against the locked rows), 'selective'
(Parlett-Scott: nearly converged Ritz vectors of the running tridiagonal
are formed once, and every later Lanczos vector is kept orthogonal to
them) and 'periodic' (a full CGS2 sweep every ``reorth_period`` columns);
each orthogonalization is CGS2 on K3.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..bv.bv import BV
from ..bv.krylov import extend_dispatch
from ..bv.orthog import gram, orthogonalize_vec
from ..ds.schur import schur, sort_schur
from ..mat.linop import LinearOperator
from ..ops.rotate import rotate
from .base import (EPS, EPSSolver, basis_combine, normalize_rows,
                   start_vector, work_dtype)
from .krylovschur import _pair_keys, _ritz_coefficients
from .ks_jit import _np_dtype


def _lanczos_run_host(op, V: torch.Tensor, kstart: int, m: int, nc: int,
                      mode: str, period: int, nsel_max: int):
    """Lanczos run from row ``kstart`` to ``m`` with a light
    reorthogonalization (``mode``: local, selective, periodic) on the
    row-major basis V (updated in place).  Returns (V, H, beta,
    breakdown); one host read per column."""
    sqeps = float(np.sqrt(torch.finfo(V.dtype).eps))
    H = np.zeros((m + 1, m))
    sel: list = []  # formed Ritz vectors (Parlett-Scott)
    sel_vals: list = []
    alphas: list = []
    betas: list = []
    base = V[: nc + kstart] if nc + kstart > 0 else None

    def fill_tridiagonal():
        for i, a in enumerate(alphas):
            H[kstart + i, kstart + i] = a
        for i, b in enumerate(betas):
            H[kstart + i + 1, kstart + i] = b
            H[kstart + i, kstart + i + 1] = b

    beta = 0.0
    for j in range(kstart, m):
        v = V[nc + j]
        w = op.mult(v)
        if j > kstart:
            w = w - betas[-1] * V[nc + j - 1]
        alpha = float(torch.vdot(v, w).real)
        w = w - alpha * v
        alphas.append(alpha)
        # locked rows and deflation constraints: always (CGS2)
        if base is not None:
            w = orthogonalize_vec(base, w)[0]
        if mode == "selective" and sel:
            w = orthogonalize_vec(torch.stack(sel), w)[0]
        if mode == "periodic" and \
                (j - kstart) % max(period, 1) == max(period, 1) - 1:
            w = orthogonalize_vec(V[nc: nc + j + 1], w)[0]
        beta = float(torch.linalg.vector_norm(w))
        nrm_T = max([abs(a) for a in alphas] + betas + [1e-300])
        if beta < 1e-12 * nrm_T:
            H[kstart + len(alphas), kstart + len(alphas) - 1] = 0.0
            fill_tridiagonal()
            return V, H, 0.0, True
        V[nc + j + 1] = w / beta
        if mode == "selective" and len(alphas) >= 2 and len(sel) < nsel_max:
            th, S = sla.eigh_tridiagonal(np.asarray(alphas),
                                         np.asarray(betas))
            bounds = beta * np.abs(S[-1, :])
            for i in np.argsort(bounds):
                if bounds[i] >= sqeps * nrm_T or len(sel) >= nsel_max:
                    break
                if any(abs(th[i] - tv) < 1e-8 * nrm_T for tv in sel_vals):
                    continue
                y = rotate(torch.from_numpy(np.ascontiguousarray(
                    S[:, i: i + 1])).to(V.device, V.dtype),
                    V[nc + kstart: nc + j + 1])[0]
                sel.append(y / torch.linalg.vector_norm(y))
                sel_vals.append(th[i])
        betas.append(beta)
    betas = betas[:-1]
    fill_tridiagonal()
    H[m, m - 1] = beta
    return V, H, beta, False


class _ExplicitRestartKrylov(EPSSolver):
    hermitian_only = False

    def solve(self, eps: EPS) -> None:
        st = eps.st
        op = st.op()
        n, ncv, nev = eps.n, eps.ncv, eps.nev
        dtype, device = work_dtype(eps, op), eps.A.device
        cplx = dtype.is_complex
        hermitian = eps.is_hermitian or self.hermitian_only
        sc = eps.sort_criterion()
        Bip = eps.B if (eps.problem_type.value == "ghep"
                        and eps.B is not None) else None

        V = BV(n, ncv + 1, dtype, device=device)
        if Bip is not None:
            V.set_matrix(Bip)
        nc = 0
        if eps.deflation_space is not None:
            nc = V.insert_constraints(eps.deflation_space.T)
        v0 = start_vector(np.random.default_rng(0), n, dtype)
        if eps.initial_space is not None:
            v0 = np.asarray(eps.initial_space[:, 0])
        V.set_column(0, v0)
        V.orthonormalize_column(0, replace_lindep=True)

        k = 0  # locked
        lams = np.zeros(ncv, dtype=complex)
        errs = np.zeros(ncv)
        use_light = (hermitian and Bip is None
                     and eps.reorth in ("local", "selective", "periodic"))

        while eps.its < eps.max_it and k < nev:
            eps.its += 1
            if use_light:
                _, H, beta, _ = _lanczos_run_host(
                    op, V.array, k, ncv, nc, eps.reorth,
                    int(eps.reorth_period or 4), nsel_max=nev + 4)
            else:
                H = np.zeros((ncv + 1, ncv), _np_dtype(dtype))
                _, H, beta, _ = extend_dispatch(op, V.array, H, k, ncv,
                                                nc=nc, Bop=Bip)
            S = H[k:ncv, k:ncv]
            na = ncv - k
            T = None
            if hermitian:
                theta, Q = np.linalg.eigh(0.5 * (S + S.conj().T))
                theta = theta.astype(complex)
                order = np.argsort(sc.keys(st.back_transform(theta)),
                                   kind="stable")
                theta, Q = theta[order], Q[:, order]
            else:
                T, Q, theta = schur(S)
                keys = sc.keys(st.back_transform(theta))
                if not cplx:  # a complex Schur form has no pairs
                    keys = _pair_keys(T, keys)
                T, Q, theta = sort_schur(T, Q, keys)
            resid = beta * np.abs(Q[na - 1, :])
            if T is not None and not cplx:
                i = 0
                while i < na:
                    if i + 1 < na and T[i + 1, i] != 0.0:
                        resid[i] = resid[i + 1] = np.hypot(resid[i],
                                                           resid[i + 1])
                        i += 2
                    else:
                        i += 1
            errest = np.array([eps.conv_measure(theta[i], resid[i])
                               for i in range(na)])
            k2 = k
            while k2 < ncv and errest[k2 - k] < eps.tol:
                k2 += 1
            if T is not None and not cplx:
                d = k2 - k
                if 0 < d < na and T[d, d - 1] != 0.0:
                    k2 -= 1
            # lock the converged; else restart from the best Ritz vector
            keep = max(k2 - k, 1)
            rotate(torch.from_numpy(np.ascontiguousarray(Q[:, :keep])).to(
                device, dtype), V.array[nc + k: nc + ncv],
                out=V.array[nc + k: nc + k + keep])
            lams[k:k2] = theta[: k2 - k]
            errs[k:k2] = errest[: k2 - k]
            eps.monitor(eps, eps.its, k2,
                        st.back_transform(np.concatenate([lams[:k], theta])),
                        np.concatenate([errs[:k], errest]))
            if k2 == k:
                # no progress: the restart vector (the best unconverged
                # Ritz vector, now row k) is orthonormalized again
                V.set_active_columns(0, k + 1)
                V.orthonormalize_column(k, replace_lindep=True)
            k = k2

        eps.nconv = k
        lam = np.asarray(st.back_transform(lams[:k]))
        eps.eigenvalues = lam.real if np.all(np.abs(np.imag(lam)) < 1e-14) \
            else lam
        eps.errests = errs[:k].copy()
        X = V.array[nc: nc + k].clone()
        if not hermitian and k > 0:
            X = _locked_eigenvectors(op, X, lams[:k])
        eps._eigenvectors = X


def _locked_eigenvectors(op, X: torch.Tensor, theta: np.ndarray):
    """Eigenvectors from the locked Schur vectors X (rows): the Ritz
    vectors of X Op X^T, each locked value taking the nearest eigenvalue's
    vector.  The reference returns the Schur vectors themselves
    (slepc_tpu/eps/explicit.py:225), which are not eigenvectors of a
    non-normal operator."""
    T = gram(X, LinearOperator.block_of(op)(X)).cpu().numpy()
    return normalize_rows(basis_combine(
        X, _ritz_coefficients(T, np.eye(len(theta)), theta)))


class Arnoldi(_ExplicitRestartKrylov):
    """Explicitly restarted Arnoldi (reference arnoldi.c)."""


class Lanczos(_ExplicitRestartKrylov):
    """Explicitly restarted Lanczos: full reorthogonalization, or a light
    one (reference lanczos.c, EPSLanczosReorthogType)."""

    hermitian_only = True


EPS.register("arnoldi", Arnoldi)
EPS.register("lanczos", Lanczos)
