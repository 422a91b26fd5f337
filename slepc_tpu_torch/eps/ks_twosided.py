"""Coupled two-sided Krylov-Schur (BiKS) (``slepc_tpu/eps/ks_twosided.py``).

Two Arnoldi factorizations advance together, V for Op and W for Op^H, and
are coupled through the oblique interaction matrix M = W^H V:

  * after each extension the next right vector is made obliquely orthogonal
    to the left basis, v <- v - V M^{-1} W^H v, and the next left vector to
    the right basis; the corrections fold into the last columns of the two
    Rayleigh quotients, so the projected pair (S, T) stays exact;
  * the projected pair is solved as two Schur forms, the right one sorted
    and the left one matched to it by the nearest conj(theta) (the DSNHEPTS
    role);
  * a pair converges when both its right and its left estimate are below
    tol;
  * the thick restart rotates both bases (Q for V, Z for W) and
    re-orthonormalizes both residual vectors, their coefficients folded
    into the arrow rows;
  * the eigenvectors come from the locked Schur block, the left ones scaled
    so that YL^H A X is diagonal.

On the device: V and W are (ncv + 1, n) row-major in the complex type of
the operator's precision (complex128 for a float64 or complex128 operator;
the reference is complex128 always), updated in place.  The extensions are
``bv/krylov.py``'s (the operator's SpMV -- the adjoint's for W, a DIA
operator's on K1/K2 through its adjoint diagonals -- and CGS2 on K3c); a
real operator takes the complex vectors by their real and imaginary parts.
The oblique correction is a K3c dots sweep, an (nv x nv) host solve and a
K3c update; M is one matrix product; both rotations are K4c, in place.
Inside the loop only M, S, T, coefficient vectors and norms go to the host;
the start vectors come from ``default_rng(0)`` as the reference draws them.
``eps.coupling_seconds`` is the wall time the run spent forming M and the
two oblique corrections, ``eps.expansions`` the columns each side grew.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..bv.krylov import extend_dispatch
from ..ds.schur import schur, sort_schur
from ..ds.types import match_conj
from ..mat.linop import AdjointOperator, ShellOperator, apply_by_parts
from ..ops.bv import panel_dots, panel_update
from ..ops.rotate import rotate
from .base import EPSConvergedReason, basis_combine, normalize_rows


def _complex_ops(op, cdtype):
    """(op, op^H) on complex vectors of ``cdtype``: a real operator applies
    to their real and imaginary parts."""
    if op.dtype == cdtype:
        return op, AdjointOperator(op)
    fwd = ShellOperator(op.shape, cdtype,
                        lambda x: apply_by_parts(op.mult, x, op.dtype),
                        lambda x: apply_by_parts(op.mult_h, x, op.dtype),
                        nnz=op.nnz, device=op.device)
    return fwd, AdjointOperator(fwd)


def _start(rng, n, device, cdtype):
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return torch.from_numpy(v).to(device, cdtype)


def _project_out(B: torch.Tensor, r: torch.Tensor):
    """r - B^T (B^H r) for the rows of B (one K3c dots, one K3c update):
    (the new vector, the coefficients B^H r on the device)."""
    if B.shape[0] == 0:
        return r, torch.zeros(0, dtype=r.dtype, device=r.device)
    c = panel_dots(B, r[None])
    return panel_update(B, c, r[None])[0], c[:, 0]


def twosided_solve(eps) -> None:
    st = eps.st
    op = st.op()
    n, ncv, nev, mpd = eps.n, eps.ncv, eps.nev, eps.mpd
    device = eps.A.device
    cdtype = torch.complex64 if op.dtype in (torch.float32, torch.complex64) \
        else torch.complex128
    opc, opH = _complex_ops(op, cdtype)
    sc = eps.sort_criterion()

    def on_device(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, cdtype)

    rng = np.random.default_rng(0)
    v0 = _start(rng, n, device, cdtype)
    w0 = _start(rng, n, device, cdtype)
    if eps.initial_space is not None:
        v0 = on_device(eps.initial_space[:, 0].astype(complex))
    V = torch.zeros((ncv + 1, n), dtype=cdtype, device=device)
    W = torch.zeros((ncv + 1, n), dtype=cdtype, device=device)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    W[0] = w0 / torch.linalg.vector_norm(w0)
    S = np.zeros((ncv + 1, ncv), complex)
    T = np.zeros((ncv + 1, ncv), complex)

    k = l = 0
    eigs_locked = np.zeros(ncv, complex)
    err_locked = np.zeros(ncv)
    Slock = np.zeros((ncv, ncv), complex)
    eps.its = 0
    eps.coupling_seconds = 0.0

    while eps.its < eps.max_it:
        eps.its += 1
        nv = min(k + mpd, ncv)

        # ---- extend both factorizations ----
        _, S, beta, brkv = extend_dispatch(opc, V, S, k + l, nv)
        _, T, betat, brkw = extend_dispatch(opH, W, T, k + l, nv)
        brk = brkv or brkw
        eps.expansions += nv - (k + l)  # the columns of one side

        # ---- oblique coupling: v - V M^{-1} W^H v, w - W M^{-H} V^H w ----
        t0 = time.perf_counter()
        Vn, Wn = V[:nv], W[:nv]
        M = (Wn.conj() @ Vn.mT).cpu().numpy()
        rhs = torch.cat([panel_dots(Wn, V[nv][None]),
                         panel_dots(Vn, W[nv][None])], dim=1).cpu().numpy()
        try:
            wv = np.linalg.solve(M, rhs[:, 0])
            ww = np.linalg.solve(M.conj().T, rhs[:, 1])
        except np.linalg.LinAlgError:
            eps.reason = EPSConvergedReason.DIVERGED_BREAKDOWN
            break
        vres = panel_update(Vn, on_device(wv[:, None]), V[nv][None])[0]
        wres = panel_update(Wn, on_device(ww[:, None]), W[nv][None])[0]
        S[:nv, nv - 1] += beta * wv
        T[:nv, nv - 1] += betat * ww
        vnorm, wnorm = torch.stack([torch.linalg.vector_norm(vres),
                                    torch.linalg.vector_norm(wres)]).tolist()
        eps.coupling_seconds += time.perf_counter() - t0

        # ---- projected two-sided solve (the DSNHEPTS role) ----
        TS, Q, theta = schur(S[k:nv, k:nv])
        TS, Q, theta = sort_schur(TS, Q, sc.keys(st.back_transform(theta)))
        lam_approx = st.back_transform(theta)
        # the left Schur form ordered to match the right values (theta_T ~
        # conj(theta_S)); its keys are the ranks of the matched right values
        TT, Z, thetl = schur(T[k:nv, k:nv])
        na = nv - k
        rank = np.zeros(na)
        rank[match_conj(theta, thetl)] = np.arange(na)
        TT, Z, thetl = sort_schur(TT, Z, rank)

        # ---- convergence: both residual estimates ----
        lastS, lastT = Q[na - 1, :], Z[na - 1, :]
        resid = np.maximum(beta * vnorm * np.abs(lastS),
                           betat * wnorm * np.abs(lastT))
        errest = np.array([eps.conv_measure(theta[i], resid[i])
                           for i in range(na)])
        if eps.rg is not None:
            errest = np.where(eps.rg.check_inside(lam_approx) < 0, np.inf,
                              errest)
        k2 = k
        while k2 < nv and errest[k2 - k] < eps.tol:
            k2 += 1
        eps.nconv = k2
        eps.monitor(eps, eps.its, k2,
                    np.concatenate([eigs_locked[:k], lam_approx]),
                    np.concatenate([err_locked[:k], errest]))
        done = k2 >= nev or eps.its >= eps.max_it
        if eps.stopping is not None:
            done = eps.stopping(eps, eps.its, k2, nev) or done
        l = 0 if done else min(max(1, int(0.5 * (nv - k2))),
                               max(nv - k2 - 1, 0))
        kl = (k2 - k) + l

        eigs_locked[k:k2] = lam_approx[: k2 - k]
        err_locked[k:k2] = errest[: k2 - k]
        Slock[k:k2, k:k2] = TS[: k2 - k, : k2 - k]
        Slock[:k, k:k2] = S[:k, k:nv] @ Q[:, : k2 - k]

        if kl > 0:
            # ---- rotate both bases (K4c, in place) ----
            rotate(on_device(Q[:, :kl]), V[k:nv], out=V[k: k + kl])
            rotate(on_device(Z[:, :kl]), W[k:nv], out=W[k: k + kl])
            S2 = np.zeros_like(S)
            T2 = np.zeros_like(T)
            S2[:k2, :k2] = Slock[:k2, :k2]
            T2[:k2, :k2] = np.diag(np.conj(np.diag(Slock))[:k2])
            if not done and l > 0:
                kept = slice(k2 - k, kl)
                S2[k2: k2 + l, k2: k2 + l] = TS[kept, kept]
                S2[k:k2, k2: k2 + l] = TS[: k2 - k, kept]
                S2[:k, k2: k2 + l] = S[:k, k:nv] @ Q[:, kept]
                T2[k2: k2 + l, k2: k2 + l] = TT[kept, kept]
                T2[k:k2, k2: k2 + l] = TT[: k2 - k, kept]
                T2[:k, k2: k2 + l] = T[:k, k:nv] @ Z[:, kept]
                # the arrow rows from the oblique residual vectors
                S2[k2 + l, k2: k2 + l] = beta * lastS[kept]
                T2[k2 + l, k2: k2 + l] = betat * lastT[kept]
            if not done:
                # ---- the residual vectors re-orthonormalized, their
                # coefficients folded into the arrows ----
                for B, res, H2 in ((V, vres, S2), (W, wres, T2)):
                    r2, c = _project_out(B[: k2 + l], res)
                    nrm = torch.linalg.vector_norm(r2)[None].to(c.dtype)
                    host = torch.cat([c, nrm]).cpu().numpy()
                    cB, nrm = host[:-1], float(host[-1].real)
                    if nrm < 1e-300:
                        brk = True
                        continue
                    B[k2 + l] = r2 / nrm
                    H2[: k2 + l, k2: k2 + l] += np.outer(
                        cB, H2[k2 + l, k2: k2 + l])
                    H2[k2 + l, k2: k2 + l] *= nrm
            S, T = S2, T2
        k = k2
        if done:
            break
        if brk:
            # restart both factorizations from fresh random directions
            rv, _ = _project_out(V[:k], _start(rng, n, device, cdtype))
            rw, _ = _project_out(W[:k], _start(rng, n, device, cdtype))
            nv_, nw_ = torch.stack([torch.linalg.vector_norm(rv),
                                    torch.linalg.vector_norm(rw)]).tolist()
            if nv_ < 1e-300 or nw_ < 1e-300:
                eps.reason = EPSConvergedReason.DIVERGED_BREAKDOWN
                break
            V[k] = rv / nv_
            W[k] = rw / nw_
            l = 0

    # ---- finalize: eigenpairs from the locked Schur block ----
    eps.nconv = k
    eps.V = None
    if k > 0:
        wv, Y = np.linalg.eig(Slock[:k, :k])
        X = normalize_rows(basis_combine(V[:k], Y))
        # left vectors in span(W): YL = W M^{-H} Y^{-H}, so YL^H A X is
        # diagonal
        Mk = (W[:k].conj() @ V[:k].mT).cpu().numpy()
        try:
            C = np.linalg.solve(Mk.conj().T, np.linalg.inv(Y).conj().T)
            YL = normalize_rows(basis_combine(W[:k], C))
        except np.linalg.LinAlgError:
            YL = W[:k].clone()
        eps.eigenvalues = np.asarray(st.back_transform(wv), dtype=complex)
        eps._eigenvectors = X
        eps._left_eigenvectors = YL
        eps.errests = err_locked[:k].copy()
    else:
        eps.eigenvalues = np.zeros(0, complex)
        eps._eigenvectors = torch.zeros((0, n), dtype=cdtype, device=device)
        eps._left_eigenvectors = torch.zeros((0, n), dtype=cdtype,
                                             device=device)
        eps.errests = np.zeros(0)
