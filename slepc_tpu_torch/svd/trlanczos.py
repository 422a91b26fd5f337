"""Thick-restart Golub-Kahan-Lanczos bidiagonalization
(``slepc_tpu/svd/trlanczos.py``).

Two-sided GK recurrence -- per step one apply of A and one of A^H, each
followed by a full CGS2 reorthogonalization -- with thick restarts that
keep the best Ritz triplets, and the GSVD of a pair by the joint
bidiagonalization of Z = [A; B].

Layout: the bases live on the operator's device in the port's row layout,
U (ncv, m) and V (ncv + 1, n), row k basis vector k.  A step's SpMVs are
A's own ``mult`` / ``mult_h`` (K1/K2 on DIA, K6 on CSR and its adjoint CSR,
the complex instantiations for a complex A); its CGS2 is two sweeps of the
panel kernel K3 / K3c (``bv/orthog.py``); the thick restart's rotations
U[k:m] <- P^T U[k:m] and V[k:m] <- Q^T V[k:m] are the rotation kernel K4 /
K4c in place.  The full CGS2 harvest makes the projected matrix
B = U^H A V exact, restart arrow included, so the host SVDs the small
active block after each extension (the DSSVD role); the residual estimate
is beta |last row of P| (A^H U = V B^H + beta v_m e_m^T).  The extension
normalizes each new vector on the device and writes B's column there: one
host read of B and beta a restart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bv.orthog import orthogonalize_vec
from ..eps.base import op_mult_block
from ..eps.ks_jit import _mat, _np_dtype
from ..ksp.ksp import KSP
from ..mat.linop import (AIJOperator, DenseOperator, DIAOperator,
                         LinearOperator, ShellOperator)
from ..ops.bv import panel_update
from ..ops.rotate import rotate


def _default_tol(dtype: torch.dtype) -> float:
    """1e-8 for float64 / complex128, 1e-5 for float32 / complex64 (the
    reference takes the itemsize of the whole type, so complex64 gets
    1e-8 there)."""
    return 1e-8 if torch.finfo(dtype).bits >= 64 else 1e-5


def _unit(w: torch.Tensor, nrm: torch.Tensor, out: torch.Tensor) -> None:
    """out = w / nrm, or w where nrm is 0 (the reference's safe divide),
    on the device."""
    torch.div(w, torch.where(nrm > 0, nrm, torch.ones_like(nrm)), out=out)


def _start(n: int, np_dtype, rng) -> np.ndarray:
    """A normalized Gaussian start vector (Re + i Im for a complex type)."""
    v = rng.standard_normal(n)
    if np.issubdtype(np_dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(n)
    return v / np.linalg.norm(v)


def gk_extend(A: LinearOperator, U: torch.Tensor, V: torch.Tensor,
              Bmat: torch.Tensor, k: int, m: int):
    """Extend a GK factorization from k to m columns, in place.

    U (ncv, mrows) left basis rows; V (ncv + 1, ncols) right basis rows with
    row k the current start vector; Bmat (ncv, ncv) the projected U^H A V
    on the device, column j = [CGS2 coefficients of A v_j against U[:j];
    alpha_j; 0].  Returns beta_m as a 0-d device tensor (None when no step
    ran)."""
    beta = None
    for j in range(k, m):
        u, c, _, alpha = orthogonalize_vec(U[:j], A.mult(V[j]))
        _unit(u, alpha, U[j])
        Bmat[:, j] = 0
        Bmat[:j, j] = c
        Bmat[j, j] = alpha
        w, _, _, beta = orthogonalize_vec(V[: j + 1], A.mult_h(U[j]))
        _unit(w, beta, V[j + 1])
    return beta


def trlanczos_solve(svd) -> None:
    """Driver implementing the thick-restart loop on the SVD object."""
    A = svd.A
    mrows, ncols = A.shape
    dtype, dev = A.dtype, A.device
    np_dtype = _np_dtype(dtype)
    nsv = svd.nsv
    ncv = svd.ncv or min(min(mrows, ncols), max(2 * nsv, nsv + 15))
    ncv = min(ncv, min(mrows, ncols))
    tol = svd.tol if svd.tol is not None else _default_tol(dtype)
    max_it = svd.max_it or max(100, 2 * min(mrows, ncols) // ncv)
    largest = getattr(svd.which, "value", "largest") == "largest"

    U = torch.zeros((ncv, mrows), dtype=dtype, device=dev)
    V = torch.zeros((ncv + 1, ncols), dtype=dtype, device=dev)
    V[0] = torch.from_numpy(_start(ncols, np_dtype,
                                   np.random.default_rng(0))).to(dev, dtype)
    Bd = torch.zeros((ncv, ncv), dtype=dtype, device=dev)

    k = 0
    l = 0
    sig_locked = np.zeros(ncv)
    err_locked = np.zeros(ncv)
    svd.its = 0
    svd.gk_steps = 0

    while svd.its < max_it:
        svd.its += 1
        m = ncv
        beta_t = gk_extend(A, U, V, Bd, k + l, m)
        svd.gk_steps += m - (k + l)
        Bh = Bd.cpu().numpy()
        beta = 0.0 if beta_t is None else float(beta_t)
        S = Bh[k:m, k:m]
        P, sig, Qh = np.linalg.svd(S)
        Q = Qh.conj().T
        if not largest:
            P, sig, Q = P[:, ::-1], sig[::-1], Q[:, ::-1]
        # residual estimates: beta * |last row of P|
        resid = beta * np.abs(P[-1, :])
        errest = resid / np.where(sig > 1e-300, sig, 1.0)

        k2 = k
        while k2 < m and errest[k2 - k] < tol:
            k2 += 1
        done = k2 >= nsv or svd.its >= max_it
        l = 0 if done else max(1, int(0.5 * (m - k2)))
        l = min(l, max(m - k2 - 1, 0)) if not done else 0
        kl = (k2 - k) + l

        for i in range(k2 - k):
            sig_locked[k + i] = sig[i]
            err_locked[k + i] = errest[i]

        if kl > 0:
            # U[k:k+kl] = P[:, :kl]^T U[k:m], V likewise: K4 in place
            rotate(_mat(P[:, :kl], U), U[k:m], out=U[k: k + kl])
            rotate(_mat(Q[:, :kl], V), V[k:m], out=V[k: k + kl])
            Bh2 = np.zeros_like(Bh)
            for i in range(k):
                Bh2[i, i] = sig_locked[i]
            for i in range(kl):
                Bh2[k + i, k + i] = sig[i]
            Bd.copy_(_mat(Bh2, Bd))
            if not done:
                V[k2 + l].copy_(V[m])
        k = k2
        if done:
            break

    svd.nconv = min(k, nsv)
    kk = k
    svd.sigma = sig_locked[:kk].copy()
    Vk = V[:kk].clone()
    Vk /= torch.linalg.vector_norm(Vk, dim=1, keepdim=True).clamp_min(
        torch.finfo(dtype).tiny)
    svd.U = np.array(U[:kk].cpu().numpy().T, copy=True)
    svd.V = np.ascontiguousarray(Vk.cpu().numpy().T)
    svd._renormalize()
    # re-pair: u_i = A v_i / sigma_i exactly (the pairing after the final
    # rotation), where A v has a meaningful norm
    if kk:
        AV = op_mult_block(A, Vk).cpu().numpy().T
        Upair = AV / np.where(svd.sigma > 1e-300, svd.sigma, 1.0)
        nrm = np.linalg.norm(Upair, axis=0)
        good = nrm > 0.5
        svd.U[:, good] = Upair[:, good] / nrm[good]
    order = np.argsort(-svd.sigma) if largest else np.argsort(svd.sigma)
    svd.sigma = svd.sigma[order]
    svd.U = svd.U[:, order]
    svd.V = svd.V[:, order]
    svd.errests = err_locked[:kk][order]


def _normal_equations_ksp(A: LinearOperator, B: LinearOperator, n: int,
                          dtype: torch.dtype) -> KSP:
    """KSP on A^H A + B^H B: a direct factorization of its explicit form
    when both operators have one (DIA, CSR, dense), else CG on the shell
    (rtol 1e-13), as the reference's least-squares pull-back."""
    if all(isinstance(op, (DIAOperator, AIJOperator, DenseOperator))
           for op in (A, B)):
        import scipy.sparse as sp

        As, Bs = A.to_scipy(), B.to_scipy()
        NE = As.conj().T @ As + Bs.conj().T @ Bs
        neop = AIJOperator.from_scipy(sp.csr_matrix(NE), device=A.device) \
            if sp.issparse(NE) else DenseOperator(np.asarray(NE),
                                                  device=A.device)
        return KSP(neop, method="direct", hermitian=True)

    def ne_mult(x):
        return A.mult_h(A.mult(x)) + B.mult_h(B.mult(x))

    neop = ShellOperator((n, n), dtype, ne_mult, ne_mult, device=A.device)
    return KSP(neop, method="cg", hermitian=True, rtol=1e-13)


def gsvd_jbd_solve(svd) -> None:
    """GSVD of (A, B) via joint bidiagonalization of Z = [A; B].

    Reference: SVDSolve_TRLanczos_GSVD and SVDLanczosGUpper
    (src/svd/impls/trlanczos/trlanczos.c:994-1223): the Krylov basis Vst
    lives in the STACKED space R^{m+p} and stays orthonormal; its top and
    bottom blocks factor through orthonormal bases U1, U2 as top(Vst) =
    U1 R1, bottom(Vst) = U2 R2, so [R1; R2] has orthonormal columns and the
    projected problem is a CS decomposition (from the SVD of R1, on the
    host).  Each step pulls back to the right space with one least-squares
    solve Z x = [u1; 0] through the normal equations (:func:
    `_normal_equations_ksp`).  The x-representatives Xr (Vst[j] = Z Xr[j]
    by construction) keep the columns in range(Z).

    Vst, U1, U2 and Xr live on the operator's device as rows; their CGS2
    sweeps run on K3 / K3c and the full-window restart rotations on K4 /
    K4c in place.  R1, R2 and the CS decomposition are host arrays.
    """
    A, B = svd.A, svd.B
    m, n = A.shape
    p = B.shape[0]
    dtype = torch.promote_types(A.dtype, B.dtype)
    dev = A.device
    np_dtype = _np_dtype(dtype)
    nsv = svd.nsv
    ncv = svd.ncv or min(n, max(2 * nsv, nsv + 15))
    ncv = min(ncv, n)
    tol = svd.tol if svd.tol is not None else _default_tol(dtype)
    max_it = svd.max_it or max(100, 2 * n // max(ncv, 1))
    largest = getattr(svd.which, "value", "largest") == "largest"

    ksp = _normal_equations_ksp(A, B, n, dtype)

    def vec(x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    def pull_back(u1: torch.Tensor) -> torch.Tensor:
        return ksp.solve(A.mult_h(u1.to(dtype)))

    def zmult(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([A.mult(x), B.mult(x)])

    def cgs2(Q, ncols, w):
        """w -> (w - sum_k c_k Q[k], c, ||result||) with 2-pass CGS
        against Q[:ncols] on K3."""
        w, c, _, nrm = orthogonalize_vec(Q[:ncols], w)
        return w, c, nrm

    def minus(X, ncols, x, c):
        """x - sum_k c_k X[k] over the first ncols rows (K3's update)."""
        if ncols == 0:
            return x
        return panel_update(X[:ncols], c[:, None], x[None])[0]

    U1 = torch.zeros((ncv, m), dtype=dtype, device=dev)
    U2 = torch.zeros((ncv, p), dtype=dtype, device=dev)
    Vst = torch.zeros((ncv + 1, m + p), dtype=dtype, device=dev)
    Xr = torch.zeros((ncv + 1, n), dtype=dtype, device=dev)
    R1 = np.zeros((ncv, ncv), dtype=np_dtype)
    R2 = np.zeros((ncv, ncv), dtype=np_dtype)

    rng = np.random.default_rng(0)
    u0 = rng.standard_normal(m)
    if np.issubdtype(np_dtype, np.complexfloating):
        u0 = u0 + 1j * rng.standard_normal(m)
    x0 = pull_back(vec(u0))
    w0 = zmult(x0)
    n0 = torch.linalg.vector_norm(w0)
    Vst[0] = w0 / n0
    Xr[0] = x0 / n0

    def random_direction(j):
        """A new random in-range direction orthogonalized against
        Vst[:j]: (vst, xr, norm)."""
        xr = pull_back(vec(rng.standard_normal(m)))
        rnd, cr, nr = cgs2(Vst, j, zmult(xr))
        return rnd, minus(Xr, j, xr, cr), float(nr)

    kl = 0
    k2 = 0
    cvals = svals = Uc = W = RW = None
    errest = np.zeros(ncv)
    beta_last = 0.0
    svd.its = 0

    while svd.its < max_it:
        svd.its += 1
        # ---- joint bidiagonalization extension (harvested RAW) ----
        for j in range(kl, ncv):
            a, ca, alpha = cgs2(U1, j, Vst[j, :m].clone())
            b, cb, alphah = cgs2(U2, j, Vst[j, m:].clone())
            alpha, alphah = float(alpha), float(alphah)
            if alpha < 1e-14 or alphah < 1e-14:
                # breakdown: new random in-range direction
                rnd, xr, nr = random_direction(j)
                if nr < 1e-14:
                    break
                Vst[j] = rnd / nr
                Xr[j] = xr / nr
                a, ca, alpha = cgs2(U1, j, Vst[j, :m].clone())
                b, cb, alphah = cgs2(U2, j, Vst[j, m:].clone())
                alpha, alphah = float(alpha), float(alphah)
            U1[j] = a / alpha if alpha > 0 else a
            U2[j] = b / alphah if alphah > 0 else b
            R1[:j, j] = ca.cpu().numpy()
            R1[j, j] = alpha
            R2[:j, j] = cb.cpu().numpy()
            R2[j, j] = alphah
            # next stacked vector: least-squares pull-back of [u1_j; 0]
            xw = pull_back(U1[j])
            w, cw, beta = cgs2(Vst, j + 1, zmult(xw))
            xw = minus(Xr, j + 1, xw, cw)
            beta = float(beta)
            if beta < 1e-14:
                xw = pull_back(vec(rng.standard_normal(m)))
                w, cw, beta = cgs2(Vst, j + 1, zmult(xw))
                xw = minus(Xr, j + 1, xw, cw)
                beta = float(beta)
            xw = xw / beta
            # refresh from the x-representative: v = Z x pins the column to
            # range(Z) (rounding from the CGS subtraction would be
            # re-amplified by 1/beta at every later step); one light CGS
            # pass restores the orthogonality the refresh perturbs
            w2, cw2, nn = cgs2(Vst, j + 1, zmult(xw))
            Vst[j + 1] = w2 / nn
            Xr[j + 1] = minus(Xr, j + 1, xw, cw2) / nn
            beta_last = beta

        # ---- projected CS decomposition of [R1; R2] (full window) ----
        Uc, cvals, Wh = np.linalg.svd(R1)
        W = Wh.conj().T  # unitary
        order = np.argsort(-cvals) if largest else np.argsort(cvals)
        cvals = cvals[order]
        Uc = Uc[:, order]
        W = W[:, order]
        RW = R2 @ W
        svals = np.linalg.norm(RW, axis=0)

        # ---- convergence: the U-side rotation's last-row weight times
        # the next step's norm (the reference's subspace estimate)
        errest = beta_last * np.abs(Uc[ncv - 1, :]) / np.maximum(
            np.abs(cvals), 1e-30)
        k2 = 0
        while k2 < ncv and errest[k2] < tol:
            k2 += 1
        done = k2 >= nsv or svd.its >= max_it

        kl = k2 + max(1, (ncv - k2) // 2)
        kl = min(kl, ncv - 1)
        if done:
            break

        # ---- full-window rotation (restart compaction; W unitary), K4 in
        # place on each device basis
        Vm = RW / np.where(svals > 1e-300, svals, 1e-300)
        for Q, X in ((W, Vst), (W, Xr), (Uc, U1), (Vm, U2)):
            rotate(_mat(Q, X), X[:ncv], out=X[:ncv])
        R1 = np.diag(cvals).astype(np_dtype)
        R2 = np.diag(svals).astype(np_dtype)
        vres, cr, nv_ = cgs2(Vst, kl, Vst[ncv].clone())
        xres = minus(Xr, kl, Xr[ncv].clone(), cr)
        nv_ = float(nv_)
        if nv_ > 1e-14:
            Vst[kl] = vres / nv_
            Xr[kl] = xres / nv_
        else:
            rnd, xr, nr = random_direction(kl)
            Vst[kl] = rnd / nr
            Xr[kl] = xr / nr

    kk = min(k2, ncv)
    svd.nconv = kk
    # final quantities from the last CS decomposition (not yet rotated in
    # when the loop exits via done)
    sig = cvals[:kk] / np.where(svals[:kk] > 1e-300, svals[:kk], 1e-300)
    svd.sigma = sig
    Vm = RW[:, :kk] / np.where(svals[:kk] > 1e-300, svals[:kk], 1e-300)
    svd.U = rotate(_mat(Uc[:, :kk], U1), U1[:ncv]).cpu().numpy().T
    svd.V = rotate(_mat(Vm, U2), U2[:ncv]).cpu().numpy().T
    svd.X = rotate(_mat(W[:, :kk], Xr), Xr[:ncv]).cpu().numpy().T
    svd.errests = errest[:kk].copy()
