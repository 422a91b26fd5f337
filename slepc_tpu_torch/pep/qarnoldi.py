"""PEP Q-Arnoldi: memory-saving Krylov for quadratic eigenproblems
(``slepc_tpu/pep/qarnoldi.py``).

Reference: src/pep/impls/krylov/qarnoldi/qarnoldi.c (518 LoC), after
Meerbergen's Q-Arnoldi method.  For the QEP P(lam) = K + lam C + lam^2 M,
run Arnoldi on the shift-inverted companion WITHOUT storing the 2n-long
basis: use the linearization with the "top' = bottom" structure

    O [v; w] = [w; -P(sigma)^{-1} (M v + (C + 2 sigma M) w)]

(eigenvalues mu = 1/(lam - sigma)).  The Arnoldi relation then forces the
bottom blocks of the basis to satisfy  bottom_i = V H[:, i]  -- they are
linear combinations of the stored TOP blocks -- so only the n-row top
block V (ncv+1 rows of a row basis on the coefficients' device) plus the
current bottom w are kept: half the memory of Arnoldi on the explicit 2n
linearization, at the price of a mildly less stable orthogonalization
(coefficients reconstructed through H; the reference makes the same
trade, qarnoldi.c:87-126).

Each CGS pass is one kernel-K3 dots sweep of V against the pair [v; w]
(a panel of two rows), one host read (those dots and <w_old, w>), and one
K3 update sweep of the pair; the Krylov-Schur restart rotates V in place
on kernel K4, and the eigenvectors are one K4 rotation of the locked tops.
Krylov-Schur thick restart preserves the bottom-block identity because
the rotated H keeps the Arnoldi relation.  Where the port differs from
slepc_tpu: its restart (``toar.ks_lock_restart``) keeps the whole rotated
relation, the coupling of the locked rows to the kept ones included (the
reference keeps only the diagonal blocks, so once a restart follows a
lock the bottoms rebuilt through H are wrong and the recurrence grows
without bound: tests/test_torch_pep_restart.py plants that case, a
900-row damped quadratic at sigma = 0 on which the reference's H
overflows), and its eigenvectors come from that whole locked block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..eps.base import basis_combine, op_mult
from ..ops.bv import panel_dots, panel_update
from ..ops.rotate import rotate
from .pep import psigma_ksp
from .toar import _NP, _complex_of, _scalar, ks_lock_restart


def qarnoldi_solve(pep) -> None:
    """Solve a QEP by Q-Arnoldi with shift-and-invert at pep.target."""
    if pep.degree != 2:
        raise ValueError("qarnoldi handles quadratic problems (3 matrices); "
                         "use toar for general degree")
    mats = pep.mats
    n = pep.n
    dev = pep.device
    dtype = mats[0].dtype
    cplx = dtype.is_complex
    dbl = dtype in (torch.float64, torch.complex128)
    nev = pep.nev
    ncv = pep.ncv or min(2 * n, max(2 * nev, nev + 15))
    ncv = min(ncv, 2 * n - 1)
    tol = pep.tol if pep.tol is not None else (1e-8 if dbl else 1e-5)
    max_it = pep.max_it or max(100, 2 * (2 * n) // ncv)
    sigma = complex(pep.target) if pep.target is not None else 0.0
    if sigma.imag == 0:
        sigma = sigma.real
    elif not cplx:
        dtype = _complex_of(dtype)
        cplx = True
    sfactor = pep.compute_scale()
    pep.sfactor = sfactor
    if sfactor != 1.0:
        mats = [mats[i] * (sfactor ** i) for i in range(3)]
        sigma = sigma / sfactor
    K, C, M = mats

    ksp = psigma_ksp(mats, sigma)

    V = torch.zeros((ncv + 1, n), dtype=dtype, device=dev)
    H = np.zeros((ncv + 1, ncv), dtype=_NP[dtype])

    rng = np.random.default_rng(0)

    def randvec():
        c = rng.standard_normal(n)
        if cplx:
            c = c + 1j * rng.standard_normal(n)
        return torch.from_numpy(c).to(dev, dtype)

    v = randvec()
    w = randvec()
    nz = float(np.hypot(float(torch.linalg.vector_norm(v)),
                        float(torch.linalg.vector_norm(w))))
    v, w = v / nz, w / nz
    V[0] = v

    T1c = 2.0 * sigma  # T1 = C + 2 sigma M

    def apply_op(v, w):
        """[v; w] -> [w; -P(sigma)^{-1}(M v + (C + 2 sigma M) w)]."""
        rhs = op_mult(M, v) + op_mult(C, w)
        if T1c != 0.0:
            rhs = rhs + T1c * op_mult(M, w)
        u = -ksp.solve(rhs).to(dtype)
        return w, u

    def cgs_pass(j, vt, wt, w_old):
        """One CGS pass of [vt; wt] against rows 0..j (bottoms through
        H; bottom_j = w_old).  Returns (vt, wt, h (j+1,))."""
        Vact = V[: j + 1]
        P = torch.stack([vt, wt])
        G = panel_dots(Vact, P)  # (j + 1, 2): V^H vt, V^H wt on K3
        host = torch.cat([G.T.reshape(-1),
                          torch.vdot(w_old, wt)[None]]).cpu().numpy()
        h = host[: j + 1].copy()
        work = host[j + 1: 2 * j + 2]
        if j > 0:
            h[:j] += H[: j + 1, :j].conj().T @ work
        h[j] += host[-1] if cplx else host[-1].real
        coef = np.zeros((j + 1, 2), dtype=h.dtype)
        coef[:, 0] = h
        if j > 0:
            coef[:, 1] = H[: j + 1, :j] @ h[:j]
        P = panel_update(Vact, torch.from_numpy(coef).to(dev, dtype), P)
        vt = P[0]
        wt = P[1] - _scalar(h[j]) * w_old
        return vt, wt, h

    def extend(j, v, w):
        """Q-Arnoldi step from row j; returns (v', w', hcol, breakdown)."""
        vt, wt = apply_op(v, w)
        w_old = w  # bottom block of row j
        vt, wt, h1 = cgs_pass(j, vt, wt, w_old)
        vt, wt, h2 = cgs_pass(j, vt, wt, w_old)  # CGS2
        h = h1 + h2
        nrm = float(np.hypot(*torch.stack([torch.linalg.vector_norm(vt),
                                           torch.linalg.vector_norm(wt)])
                             .tolist()))
        brk = nrm < 1e-14 * max(1.0, float(np.linalg.norm(h)))
        hcol = np.zeros(j + 2, dtype=H.dtype)
        hcol[: j + 1] = h.real if not cplx else h
        hcol[j + 1] = nrm
        if brk:
            return v, w, hcol, True
        return vt / nrm, wt / nrm, hcol, False

    k = 0
    l = 0
    errs = np.zeros(ncv)
    pep.its = 0
    nconv_final = 0

    while pep.its < max_it:
        pep.its += 1
        V[k + l] = v
        nv = ncv
        brk = False
        for j in range(k + l, nv):
            v, w, hcol, brk = extend(j, v, w)
            H[: j + 2, j] = hcol
            if brk:
                nv = j + 1
                break
            if j < nv - 1:
                V[j + 1] = v
        beta = float(abs(H[nv, nv - 1])) if not brk else 0.0
        k2, l, done, Qk, errest, H = ks_lock_restart(
            H, k, nv, beta, cplx=cplx, tol=tol, nev=nev,
            last_cycle=pep.its >= max_it, brk=brk)
        errs[k:k2] = errest[: k2 - k]
        if Qk.shape[1] > 0:
            # V[k:k+kl] = Qk^T V[k:nv] in place: K4
            rotate(torch.from_numpy(np.ascontiguousarray(Qk)).to(dev, dtype),
                   V[k:nv], out=V[k: k + Qk.shape[1]])
        k = k2
        nconv_final = k
        if done:
            if brk and k < nev:
                pep.reason = "DIVERGED_BREAKDOWN"
            break

    pep.nconv = nconv_final
    k = nconv_final
    if not k:
        pep._set_results(np.array([]), np.array([]),
                         torch.zeros((0, n), dtype=dtype, device=dev))
        return
    wb, Y = np.linalg.eig(H[:k, :k])  # the locked Schur block, coupled
    with np.errstate(divide="ignore", invalid="ignore"):
        lam_fin = sigma + 1.0 / wb
    X = basis_combine(V[:k], Y)  # companion tops are the eigenvectors
    nrm = torch.linalg.vector_norm(X, dim=1, keepdim=True)
    X = X / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    if sfactor != 1.0:
        lam_fin = lam_fin * sfactor
    order = np.argsort(
        np.abs(lam_fin - (pep.target if pep.target is not None else 0.0)))
    pep._set_results(lam_fin[order], errs[:k][order],
                     X[torch.from_numpy(order).to(dev)])
