"""NLEIGS with a compact (TOAR-style) rational-Krylov basis -- the default
(``slepc_tpu/nep/nleigs_toar.py``).

Reference: src/nep/impls/nleigs/nleigs.c (the default variant keeps the
Krylov basis of the d*n companion-with-poles linearization in the compact
form V = (I_d (x) U) S, as PEP TOAR; nleigs-fullb.c is the full-basis
option, ``NEP.nleigs_full_basis``).

Here U is a (ncv + 3, n) complex row basis on the split operators' device,
S the stacked coefficients and H the projected Hessenberg, host numpy, as
in ``pep/toar.py``.  One step (the reference's ``extend``): the
coefficient recurrence on S runs on the host (r-long vectors); the nt
combinations of U's rows are one K4c rotation at (r, nt) (at (r, d) for a
callback problem, whose dense divided differences stay on the host); q is
the terms' SpMVs (a real DIA term takes K2 on the real and imaginary
parts); one Q_d(sigma) solve (factorized once: dense LU on the device for
a dense problem, host sparse LU with one transfer each way for a sparse
one); the first-level CGS2 on K3c, then one host read of its coefficients
and norm; the new row written in place.  A restart compresses U in place
on K4c (``U[:rho] = W^T U[:r]``); the extraction forms the candidate
vectors U^T (S^(0) Y) with one K4c rotation and polishes each on the true
T on the device.

The restart keeps the reference's bookkeeping: the locked Schur block
Tlock holds the diagonal blocks of the successive restarts, without the
coupling of earlier locked columns to later ones (the drop ``pep/toar.py``
repairs with ``ks_lock_restart``).  The eigenvalues of the locked block are
its diagonal either way; only the extracted vectors differ, and the Newton
polish on the true T brings both to the same pairs: with the coupling
kept, the reference's solve that locks across 15 restarts gives the same
nconv, its and values
(tests/test_torch_nep_nleigs.py::test_kept_coupling_changes_no_pair;
ROADMAP.md, queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bv.orthog import orthogonalize_vec
from ..ds.schur import schur, sort_schur
from ..eps.base import basis_combine
from ..ops.rotate import rotate
from ..pep.pep import _np, _vec
from ..sys.sort import SortCriterion, Which
from .nep import _nep_newton_step


def nleigs_toar_krylov(nep, *, sigma, d, beta, s, bsig, b_over_xi,
                       one_m_sx, coeffD=None, Dmats=None, ksp=None, lu=None,
                       rg=None, center=0.0):
    """Rational-Krylov (shift-invert Arnoldi) on the NLEIGS linearization
    with the basis kept compact.  Fills nep's eigenvalues, errests,
    eigenvectors, nconv and its."""
    import scipy.linalg as sla

    n = nep.n
    dev = nep.device
    cdt = nep.cdtype
    dtype = np.dtype(np.complex128)
    nev = nep.nev
    ncv = min(max(2 * nev, nev + 15), d * n - 1)
    tol = nep.tol if nep.tol is not None else 1e-9
    itol = max(tol * 1e-2, 1e-13)
    max_it = nep.max_it or max(100, 2 * (d * n) // ncv)
    sc = SortCriterion(Which.LARGEST_MAGNITUDE)  # in mu = 1/(lambda-sigma)

    rmax = ncv + 3  # first level grows by <= 1 per extension step
    U = torch.zeros((rmax, n), dtype=cdt, device=dev)
    S = np.zeros((d * rmax, ncv + 1), dtype=dtype)
    H = np.zeros((ncv + 1, ncv), dtype=dtype)

    rng = np.random.default_rng(0)
    u0 = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    u0 /= np.linalg.norm(u0)
    U[0] = _vec(u0, dev).to(cdt)
    r = 1
    # first column of the linearization basis: the first block only
    # (b_0 = 1)
    S[0, 0] = 1.0

    if coeffD is not None:
        terms = nep.split_A
        nt = len(terms)

    def extend(j, r):
        """One compact shift-invert step from column j with r U-rows.
        Returns (r_new, hcol, breakdown)."""
        nonlocal S
        scol = S[:, j]
        sb = [scol[i * rmax: i * rmax + r] for i in range(d)]
        # backward substitution through the companion-with-poles rows, on
        # coefficients over U (the full-basis apply's recurrence)
        w = [None] * (d - 1)
        w[d - 2] = (sb[d - 2] + b_over_xi[d - 2] * sb[d - 1]) \
            / (s[d - 2] - sigma)
        for k in range(d - 2, 0, -1):
            w[k - 1] = (sb[k - 1] + b_over_xi[k - 1] * sb[k]
                        - beta[k] * one_m_sx[k - 1] * w[k]) / (s[k - 1] - sigma)
        zlast = sb[d - 1] / beta[d]
        if coeffD is not None:
            combo = np.zeros((r, nt), dtype=dtype)
            for i in range(nt):
                v = coeffD[d, i] * zlast
                for jj in range(d - 1):
                    v = v + coeffD[jj, i] * w[jj]
                combo[:, i] = v
            Uc = rotate(_vec(combo, dev).to(cdt), U[:r])  # (nt, n): K4c
            q = None
            for i, Ai in enumerate(terms):
                t = Ai.mult(Uc[i])
                q = t if q is None else q + t
            t_new = -ksp.solve(q)
        else:
            combo = np.column_stack(w + [zlast])  # (r, d)
            Uc = _np(rotate(_vec(combo, dev).to(cdt), U[:r]))  # K4c
            q = Dmats[d] @ Uc[d - 1]
            for jj in range(d - 1):
                q = q + Dmats[jj] @ Uc[jj]
            t_new = _vec(-sla.lu_solve(lu, q), dev)
        # first-level CGS2 on K3c: one host read of c and the norm
        t_new, c_tot, _, na = orthogonalize_vec(U[:r], t_new.to(cdt),
                                                passes=2)
        host = torch.cat([c_tot, na[None].to(c_tot.dtype)]).cpu().numpy()
        c = host[:r].astype(dtype)
        bnew = float(abs(host[r]))
        grew = bnew > 1e-14
        if grew:
            torch.div(t_new, bnew, out=U[r])
            r_new = r + 1
        else:
            r_new = r
        # new stacked column: out_j = w_j + bsig_j * t for j < d-1,
        # out_{d-1} = bsig_{d-1} * t
        newcol = np.zeros(d * rmax, dtype=dtype)
        for i in range(d):
            blk = newcol[i * rmax: i * rmax + r_new]
            base = w[i] if i < d - 1 else np.zeros(r, dtype=dtype)
            blk[:r] = base + bsig[i] * c
            if grew:
                blk[r] = bsig[i] * bnew
        # second level (small, host)
        Sprev = S[:, : j + 1]
        h1 = Sprev.conj().T @ newcol
        newcol = newcol - Sprev @ h1
        h2 = Sprev.conj().T @ newcol
        newcol = newcol - Sprev @ h2
        h = h1 + h2
        nrm = np.linalg.norm(newcol)
        brk = nrm < 1e-14 * max(1.0, np.linalg.norm(h))
        if not brk:
            S[:, j + 1] = newcol / nrm
        hcol = np.zeros(j + 2, dtype=dtype)
        hcol[: j + 1] = h
        hcol[j + 1] = nrm
        return r_new, hcol, brk

    k = 0
    l = 0
    Tlock = np.zeros((ncv, ncv), dtype=dtype)
    nep.its = 0
    while nep.its < max_it:
        nep.its += 1
        nv = ncv
        brk = False
        for j in range(k + l, nv):
            r, hcol, brk = extend(j, r)
            H[: j + 2, j] = hcol
            if brk:
                nv = j + 1
                break
        beta_r = float(abs(H[nv, nv - 1])) if nv < ncv + 1 else 0.0
        Tproj, Q, mu = schur(H[k:nv, k:nv])
        Tproj, Q, mu = sort_schur(Tproj, Q, sc.keys(mu))
        na = nv - k
        last = Q[na - 1, :]
        errest = beta_r * np.abs(last) / np.maximum(np.abs(mu), 1e-300)
        k2 = k
        while k2 < nv and errest[k2 - k] < itol:
            k2 += 1
        done = k2 >= nev + 1 or nep.its >= max_it or brk
        l = 0 if done else min(max(1, (nv - k2) // 2),
                               max(nv - k2 - 1, 0))
        kl = (k2 - k) + l
        Tlock[k:k2, k:k2] = Tproj[: k2 - k, : k2 - k]
        if kl > 0:
            S[:, k: k + kl] = S[:, k:nv] @ Q[:, :kl]
            Hh2 = np.zeros_like(H)
            Hh2[:k2, :k2] = Tlock[:k2, :k2]
            if not done and l > 0:
                Hh2[k2: k2 + l, k2: k2 + l] = \
                    Tproj[k2 - k: k2 - k + l, k2 - k: k2 - k + l]
                Hh2[k: k2, k2: k2 + l] = Tproj[: k2 - k, k2 - k: k2 - k + l]
                Hh2[k2 + l, k2: k2 + l] = beta_r * last[k2 - k: k2 - k + l]
                S[:, k2 + l] = S[:, nv]
            H = Hh2
            # compress the tensor basis (BVTensorCompress role)
            ncols = k2 + l + (0 if done else 1)
            Sb = S[:, :ncols]
            M = np.concatenate([Sb[i * rmax: i * rmax + r, :]
                                for i in range(d)], axis=1)
            Ur_, sv, _ = np.linalg.svd(M, full_matrices=False)
            rho = int(np.sum(sv > 1e-13 * max(sv[0] if sv.size else 0,
                                              1e-300)))
            rho = max(min(rho, r, ncols + 1), 1)
            W = Ur_[:, :rho]
            rotate(_vec(W, dev).to(cdt), U[:r], out=U[:rho])  # K4c in place
            Snew = np.zeros_like(S)
            for i in range(d):
                Snew[i * rmax: i * rmax + rho, :ncols] = \
                    W.conj().T @ Sb[i * rmax: i * rmax + r, :]
            S = Snew
            r = rho
        k = k2
        if done:
            break

    # ---- extraction + Newton polish on the true T ----
    found = []
    if k:
        wb, Y = np.linalg.eig(Tlock[:k, :k])
        X0 = basis_combine(U[:r], S[:rmax, :k][:r] @ Y)  # x = U^T S^(0) y: K4c
        for i in range(k):
            if abs(wb[i]) < 1e-300:
                continue
            lam = sigma + 1.0 / wb[i]
            x = X0[i]
            nx = float(torch.linalg.vector_norm(x))
            if nx < 1e-12:
                continue
            x = x / nx
            for _ in range(10):
                e = nep._residual(complex(lam), x)
                if e < tol:
                    break
                lam, x = _nep_newton_step(nep, lam, x)
            e = nep._residual(complex(lam), x)
            if e < max(tol * 100, 1e-8) and (rg is None
                                             or rg.check_inside(lam) >= 0):
                if all(abs(lam - f[0]) > 1e-8 * max(1, abs(lam))
                       for f in found):
                    found.append((complex(lam), e, x))
    found.sort(key=lambda t: abs(t[0] - center))
    nep._set_results([t[0] for t in found], [t[1] for t in found],
                     [t[2] for t in found])
    nep.nconv = len(found)
