"""PEP TOAR -- two-level orthogonal Arnoldi with compact tensor basis
(``slepc_tpu/pep/toar.py``).

Reference: src/pep/impls/krylov/toar/ptoar.c (828 LoC) + BVTENSOR
(src/sys/classes/bv/impls/tensor/bvtensor.c): Arnoldi on the shift-invert
companion linearization of P(lambda) = sum_i lambda^i A_i, with the d*n
Krylov basis stored compactly as V = (I_d (x) U) S -- U an n x (m+d)
orthonormal "first level", S the small stacked coefficients.

Here U is a row basis (rmax, n) on the coefficients' device.  Per step
(PEPTOARExtendBasis analog, ptoar.c:102-167): the d combinations U^T c are
one kernel-K4 rotation at (r, d), then d SpMVs (the operators' kernels)
and one P(sigma) solve (a host factorization moves one vector each way,
the events ``KSP_HostSolve_d2h`` / ``_h2d``) give the new direction; ONE
first-level CGS2 orthogonalization on kernel K3 and one host read (its
coefficients and norm); all second-level orthogonalization happens on the
small S coefficients on the host.  A restart compresses S by SVD and
rotates U in place (BVTensorCompress, ptoar.c:536; K4).  The extraction
forms the d candidate blocks of every eigenvector on the device (K4) and
scores each by its polynomial residual there, one host read per
candidate.

Krylov-Schur restarts on the projected Hessenberg (host numpy, as the
reference, and the same ``default_rng(0)`` start); eigenvalues map back
by lambda = sigma + 1/mu.  A complex shift of a real problem promotes the
basis to complex.  The eigenvector block is allocated in the result type
of the candidate blocks and their structured combination, so nothing is
cast (the reference writes a complex combination into a real block).
Where the port differs from slepc_tpu besides: a restart keeps the whole
rotated Krylov-Schur relation, the coupling of earlier locked columns
included (``ks_lock_restart``, shared with Q-Arnoldi), and the
eigenvectors come from that whole locked block.  The reference keeps its
diagonal blocks only, so the vectors of pairs locked in a later restart
lose accuracy (tests/test_torch_pep_restart.py: on a 900-row damped
quadratic at tol 1e-6 its later locks have backward errors above 1e-5,
the port's all stay below tol).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bv.orthog import orthogonalize_vec
from ..ds.schur import schur, sort_schur
from ..eps.base import basis_combine, op_mult
from ..eps.krylovschur import _pair_keys
from ..mat.linop import DenseOperator, DIAOperator
from ..ops.rotate import rotate
from ..sys.sort import SortCriterion, Which
from .pep import psigma_ksp

_LARGEST = SortCriterion(Which.LARGEST_MAGNITUDE)  # in mu = 1/(lambda - sigma)
_NP = {torch.float32: np.float32, torch.float64: np.float64,
       torch.complex64: np.complex64, torch.complex128: np.complex128}


def _opnorm_est(m) -> float:
    """Cheap 2-norm-flavored operator norm for backward-error scales.

    Frobenius overestimates by up to sqrt(n) and masks bad pairs; the
    max-abs-row-sum (inf-norm) is a tight proxy for the banded/dense
    operators PEP sees: for a DIA or dense operator it is reduced on the
    device and read as one scalar.  Anything else takes the Frobenius
    estimate (``norm_estimate``; a CSR operator's is the norm of its
    values, as the reference's)."""
    if isinstance(m, DIAOperator):
        return float(m.diags.abs().sum(dim=0).max())
    if isinstance(m, DenseOperator):
        return float(m.A.abs().sum(dim=1).max())
    return float(m.norm_estimate())


def _scalar(z):
    """A numpy scalar as a Python float or complex (a tensor times a
    Python number stays a tensor)."""
    return complex(z) if np.iscomplexobj(z) else float(z)


def _complex_of(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.complex64)


def ks_lock_restart(H, k: int, nv: int, beta: float, *, cplx: bool,
                    tol: float, nev: int, last_cycle: bool, brk: bool):
    """The Krylov-Schur lock and thick restart of TOAR and Q-Arnoldi, on the
    host Hessenberg H of the shift-inverted operator (active block
    k..nv, ``beta`` = |H[nv, nv - 1]|, 0 after a breakdown).

    The active block's Schur form is sorted by largest |mu| (a real
    form keeps its 2 x 2 blocks whole); the leading pairs whose mu-space
    estimate is below ``tol`` lock, and half the rest is kept.  Returns
    (k2, l, done, Qk, errest, H): k2 the locked count after this cycle,
    l the kept unlocked columns, ``done`` when no further cycle runs, Qk
    the Schur vectors that rotate basis columns k..nv into k..k2 + l, the
    active block's estimates, and the whole rotated relation -- the
    locked block, its coupling to the rotated columns, the new Schur
    block and the arrow of the kept part (the reference keeps the
    diagonal blocks only; Q-Arnoldi rebuilds its bottoms through H, so
    no coupling may be dropped)."""
    Tproj, Q, mu = schur(H[k:nv, k:nv])
    keys = _LARGEST.keys(mu)
    if not cplx:
        keys = _pair_keys(Tproj, keys)
    Tproj, Q, mu = sort_schur(Tproj, Q, keys)
    na = nv - k
    last = Q[na - 1, :]
    resid = beta * np.abs(last)
    if not cplx:
        i = 0
        while i < na:
            if i + 1 < na and Tproj[i + 1, i] != 0.0:
                resid[i] = resid[i + 1] = np.hypot(resid[i], resid[i + 1])
                i += 2
            else:
                i += 1
    errest = resid / np.maximum(np.abs(mu), 1e-300)  # residual in mu space

    k2 = k
    while k2 < nv and errest[k2 - k] < tol:
        k2 += 1
    if not cplx:
        dd = k2 - k
        if 0 < dd < na and Tproj[dd, dd - 1] != 0.0:
            k2 -= 1
    done = k2 >= nev or last_cycle or brk
    l = 0
    if not done:
        l = max(1, (nv - k2) // 2)
        l = min(l, max(nv - k2 - 1, 0))
        if not cplx and l > 0:
            dd = k2 - k + l
            if dd < na and Tproj[dd, dd - 1] != 0.0:
                l += 1 if dd + 1 < na else -1
    kl = (k2 - k) + l
    if kl > 0:
        Hn = np.zeros_like(H)
        Hn[:k, :k] = H[:k, :k]
        Hn[:k, k: k + kl] = H[:k, k:nv] @ Q[:, :kl]
        Hn[k: k + kl, k: k + kl] = Tproj[:kl, :kl]
        if l > 0:
            Hn[k2 + l, k2: k2 + l] = beta * last[k2 - k: k2 - k + l]
        H = Hn
    return k2, l, done, Q[:, :kl], errest, H


def toar_solve(pep) -> None:
    mats = pep.mats
    d = pep.degree
    n = pep.n
    dev = pep.device
    # common dtype over ALL coefficient matrices: a real A_0 with complex
    # A_1.. would otherwise silently truncate the recurrence to real
    # (measured failure: spurious converged pairs clustered at sigma)
    dtype = mats[0].dtype
    for m in mats[1:]:
        dtype = torch.promote_types(dtype, m.dtype)
    cplx = dtype.is_complex
    dbl = dtype in (torch.float64, torch.complex128)
    nev = pep.nev
    ncv = pep.ncv or min(d * n, max(2 * nev, nev + 15))
    ncv = min(ncv, d * n - 1)
    tol = pep.tol if pep.tol is not None else (1e-8 if dbl else 1e-5)
    max_it = pep.max_it or max(100, 2 * (d * n) // ncv)
    sigma = complex(pep.target) if pep.target is not None else 0.0
    if sigma.imag == 0:
        sigma = sigma.real  # keep real arithmetic when possible
    elif not cplx:
        # complex shift on a real problem: promote the basis to complex
        dtype = _complex_of(dtype)
        cplx = True
    sdt = _NP[dtype]
    sfactor = pep.compute_scale()
    pep.sfactor = sfactor
    if sfactor != 1.0:
        mats = [mats[i] * (sfactor**i) for i in range(d + 1)]
        sigma = sigma / sfactor

    ksp = psigma_ksp(mats, sigma)

    rmax = ncv + d + 1  # first-level capacity
    U = torch.zeros((rmax, n), dtype=dtype, device=dev)
    S = np.zeros((d * rmax, ncv + 1), dtype=sdt)  # stacked blocks (d, rmax)
    H = np.zeros((ncv + 1, ncv), dtype=sdt)

    # ---- initial column: random u0; S column = e-block ----
    rng = np.random.default_rng(0)
    u0 = rng.standard_normal(n).astype(sdt) if not cplx else \
        (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(sdt)
    u0 /= np.linalg.norm(u0)
    U[0] = torch.from_numpy(u0).to(dev)
    r = 1  # current first-level size
    # first TOAR column: v = [u0; 0; ...; 0] normalized (BVTensorBuildFirstColumn)
    S[0, 0] = 1.0
    pep.toar_steps = 0

    def s_block(col, i, rr):
        """View of S block i (rows over U rows 0..rr) for a column."""
        return col[i * rmax: i * rmax + rr]

    def extend(j, r):
        """One TOAR step: extend from column j (0-based) given r U-rows.

        Returns (r_new, hcol (j+2,), breakdown).
        """
        nonlocal S
        pep.toar_steps += 1
        scol = S[:, j]
        s_i = [s_block(scol, i, r) for i in range(d)]
        # tau recurrence: t_{i+1} = sigma t_i + v_i  (coefficients over U)
        tau = [np.zeros(r, dtype=S.dtype)]
        for i in range(d - 1):
            tau.append(sigma * tau[i] + s_i[i])
        # rhs = -(A_d U (s_{d-1} + sigma tau_{d-1}) + sum_{i>=1} A_i U tau_i)
        combo = np.column_stack([s_i[d - 1] + sigma * tau[d - 1]]
                                + [tau[i] for i in range(1, d)])
        Uc = rotate(torch.from_numpy(np.ascontiguousarray(combo)).to(dev),
                    U[:r])  # (d, n): K4
        rhs = -op_mult(mats[d], Uc[0])
        for i in range(1, d):
            rhs = rhs - op_mult(mats[i], Uc[i])
        z0 = ksp.solve(rhs).to(dtype)
        # first-level orthogonalization of z0 against U (CGS2 on K3)
        z0, c_tot, _, na = orthogonalize_vec(U[:r], z0, passes=2)
        host = torch.cat([c_tot, na[None].to(c_tot.dtype)]).cpu().numpy()
        c = host[:r].astype(S.dtype)
        beta = float(abs(host[r]))
        grew = beta > 1e-14
        if grew:
            torch.div(z0, beta, out=U[r])
            r_new = r + 1
        else:
            r_new = r
        # zeta recurrence: z_i = sigma^i z0 + U zeta_i, zeta_{i+1} = sigma zeta_i + s_i
        zeta = [np.zeros(r, dtype=S.dtype)]
        for i in range(d - 1):
            zeta.append(sigma * zeta[i] + s_i[i])
        # new stacked column over r_new U-rows
        newcol = np.zeros(d * rmax, dtype=S.dtype)
        sig_i = 1.0
        for i in range(d):
            blk = newcol[i * rmax: i * rmax + r_new]
            blk[:r] = sig_i * c + zeta[i]
            if grew:
                blk[r] = sig_i * beta
            sig_i *= sigma
        # second level: orthogonalize against TOAR columns 0..j (small GEMV)
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
        hcol = np.zeros(j + 2, dtype=S.dtype)
        hcol[: j + 1] = h
        hcol[j + 1] = nrm
        return r_new, hcol, brk

    k = 0  # locked
    l = 0
    errs = np.zeros(ncv)
    pep.its = 0
    nconv_final = 0

    while pep.its < max_it:
        pep.its += 1
        nv = ncv
        brk = False
        for j in range(k + l, nv):
            r, hcol, brk = extend(j, r)
            H[: j + 2, j] = hcol
            if brk:
                nv = j + 1
                break
        beta = float(abs(H[nv, nv - 1])) if nv < ncv + 1 else 0.0
        k2, l, done, Qk, errest, H = ks_lock_restart(
            H, k, nv, beta, cplx=cplx, tol=tol, nev=nev,
            last_cycle=pep.its >= max_it, brk=brk)
        errs[k:k2] = errest[: k2 - k]

        if Qk.shape[1] > 0:
            S[:, k: k + Qk.shape[1]] = S[:, k:nv] @ Qk
            if not done and l > 0:
                S[:, k2 + l] = S[:, nv]
            # ---- compress the tensor basis (BVTensorCompress) ----
            ncols = k2 + l + (0 if done else 1)
            Sb = S[:, :ncols]
            M = np.concatenate([Sb[i * rmax: i * rmax + r, :] for i in range(d)],
                               axis=1)  # (r, d*ncols)
            Ur_, sv, _ = np.linalg.svd(M, full_matrices=False)
            rho = int(np.sum(sv > 1e-13 * max(sv[0] if sv.size else 0, 1e-300)))
            # capacity invariant: the next cycle adds one U row per
            # extension step, so rho must leave room (rho <= ncols+d-1
            # keeps r <= ncv+d = rmax-1 at cycle end)
            rho = max(min(rho, r, ncols + d - 1), 1)
            W = Ur_[:, :rho]
            rotate(torch.from_numpy(np.ascontiguousarray(W)).to(dev), U[:r],
                   out=U[:rho])  # U[:rho] = W^T U[:r] in place: K4
            Snew = np.zeros_like(S)
            for i in range(d):
                Snew[i * rmax: i * rmax + rho, :ncols] = \
                    W.conj().T @ Sb[i * rmax: i * rmax + r, :]
            S = Snew
            r = rho
        k = k2
        nconv_final = k
        if done:
            break

    # ---- extraction: eigenvectors of the locked Schur block ----
    pep.nconv = nconv_final
    k = nconv_final
    if not k:
        pep._set_results(np.array([]), np.array([]),
                         torch.zeros((0, n), dtype=dtype, device=dev))
        return
    wb, Y = np.linalg.eig(H[:k, :k])  # the locked Schur block, coupled
    with np.errstate(divide="ignore", invalid="ignore"):
        lam_fin = sigma + 1.0 / wb
    # big-space Ritz vectors from the tensor basis: the linearization
    # eigenvector stacks d candidate blocks x_i = U^T S^(i) y with
    # x_i ~ mu^i x_0, formed on the device (K4); the EXTRACTION choice
    # picks how to read x off them (reference PEPSetExtraction,
    # pepkrylov.c PEPExtractVectors: NONE = first block, NORM = largest
    # block, RESIDUAL = block with the smallest true residual,
    # STRUCTURED = mu-weighted average)
    blocks = [basis_combine(U[:r], S[i * rmax: i * rmax + r, :k] @ Y)
              for i in range(d)]
    extract = str(getattr(pep, "extract", None) or "best").lower()
    mats0 = pep.mats  # ORIGINAL (unscaled) coefficients
    nrm_mats = [max(_opnorm_est(m), 1e-300) for m in mats0]
    if sfactor != 1.0:
        lam_fin = lam_fin * sfactor

    def _eta(lamj, xv):
        """Tisseur backward error of (lamj, xv) on the ORIGINAL
        polynomial: ||P(lam)x|| / (sum |lam|^i ||A_i||_2est ||x||), on
        the device; one host read."""
        rj = None
        lp = 1.0
        lamj = _scalar(lamj)
        scale = 0.0
        for i, mm in enumerate(mats0):
            t = op_mult(mm, xv) * lp
            rj = t if rj is None else rj + t
            scale += abs(lp) * nrm_mats[i]
            lp *= lamj
        nv_, nr = torch.stack([torch.linalg.vector_norm(xv),
                               torch.linalg.vector_norm(rj)]).tolist()
        if not nv_ > 0 or not np.isfinite(nv_):
            return np.inf
        return float(nr / nv_ / scale)

    # the blocks are complex exactly when some mu is, and so is acc
    X = torch.empty((k, n), dtype=blocks[0].dtype, device=dev)
    etas = np.zeros(k)
    for j in range(k):
        mu_j = wb[j]
        cands = [blocks[i][j] for i in range(d)]
        # structured: weight block i by conj(mu^i), in the terms' own type
        acc = None
        wgt = 1.0
        for i in range(d):
            t = _scalar(np.conj(wgt)) * cands[i]
            acc = t if acc is None else acc + t
            wgt *= mu_j
        if extract == "none":
            pick = [cands[0]]
        elif extract == "norm":
            nrms = torch.stack([torch.linalg.vector_norm(c)
                                for c in cands]).tolist()
            pick = [cands[int(np.argmax(nrms))]]
        elif extract == "structured":
            pick = [acc]
        elif extract == "residual":
            pick = cands
        else:  # "best": every block AND the structured combination --
            # which read-off is accurate is problem-dependent
            # (measured: structured wins on a boundary-damped
            # acoustic QEP, first-block on speaker107), and the true
            # residual is the only reliable referee
            pick = cands + [acc]
        best_eta, best_v = np.inf, pick[0]
        for v in pick:
            e_ = _eta(lam_fin[j], v)
            if e_ < best_eta:
                best_eta, best_v = e_, v
        X[j] = best_v
        etas[j] = best_eta
    nrm = torch.linalg.vector_norm(X, dim=1, keepdim=True)
    X = X / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    order = np.argsort(_LARGEST.keys(1.0 / (lam_fin / sfactor - sigma)
                               if sfactor != 1.0 else wb), kind="stable")
    lam_fin, etas = lam_fin[order], etas[order]
    X = X[torch.from_numpy(order).to(dev)]
    errs_o = errs[:k][order] if len(errs) >= k else np.zeros(k)
    # ---- spurious-pair guard: the mu-space errest divides by |mu|,
    # so a breakdown-born Ritz value with huge |mu| (lambda ~ sigma
    # in a spectral gap) can pass tol while its TRUE backward error
    # is O(1).  Certify each pair against the explicit polynomial
    # residual (reference role: PEPConvergedNorm / -pep_conv_norm,
    # pepdefault.c) and drop failures.
    keep = np.isfinite(etas) & (etas <= max(1e4 * tol, 1e-6))
    errs_o = np.maximum(errs_o, np.where(np.isfinite(etas), etas, np.inf))
    if not keep.all():
        lam_fin, errs_o = lam_fin[keep], errs_o[keep]
        X = X[torch.from_numpy(np.flatnonzero(keep)).to(dev)]
        pep.nconv = int(keep.sum())
    pep._set_results(lam_fin, errs_o, X)
