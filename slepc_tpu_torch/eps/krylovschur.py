"""EPS Krylov–Schur (``slepc_tpu/eps/krylovschur.py``).

Routes, as in the reference:

  * spectrum slicing (``which=ALL`` with an interval, no filter):
    ``ks_slice.py``;
  * ``problem_type="bse"``: the structure-preserving BSE solver
    (``eps/bse.py``);
  * ``set_two_sided()`` on a problem that is not Hermitian with B = I, when
    the transformed operator has an adjoint apply: the coupled two-sided
    Krylov-Schur (``eps/ks_twosided.py``); otherwise the one-sided solve
    here and the left vectors from ``EPS._solve_left``;
  * the fast path (``ks_jit.ks_hep_solve``): a standard Hermitian problem
    with the identity metric, no region, no arbitrary selection and Ritz
    extraction, for a sigma = 0 shift with which = smallest / largest, the
    device shift-and-invert ``STSinvertDevice`` (its symmetrization keeps
    the identity metric; the wanted pairs are the transform's
    largest-magnitude ones), or the polynomial filter ``STFilter`` (the
    largest of p(A), then Rayleigh quotients on A);
  * the general host-orchestrated loop below, for everything else: HEP and
    GHEP with any ST, and the non-Hermitian arm (``nhep``, ``gnhep``,
    ``pgnhep``) with its real Schur form, harmonic extraction, Krylov
    balancing, arbitrary selection and region filtering (``set_rg``), plus
    ``mpd``, locking, deflation and initial spaces, ``true_residual``,
    ``stopping`` and monitors; and the pseudo-Lanczos arm of GHIEP (an
    indefinite B): a B-indefinite basis with the signature omega of its
    vectors, the projected pencil by ``DSGHIEP``, the signatures of the
    locked and kept vectors carried over a restart, and a re-solve as GNHEP
    when the projection has complex pairs.

One outer iteration of the general loop: basis extension (``bv/krylov.py``:
the ST operator's apply + CGS2 on kernel K3 per column, B-metric for GHEP),
the projected problem on the host (HEP: compact arrow + tridiagonal form
when the thick restart left one, else LAPACK eigh; non-Hermitian: the real
Schur form, sorted with its 2x2 blocks whole, ``ds/schur.py``), the
restart as one rotation on kernel K4.  A conjugate pair of a real
operator is never split at the lock or the keep boundary, so the rotated
basis always matches H; a complex operator (or a complex shift of a real
one) runs the same loop in complex arithmetic, with the complex Schur form
(triangular: no pairs) and the complex kernels K1c / K2c, K3c, K4c, K6c.  The
eigenvectors of the non-Hermitian arm come from the locked Schur block as
Y = eig(T) and X = V Y, two K4 rotations (real and imaginary parts) when Y
is complex.  The basis keeps the port's row layout; H and the locked
Schur block are host numpy.

A complex problem (a complex A, a complex Hermitian B or a complex shift
of a real A) runs the blocked cycle with ``block_size`` > 1 on the fast
path and ignores ``cheb_block``, as the reference does (its fast path skips
the Chebyshev-amplified path for a complex dtype; the general loop reads
neither).
The device shift-and-invert ``STSinvertDevice`` raises NotImplementedError
for it: the reference has no complex one (its Pallas inner solve takes no
complex dtype).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..bv.bv import BV
from ..bv.krylov import extend_dispatch
from ..ds.compact import extract_compact, solve_arrow_hep
from ..ds.schur import schur, sort_schur
from ..ds.types import DSGHIEP
from ..mat.linop import LinearOperator, ShellOperator
from ..ops.bv import panel_update
from ..ops.rotate import rotate
from ..st.filter import STFilter
from ..st.sinvert_jit import STSinvertDevice
from ..st.st import STShift
from ..sys.events import log_event
from ..sys.sort import Which
from .base import (EPS, EPSConvergedReason, EPSSolver, ProblemType,
                   basis_combine, normalize_rows, op_mult, op_mult_block,
                   start_vector, work_dtype)
from .ks_jit import _np_dtype, ks_hep_solve

_WHICH = {Which.SMALLEST_REAL: "smallest",
          Which.SMALLEST_MAGNITUDE: "smallest",
          Which.LARGEST_REAL: "largest",
          Which.LARGEST_MAGNITUDE: "largest_magnitude"}


_NO_COMPLEX_SINVERT = (
    "EPS krylovschur: the device shift-and-invert (STSinvertDevice) takes "
    "a real problem only; the reference has no complex device "
    "shift-and-invert either (use STSinvert, the host factorization, for a "
    "complex operator or shift)")


def _check_ported(eps) -> None:
    if (eps.A.dtype.is_complex or (eps.B is not None
                                   and eps.B.dtype.is_complex)
            or np.imag(eps.st.sigma) != 0) \
            and isinstance(eps.st, STSinvertDevice):
        raise NotImplementedError(_NO_COMPLEX_SINVERT)
    if eps.problem_type == ProblemType.GHEP and eps.B is None:
        raise ValueError("problem_type='ghep' needs a B operator")


def _pair_keys(T: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Equalize sort keys within 2x2 blocks so pairs move together."""
    keys = keys.copy()
    i = 0
    n = T.shape[0]
    while i < n:
        if i + 1 < n and T[i + 1, i] != 0.0:
            kk = min(keys[i], keys[i + 1])
            keys[i] = keys[i + 1] = kk
            i += 2
        else:
            i += 1
    return keys


def _ritz_coefficients(T: Optional[np.ndarray], Q: np.ndarray,
                       theta: np.ndarray) -> np.ndarray:
    """Column i: the coefficients of the Ritz vector of theta[i] in the
    active basis, Q Y with Y = eig(T), each column of Y taken for the
    eigenvalue nearest theta[i].  (LAPACK's balancing may permute eig's
    order away from the Schur form's diagonal; the reference pairs them by
    position, slepc_tpu/eps/krylovschur.py:269, :312.)"""
    if T is None:
        return Q
    w, Y = np.linalg.eig(T)
    free = np.ones(len(w), bool)
    pick = []
    for t in theta:
        j = int(np.argmin(np.where(free, np.abs(w - t), np.inf)))
        free[j] = False
        pick.append(j)
    return Q @ Y[:, pick]


def _rayleigh_values(eps: EPS, X: torch.Tensor) -> np.ndarray:
    """Rayleigh quotients x^H A x / x^H B x of the rows of X on the
    original operators, A (and B) applied to the whole block at once
    (``mult_block``: K5 for a DIA operator)."""
    AX = op_mult_block(eps.A, X)
    num = (X.conj() * AX).sum(dim=1)
    if eps.B is not None:
        den = (X.conj() * op_mult_block(eps.B, X)).sum(dim=1)
    else:
        den = (X.abs() ** 2).sum(dim=1)
    return (num / den).cpu().numpy()


class KrylovSchur(EPSSolver):
    """Krylov-Schur with locking; HEP / GHEP / NHEP / GNHEP / PGNHEP, with
    the filter, harmonic, balanced, arbitrary and region variants."""

    keep = 0.5  # restart kept fraction

    def solve(self, eps) -> None:
        _check_ported(eps)
        st = eps.st
        if (eps.which == Which.ALL and eps.interval is not None
                and not isinstance(st, STFilter)):
            from .ks_slice import slice_solve

            slice_solve(eps)
            return
        if eps.problem_type == ProblemType.BSE:
            from .bse import KrylovSchurBSE

            KrylovSchurBSE().solve(eps)
            return
        if eps.two_sided and not (eps.is_hermitian and eps.B is None):
            # the coupled variant needs the transformed operator's adjoint;
            # without one EPS._solve_left runs the dual problem afterwards
            op_try = st.op()
            if not (isinstance(op_try, ShellOperator)
                    and op_try._rmatvec is None):
                from .ks_twosided import twosided_solve

                twosided_solve(eps)
                return
        op = st.op()
        # harmonic extraction forces the Schur machinery even for a
        # symmetric A (reference krylovschur.c:239)
        use_harmonic = eps.extraction == "harmonic"
        # a complex shift makes the transformed operator of a Hermitian
        # problem normal, not Hermitian: the Schur arm serves it
        hermitian = (eps.is_hermitian and not use_harmonic
                     and not st.requires_rayleigh
                     and np.imag(st.sigma) == 0)
        balance_d = None
        if (eps.balance and not hermitian and eps.B is None
                and type(st) is STShift and st.sigma == 0):
            from .balance import balanced_operator, krylov_balance

            balance_d = krylov_balance(eps.A, its=eps.balance_its)
            op = balanced_operator(eps.A, balance_d)
        filtered = isinstance(st, STFilter)
        if filtered:  # the Hermitian fast path serves filtered runs too
            hermitian = eps.is_hermitian and not use_harmonic
        dev_sinv = isinstance(st, STSinvertDevice)
        plain_shift = isinstance(st, STShift) and st.sigma == 0 \
            and eps.B is None
        # fast path: identity metric (the device sinvert's diagonal-B
        # symmetrization keeps it), no constraints, region or selection
        if (hermitian and (eps.problem_type == ProblemType.HEP or dev_sinv)
                and eps.deflation_space is None and eps.rg is None
                and eps.arbitrary is None and not eps.two_sided
                and (plain_shift or filtered or dev_sinv)
                and (dev_sinv or eps.which in _WHICH)):
            w = "largest_magnitude" if dev_sinv else _WHICH[eps.which]
            ks_hep_solve(eps, op, "largest" if filtered else w)
            return
        self._solve_general(eps, op, hermitian, balance_d)

    def _solve_general(self, eps, op, hermitian: bool,
                       balance_d: Optional[np.ndarray]) -> None:
        st = eps.st
        n, ncv, nev, mpd = eps.n, eps.ncv, eps.nev, eps.mpd
        A = eps.A
        dtype, device = work_dtype(eps, op), A.device
        cplx = dtype.is_complex
        # GHIEP's B is indefinite: the pseudo-Lanczos arm
        indefinite = eps.problem_type == ProblemType.GHIEP
        Bip: Optional[LinearOperator] = eps.B if eps.problem_type in (
            ProblemType.GHEP, ProblemType.GHIEP) else None
        use_harmonic = eps.extraction == "harmonic"

        def on_device(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)

        # ---- basis setup ----
        V = BV(n, ncv + 1, dtype, device=device)
        if Bip is not None:
            V.set_matrix(Bip, indef=indefinite)
        nc = 0
        if eps.deflation_space is not None:
            nc = V.insert_constraints(eps.deflation_space)
        if eps.initial_space is not None:
            v0 = eps.initial_space[:, 0]
        else:  # the reference's start vector, so both walk one trajectory
            v0 = start_vector(np.random.default_rng(0), n, dtype)
        V.set_column(0, v0)
        V.orthonormalize_column(0, replace_lindep=True)

        H = np.zeros((ncv + 1, ncv), _np_dtype(dtype))
        omega = None
        if indefinite:
            # the extension's signature, the start vector's own sign
            # included (the reference starts from all +1 and ignores it)
            omega = V.omega.copy() if V.indef else np.ones(ncv + 1 + nc)
            eps.gnhep_resolve = False  # set when the re-solve below runs
        omega_locked = np.ones(ncv)
        sc = eps.sort_criterion()
        k = 0  # nconv (locked)
        l = 0  # kept from the previous restart
        eigs_locked = np.zeros(ncv, dtype=complex)
        err_locked = np.zeros(ncv)
        # the locked Schur block (real quasi-triangular, or complex)
        Tlock = np.zeros((ncv, ncv), complex if cplx else float)
        breakdown_ct = 0

        while eps.its < eps.max_it:
            eps.its += 1
            nv = min(k + mpd, ncv)

            # ---- extension ----
            _, H, beta, brk = extend_dispatch(op, V.array, H, k + l, nv,
                                              nc=nc, Bop=Bip, omega=omega)
            if brk:
                breakdown_ct += 1
                if breakdown_ct > 10:
                    eps.reason = EPSConvergedReason.DIVERGED_BREAKDOWN
                    break
            S = H[k:nv, k:nv]

            # ---- projected solve (DS tier, host) ----
            g_harm = None  # the harmonic translate, when one applies
            if hermitian:
                Ssym = 0.5 * (S + S.conj().T)
                with log_event("DS_Solve", flops=9.0 * S.shape[0] ** 3):
                    dce = extract_compact(Ssym)
                    theta, Q = solve_arrow_hep(*dce) if dce is not None \
                        else np.linalg.eigh(Ssym)
                    Q = Q.astype(Ssym.dtype, copy=False)
                Tproj = None
            elif indefinite:
                om_act = omega[nc + k: nc + nv]
                with log_event("DS_Solve", flops=9.0 * S.shape[0] ** 3):
                    theta, Q = DSGHIEP().solve(0.5 * (S + S.conj().T), om_act)
                Tproj = None
                if np.iscomplexobj(Q) and np.abs(Q.imag).max() > 1e-10 * max(
                        np.abs(Q.real).max(), 1e-300):
                    # the indefinite pencil has complex conjugate pairs in
                    # this projection: the signature bookkeeping assumes a
                    # real spectrum, so re-solve as GNHEP (the reference's
                    # test18 expects the same output with
                    # -eps_gen_non_hermitian)
                    eps.problem_type = ProblemType.GNHEP
                    eps.gnhep_resolve = True
                    st._op = None
                    try:
                        self.solve(eps)
                    finally:
                        eps.problem_type = ProblemType.GHIEP
                    return
                if not cplx:
                    theta, Q = np.real(theta), np.real(Q)
            else:
                if use_harmonic:
                    # harmonic Ritz translate (DSTranslateHarmonic): solve
                    # (S - tau I)^H f = e_last and S_h = S + beta^2 f
                    # e_last^H; the Schur form and the sort use S_h, the
                    # locking and the restart recover projections of S so
                    # the Krylov relation stays exact
                    tau = 0.0
                    if eps.target is not None:
                        tau = complex(np.asarray(
                            st.eig_map(np.array([eps.target]))).ravel()[0])
                        if not cplx and abs(tau.imag) < 1e-300:
                            tau = tau.real
                    na_h = S.shape[0]
                    e_last = np.zeros(na_h, S.dtype)
                    e_last[-1] = 1.0
                    try:
                        f = np.linalg.solve(
                            (S - tau * np.eye(na_h)).conj().T, e_last)
                        if beta ** 2 * np.linalg.norm(f) < 1e8:
                            g_harm = (beta ** 2) * f
                            upd = np.outer(g_harm, e_last)
                            S = S + (upd if cplx else upd.real)
                    except np.linalg.LinAlgError:
                        g_harm = None
                with log_event("DS_Solve", flops=25.0 * S.shape[0] ** 3):
                    Tproj, Q, theta = schur(S)

            # ---- sort wanted-first (keys on back-transformed values) ----
            lam_approx = st.back_transform(theta)
            keys = sc.keys(lam_approx)
            if eps.arbitrary is not None:
                # arbitrary selection (EPSSetArbitrarySelection): keys from
                # a user function of (value, Ritz vector)
                Yc = _ritz_coefficients(Tproj, Q, theta)
                Xc = basis_combine(V.array[nc + k: nc + nv], Yc)
                keys = np.array([float(eps.arbitrary(lam_approx[i], Xc[i]))
                                 for i in range(nv - k)])
                del Xc
            if Tproj is None:
                order = np.argsort(keys, kind="stable")
                theta, Q = theta[order], Q[:, order]
            else:  # a complex Schur form is triangular: no pairs to keep
                Tproj, Q, theta = sort_schur(
                    Tproj, Q, keys if cplx else _pair_keys(Tproj, keys))
            lam_approx = st.back_transform(theta)

            # ---- convergence count ----
            na = nv - k
            last = Q[na - 1, :]
            resid = beta * np.abs(last)
            if Tproj is not None and not cplx:
                # a conjugate pair shares the 2-norm of the last row
                i = 0
                while i < na:
                    if i + 1 < na and Tproj[i + 1, i] != 0.0:
                        resid[i] = resid[i + 1] = np.hypot(resid[i],
                                                           resid[i + 1])
                        i += 2
                    else:
                        i += 1
            harmonic_on = g_harm is not None
            if harmonic_on:
                # per-column bound of the harmonic factorization
                resid = np.abs(last) * float(
                    np.sqrt(beta ** 2 + np.linalg.norm(g_harm) ** 2))
            errest = np.array([eps.conv_measure(theta[i], resid[i])
                               for i in range(na)])
            if eps.true_residual:
                # confirm candidates with ||A x - lam B x|| on the
                # original problem
                Yc = _ritz_coefficients(Tproj, Q, theta)
                if Tproj is not None and k > 0:
                    # an eigenvector of the whole quasi-triangular form:
                    # the locked part z solves (T_lock - lam) z = -C y
                    # (C the locked rows' coupling); the reference forms
                    # the active part alone, whose residual after a lock
                    # carries the coupling and never passes
                    Yc = np.vstack([np.stack([-np.linalg.solve(
                        Tlock[:k, :k] - theta[i] * np.eye(k),
                        H[:k, k:nv] @ Yc[:, i]) for i in range(na)], 1),
                        Yc])
                first = nc + k - (Yc.shape[0] - na)  # locked rows too
                Vact = V.array[first: nc + nv]
                i = 0
                while i < na and errest[i] < eps.tol:
                    x = basis_combine(Vact, Yc[:, i: i + 1])[0]
                    lam_i = complex(lam_approx[i])
                    if not x.is_complex():
                        lam_i = lam_i.real
                    bx = op_mult(eps.B, x) if eps.B is not None else x
                    r = op_mult(A, x) - lam_i * bx
                    rn = float(torch.linalg.vector_norm(r)) / max(
                        float(torch.linalg.vector_norm(x)), 1e-300)
                    errest[i] = eps.conv_measure(lam_i, rn)
                    i += 1
            if eps.rg is not None:
                outside = eps.rg.check_inside(lam_approx) < 0
                errest = np.where(outside, np.inf, errest)
            k2 = k
            while k2 < nv and errest[k2 - k] < eps.tol:
                k2 += 1
            if Tproj is not None and not cplx:
                # do not split a conjugate pair at the lock boundary
                d = k2 - k
                if 0 < d < na and Tproj[d, d - 1] != 0.0:
                    k2 -= 1

            # ---- monitors, stopping ----
            eps.nconv = k2
            eps.monitor(eps, eps.its, k2,
                        np.concatenate([eigs_locked[:k], lam_approx]),
                        np.concatenate([err_locked[:k], errest]))
            done = k2 >= nev or eps.its >= eps.max_it
            if eps.stopping is not None:
                done = eps.stopping(eps, eps.its, k2, nev) or done

            # ---- restart size (keep fraction) ----
            if done:
                l = 0
            else:
                l = max(1, int(self.keep * (nv - k2)))
                l = min(l, max(nv - k2 - 1, 0))
                if Tproj is not None and not cplx and l > 0:
                    # nor at the keep boundary
                    d = k2 - k + l
                    if d < na and Tproj[d, d - 1] != 0.0:
                        l += 1 if d + 1 < na else -1
            kl = (k2 - k) + l  # kept columns of Q

            # ---- lock bookkeeping ----
            eigs_locked[k:k2] = lam_approx[: k2 - k]
            err_locked[k:k2] = errest[: k2 - k]
            Tuse = Tproj
            if harmonic_on:
                # the recovered true projection: T_h - (Q^H g)(e^H Q)
                qg = Q.conj().T @ g_harm
                Tuse = Tproj - np.outer(qg, last)
                if not cplx:
                    Tuse = Tuse.real
            if Tproj is not None:
                Tlock[k:k2, k:k2] = Tuse[: k2 - k, : k2 - k]
                # coupling of the earlier locked vectors to the newly locked
                # ones: the eigenvectors of a non-normal problem need it
                Tlock[:k, k:k2] = H[:k, k:nv] @ Q[:, : k2 - k]
            else:
                idx = np.arange(k, k2)
                Tlock[idx, idx] = theta[: k2 - k]
            if indefinite:
                # the signature of each rotated vector: sign of diag(Q^H
                # Omega Q)
                sig = np.real(np.einsum("ij,i,ij->j", Q.conj(), om_act, Q))
                omega_locked[k:k2] = np.sign(sig[: k2 - k])

            if kl > 0:
                Vact = V.array[nc + k: nc + nv]
                arrow_beta = beta
                if not done and harmonic_on:
                    # the residual vector absorbs the dropped coupling:
                    # u = beta v_res - V_act (g - Q_kept (Q^H g)_kept), from
                    # the basis BEFORE the rotation overwrites its rows (one
                    # K3 update; row nv is not among the rotated rows)
                    c_u = -(g_harm - Q[:, :kl] @ qg[:kl])
                    if not cplx:
                        c_u = c_u.real
                    u = panel_update(Vact, on_device(-c_u[:, None]),
                                     beta * V.array[nc + nv][None])[0]
                    un = float(torch.linalg.vector_norm(u))
                    if un > 0:
                        V.array[nc + nv] = u / un
                        arrow_beta = un
                # ---- rotate: V[k:k+kl] = Q[:, :kl]^T V[k:nv] (K4) ----
                with log_event("BV_MultInPlace",
                               flops=2.0 * n * (nv - k) * kl):
                    rotate(on_device(Q[:, :kl]), Vact,
                           out=V.array[nc + k: nc + k + kl])
                # ---- H: locked block + kept block + arrow row ----
                H2 = np.zeros_like(H)
                H2[:k2, :k2] = Tlock[:k2, :k2]
                if not done and l > 0:
                    kept = slice(k2 - k, k2 - k + l)
                    if Tproj is None:
                        idx = np.arange(k2, k2 + l)
                        H2[idx, idx] = theta[kept]
                    else:
                        H2[k2: k2 + l, k2: k2 + l] = Tuse[kept, kept]
                        H2[k: k2, k2: k2 + l] = Tuse[: k2 - k, kept]
                        H2[:k, k2: k2 + l] = H[:k, k:nv] @ Q[:, kept]
                    H2[k2 + l, k2: k2 + l] = arrow_beta * last[kept]
                    if indefinite:
                        # H holds V^H B op V (op V = V Omega H): a kept
                        # Ritz vector q (T q = theta Omega q) has q^H B op q
                        # = sig theta, and the residual row is omega_nv
                        # beta (e^T Q); the reference keeps theta and beta
                        # (e^T Q), which leaves the next projection
                        # inconsistent (ROADMAP queue 3)
                        H2[idx, idx] *= np.sign(sig[kept])
                        H2[k2 + l, k2: k2 + l] *= omega[nc + nv]
                H = H2
                if not done:  # move the residual vector to row k2 + l
                    V.array[nc + k2 + l] = V.array[nc + nv]
                    if indefinite:
                        om2 = omega.copy()
                        om2[nc + k: nc + k2] = omega_locked[k:k2]
                        om2[nc + k2 + l] = omega[nc + nv]
                        om2[nc + k2: nc + k2 + l] = np.sign(
                            sig[k2 - k: k2 - k + l])
                        omega[:] = om2
            k = k2
            if done:
                break

        # ---- finalize ----
        eps.nconv = k
        eps.V = V
        Vl = V.array[nc: nc + k]
        if hermitian or indefinite or k == 0:
            X = Vl.clone()
            lam = np.asarray(st.back_transform(np.diagonal(Tlock)[:k].copy()))
            if indefinite:  # complex, as the reference returns them
                lam = lam.astype(complex)
        else:
            # eigenvectors from the locked Schur block: X = V Y
            w, Y = np.linalg.eig(Tlock[:k, :k])
            lam = np.asarray(st.back_transform(w))
            X = normalize_rows(basis_combine(Vl, Y))
        errests = err_locked[:k].copy()
        if st.requires_rayleigh and k > 0:
            # filtered run: Rayleigh quotients on the original A
            lam = _rayleigh_values(eps, X)
            order = np.argsort(lam.real)
            lam, X = lam[order], X[torch.from_numpy(order).to(device)]
            errests = errests[order]
        if balance_d is not None and k > 0:
            X = normalize_rows(X * torch.from_numpy(balance_d).to(device,
                                                                  dtype))
        if hermitian or (eps.is_hermitian and not use_harmonic):
            lam = np.real(lam)  # a Hermitian problem's values are real
        eps.eigenvalues = np.array(lam, copy=True)
        eps.errests = errests
        eps._eigenvectors = X


EPS.register("krylovschur", KrylovSchur)
