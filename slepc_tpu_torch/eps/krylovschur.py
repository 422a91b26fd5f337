"""EPS Krylov–Schur (``slepc_tpu/eps/krylovschur.py``), Hermitian problems.

Three routes, as in the reference:

  * spectrum slicing (``which=ALL`` with an interval): ``ks_slice.py``;
  * the fast path (``ks_jit.ks_hep_solve``): standard Hermitian problem,
    identity metric, sigma = 0 shift with which = smallest / largest, or the
    device shift-and-invert ``STSinvertDevice`` (whose symmetrization keeps
    the identity metric; the wanted pairs are the transform's
    largest-magnitude ones);
  * the general host-orchestrated loop below, for HEP and GHEP with any ST
    (a host-factorized ``STSinvert`` / ``STCayley``, a generalized
    ``STShift``), ``mpd``, locking, deflation and initial spaces,
    ``true_residual``, ``stopping`` and monitors.

One outer iteration of the general loop: basis extension (``bv/krylov.py``:
the ST operator's apply + CGS2 on kernel K3 per column, B-metric for GHEP),
projected solve on the host (compact arrow + tridiagonal form when the
thick restart left one, else LAPACK eigh), restart as one rotation on
kernel K4.  The basis keeps the port's row layout; H and the locked values
are host numpy.

Not ported, each raising NotImplementedError naming ROADMAP queue 1 item
11: the non-Hermitian (Schur) arm, harmonic extraction, GHIEP
(pseudo-Lanczos), balancing, the two-sided and BSE variants, arbitrary
selection and region filtering.  ``STFilter`` is item 10.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..bv.bv import BV
from ..bv.krylov import extend_dispatch
from ..ds.compact import extract_compact, solve_arrow_hep
from ..mat.linop import LinearOperator
from ..ops.rotate import rotate
from ..st.sinvert_jit import STSinvertDevice
from ..st.st import STShift
from ..sys.events import log_event
from ..sys.sort import Which
from .base import EPSConvergedReason, ProblemType
from .ks_jit import ks_hep_solve

_WHICH = {Which.SMALLEST_REAL: "smallest",
          Which.SMALLEST_MAGNITUDE: "smallest",
          Which.LARGEST_REAL: "largest",
          Which.LARGEST_MAGNITUDE: "largest_magnitude"}
_TODO = "EPS krylovschur: {} is not ported (ROADMAP.md, queue 1, item 11)"


def _check_ported(eps) -> None:
    if eps.problem_type not in (ProblemType.HEP, ProblemType.GHEP):
        raise NotImplementedError(_TODO.format(
            f"problem_type={eps.problem_type.value!r} (only 'hep' and "
            f"'ghep' are)"))
    for flag, what in ((eps.extraction != "ritz", "harmonic extraction"),
                       (eps.balance, "balancing"),
                       (eps.two_sided, "the two-sided variant"),
                       (eps.arbitrary is not None, "arbitrary selection"),
                       (eps.rg is not None, "region filtering (rg)")):
        if flag:
            raise NotImplementedError(_TODO.format(what))
    if eps.problem_type == ProblemType.GHEP and eps.B is None:
        raise ValueError("problem_type='ghep' needs a B operator")


class KrylovSchur:
    """Krylov-Schur with locking for HEP / GHEP."""

    keep = 0.5  # restart kept fraction

    def solve(self, eps) -> None:
        _check_ported(eps)
        st = eps.st
        if eps.which == Which.ALL and eps.interval is not None:
            from .ks_slice import slice_solve

            slice_solve(eps)
            return
        dev_sinv = isinstance(st, STSinvertDevice)
        plain_shift = isinstance(st, STShift) and st.sigma == 0 \
            and eps.B is None
        # fast path: identity metric, no constraints (the device sinvert's
        # diagonal-B symmetrization keeps the identity metric)
        if (eps.deflation_space is None and (dev_sinv or (
                plain_shift and eps.which in _WHICH))):
            ks_hep_solve(eps, st.op(), "largest_magnitude" if dev_sinv
                         else _WHICH[eps.which])
            return
        self._solve_general(eps)

    def _solve_general(self, eps) -> None:
        st = eps.st
        op = st.op()
        n, ncv, nev, mpd = eps.n, eps.ncv, eps.nev, eps.mpd
        A = eps.A
        dtype, device = A.dtype, A.device
        if dtype.is_complex:
            raise NotImplementedError(_TODO.format("a complex operator"))
        Bip: Optional[LinearOperator] = \
            eps.B if eps.problem_type == ProblemType.GHEP else None

        def on_device(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)

        # ---- basis setup ----
        V = BV(n, ncv + 1, dtype, device=device)
        if Bip is not None:
            V.set_matrix(Bip)
        nc = 0
        if eps.deflation_space is not None:
            nc = V.insert_constraints(eps.deflation_space.T)
        if eps.initial_space is not None:
            v0 = eps.initial_space[:, 0]
        else:  # the reference's start vector, so both walk one trajectory
            v0 = np.random.default_rng(0).standard_normal(n)
        V.set_column(0, v0)
        V.orthonormalize_column(0, replace_lindep=True)

        H = np.zeros((ncv + 1, ncv))
        sc = eps.sort_criterion()
        k = 0  # nconv (locked)
        l = 0  # kept from the previous restart
        eigs_locked = np.zeros(ncv)
        err_locked = np.zeros(ncv)
        theta_locked = np.zeros(ncv)
        breakdown_ct = 0

        while eps.its < eps.max_it:
            eps.its += 1
            nv = min(k + mpd, ncv)

            # ---- extension ----
            _, H, beta, brk = extend_dispatch(op, V.array, H, k + l, nv,
                                              nc=nc, Bop=Bip)
            if brk:
                breakdown_ct += 1
                if breakdown_ct > 10:
                    eps.reason = EPSConvergedReason.DIVERGED_BREAKDOWN
                    break

            # ---- projected solve (DS tier, host) ----
            S = H[k:nv, k:nv]
            Ssym = 0.5 * (S + S.T)
            with log_event("DS_Solve", flops=9.0 * S.shape[0] ** 3):
                dce = extract_compact(Ssym)
                theta, Q = solve_arrow_hep(*dce) if dce is not None \
                    else np.linalg.eigh(Ssym)

            # ---- sort wanted-first (keys on back-transformed values) ----
            order = np.argsort(sc.keys(st.back_transform(theta)),
                               kind="stable")
            theta, Q = theta[order], Q[:, order]
            lam_approx = np.asarray(st.back_transform(theta), np.float64)

            # ---- convergence count ----
            na = nv - k
            last = Q[na - 1, :]
            resid = beta * np.abs(last)
            errest = np.array([eps.conv_measure(theta[i], resid[i])
                               for i in range(na)])
            if eps.true_residual:
                # confirm candidates with ||A x - lam B x|| on the
                # original problem
                Vact = V.array[nc + k: nc + nv]
                i = 0
                while i < na and errest[i] < eps.tol:
                    x = rotate(on_device(Q[:, i: i + 1]), Vact)[0]
                    bx = eps.B.mult(x) if eps.B is not None else x
                    r = A.mult(x) - float(lam_approx[i]) * bx
                    rn = float(torch.linalg.vector_norm(r)) / max(
                        float(torch.linalg.vector_norm(x)), 1e-300)
                    errest[i] = eps.conv_measure(lam_approx[i], rn)
                    i += 1
            k2 = k
            while k2 < nv and errest[k2 - k] < eps.tol:
                k2 += 1

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
            kl = (k2 - k) + l  # kept columns of Q

            # ---- lock bookkeeping ----
            eigs_locked[k:k2] = lam_approx[: k2 - k]
            err_locked[k:k2] = errest[: k2 - k]
            theta_locked[k:k2] = theta[: k2 - k]

            if kl > 0:
                # ---- rotate: V[k:k+kl] = Q[:, :kl]^T V[k:nv] (K4) ----
                with log_event("BV_MultInPlace",
                               flops=2.0 * n * (nv - k) * kl):
                    rotate(on_device(Q[:, :kl]), V.array[nc + k: nc + nv],
                           out=V.array[nc + k: nc + k + kl])
                # ---- H: locked diagonal + kept diagonal + arrow row ----
                H = np.zeros_like(H)
                idx = np.arange(k2)
                H[idx, idx] = theta_locked[:k2]
                if not done and l > 0:
                    idx = np.arange(k2, k2 + l)
                    H[idx, idx] = theta[k2 - k: k2 - k + l]
                    H[k2 + l, k2: k2 + l] = beta * last[k2 - k: k2 - k + l]
                if not done:  # move the residual vector to row k2 + l
                    V.array[nc + k2 + l] = V.array[nc + nv]
            k = k2
            if done:
                break

        # ---- finalize ----
        eps.nconv = k
        eps.V = V
        eps.eigenvalues = np.asarray(st.back_transform(theta_locked[:k]),
                                     np.float64).copy()
        eps.errests = err_locked[:k].copy()
        eps._eigenvectors = V.array[nc: nc + k].clone()
