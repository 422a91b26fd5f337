"""Chebyshev-accelerated smallest-eigenpair solver — the flagship path
(``slepc_tpu/eps/cheb_accel.py``).

Plain thick-restart Lanczos on the smallest end of a large Laplacian-class
operator stalls (relative gaps ~1e-5 mean tens of thousands of columns).
This solver runs the Krylov-Schur cycle on the monotone Chebyshev amplifier
B = T_d(t(A)) (st/cheb.py) instead:

  * smallest eigenvalues of A = largest of B, with exponentially amplified
    relative gaps -> tens of columns per eigenpair instead of thousands;
  * p is an exact polynomial: the Krylov relation, residual estimates and
    locking machinery of the cycle apply unchanged;
  * eigenvectors of A are eigenvectors of EVERY p(A), so the filter window
    [lo, hi] adapts between restarts while converged rows stay locked;
  * final certification is Rayleigh-Ritz + true residuals on the ORIGINAL
    A, on the device, plus a shifted-MINRES polish.

Window adaptation: lo must sit above the wanted part of the spectrum, which
is unknown up front.  A one-cycle plain-Lanczos probe gives a safe starting
lo; whenever convergence exhausts the eigenvalues below lo, the converged
Rayleigh quotients extrapolate the next window.

A window that amplified nothing (lo below lambda_1, as the range clamp can
set the first one on a small grid at a high degree) locks bulk vectors, and
a window moved by ``_next_lo``'s unclamped x1.2 step can amplify lambda_1
far past the clamp's bound; then the filtered block overflows (b > 1), or
the filtered spectrum spans more than f64 resolves and the wanted rows are
lost (b = 1: a short count).  So every filtered apply checks its block,
and every cycle its Ritz values: a non-finite value, or a growth past
``_MAX_GROWTH``, raises :class:`EPSError` naming the degree and the window
(for b = 1 and b > 1 alike; the reference returns the short count, or
nconv 0 for b > 1: a deliberate divergence).

On a row mesh (a partitioned operator, ``parallel/halo.py``) the driver
runs unchanged on each rank's slab rows: its dots, norms and Gram
matrices go through ``mesh.allreduce``, its start vectors are the global
draws cut to the rank's rows, and the decisions taken on rank-local data
(the wall budget, the device's free memory) are made common first.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import scipy.linalg
import torch

from ..ops.bv import panel_dots
from ..ops.rotate import rotate
from ..st.cheb import ChebAmplifyOperator, cheb_value, gershgorin_upper
from ..sys.events import log_event
from ..sys.mesh import (allreduce, any_rank, combine_norms, reduces_over_op,
                        vector_norm)
from .base import EPSError
from .ks_jit import (_check_rot_mode, _hep_cycle_blocked_body,
                     _hep_cycle_body, _np_dtype, ks_hep_cycle)

_logger = logging.getLogger(__name__)


# The range clamp keeps max |p| <= cosh(34) ~ 2.9e14 when it is given the
# true lambda_1 (or 0); healthy windows clamped against a locked Rayleigh
# quotient reach ~2e1 times more (5.2e15, laplacian_2d(60, 60) at degree
# 40).  A filtered block that grows by 1e3 times more was amplified below
# the eigenvalues the solve knows of.
_MAX_GROWTH = 1e3 * np.cosh(34.0)


def _window_fault(bop, growth: float, what: str) -> EPSError:
    return EPSError(
        f"Chebyshev filter of degree {bop.degree} on the window "
        f"[{bop.lo:.6g}, {bop.hi:.6g}]: {what} {growth:.3e}, past the range "
        f"bound {_MAX_GROWTH:.1e} (an earlier window amplified nothing, or "
        f"the window moved past the clamp, so the filtered spectrum spans "
        f"more than the cycle resolves); lower the degree or give lo0 below "
        f"lambda_1")


class _CheckedAmplifier(ChebAmplifyOperator):
    """The solve's filter: every apply checks its block's growth (one host
    read of two norms, beside the cycle's own read per column)."""

    def _checked(self, Y, X):
        ny, nx = combine_norms(torch.stack(
            [torch.linalg.vector_norm(Y),
             torch.linalg.vector_norm(X)])).double().cpu()
        growth = float(ny) / max(float(nx), 1e-300)
        if not np.isfinite(growth) or growth > _MAX_GROWTH:
            raise _window_fault(self, growth, "a filtered block grew by")
        return Y

    def mult(self, x):
        return self._checked(super().mult(x), x)

    def mult_block(self, X):
        return self._checked(super().mult_block(X), X)


def _rayleigh_diag(op, V, k: int) -> np.ndarray:
    """Rayleigh quotients <v_i, A v_i> of the first k rows (inf past k)."""
    lam = np.full(V.shape[0], np.inf)
    if k > 0:
        vals = allreduce(torch.stack([torch.dot(V[i], op.mult(V[i]))
                                      for i in range(k)]))
        lam[:k] = vals.double().cpu().numpy()
    return lam


def _rr_refine(op, V, k: int):
    """Rayleigh-Ritz of A on span(V[:k]) + true residuals, on the device.

    Returns (tau ascending, resid, X) with tau and resid host numpy arrays
    and X the k rotated Ritz rows.  The rows V[:k] must be orthonormal.
    S is built row by row with one w = A v_i alive at a time (a (k, n)
    buffer of A V would double the certification's peak memory).
    """
    Vk = V[:k]
    S = torch.empty((k, k), dtype=V.dtype, device=V.device)
    for i in range(k):
        S[i] = panel_dots(Vk, op.mult(Vk[i])[None])[:, 0]
    S = allreduce(S).double().cpu().numpy()
    tau, Y = np.linalg.eigh(0.5 * (S + S.T))  # ascending
    X = rotate(torch.from_numpy(Y).to(V.device, V.dtype), Vk)
    res = combine_norms(torch.stack(
        [torch.linalg.vector_norm(op.mult(X[p]) - float(tau[p]) * X[p])
         for p in range(k)]))
    return tau, res.double().cpu().numpy(), X


def _polish_row(op, b, sigma: float, iters: int):
    """One Rayleigh-quotient-shifted inverse-iteration step for one row:
    fixed-iteration MINRES on (A - sigma I) y = b, normalized."""
    from ..ksp.iterative_jit import minres_fixed

    x = minres_fixed(lambda v: op.mult(v).sub_(v, alpha=sigma), b, iters,
                     rtol=1e-13)
    return x / vector_norm(x)


def _cg_polish(op, X, tau, *, k: int, iters: int, shift_rel: float = 1e-3):
    """Shifted inverse-iteration polish of the leading k rows of X (in
    place) — the refinement that breaks the filtered subspace's noise floor.

    A Krylov process on p(A) cannot push the filtered-subspace relative
    residuals far below the SpMV's rounding level relative to
    lambda_1/||A||.  The Rayleigh-quotient shift sigma_i = tau_i
    (1 - shift_rel) sits ~1000x closer to lam_i than to any boundary
    eigenvalue, so one MINRES round contracts the error outside the
    certified block by ~1e3-1e4.  shift_rel ~ 1e-3 keeps the shift
    distance far above cluster gaps, so near-degenerate rows map through
    the same well-conditioned resolvent and stay independent (the CholQR2
    re-orthonormalization then separates them exactly)."""
    for i in range(k):
        sigma = float(tau[i]) * (1.0 - shift_rel)
        X[i] = _polish_row(op, X[i], sigma, iters)
    return X


def _orthonormalize_rows(X, k: int):
    """Cholesky-QR2 on the leading k rows (Gram on the device, two small
    host Choleskys; the rows are near-orthonormal after polishing so the
    Gram is well-conditioned).  Returns a new (k, n) tensor."""
    Xk = X[:k]
    for _ in range(2):
        G = allreduce(Xk @ Xk.T).double().cpu().numpy()
        G = 0.5 * (G + G.T)
        # ridge: a rank-deficient block (degraded basis) must yield a
        # usable factor instead of NaN-poisoning the certification
        G += 1e-14 * max(np.trace(G) / k, 1e-300) * np.eye(k)
        L = np.linalg.cholesky(G)
        Li = scipy.linalg.solve_triangular(L, np.eye(k), lower=True)
        Xk = rotate(torch.from_numpy(np.ascontiguousarray(Li.T))
                    .to(X.device, X.dtype), Xk)
    return Xk


def _must_drop_basis(V, kc: int) -> bool:
    """Must the cycle basis be dropped before certification+polish?

    Peak extra memory past V is ~X + X' (2 x kc rows) plus the rotation
    buffers; compared with the device's free memory.  A host-memory basis
    is never dropped."""
    if V.device.type != "cuda":
        return False
    row_b = V.element_size() * V.shape[1]
    need = 2.2 * kc * row_b + 1.5e9
    free, _ = torch.cuda.mem_get_info(V.device)
    return any_rank(need > free)


def _clamp_window_exp(lo_new: float, lam1: float, hi: float, degree: int,
                      max_exp: float = 34.0) -> float:
    """Bound the worst-case amplification exponent degree*acosh(t(lam1)).

    max_exp=34 keeps p-values <= ~6e14.  Kept exactly as in the reference
    (where it guarded the f32 range of double-single arithmetic) so that
    both packages take the same window trajectories; under native f64 it
    could be relaxed once parity is established."""
    for _ in range(120):
        t1 = (hi + lo_new - 2.0 * min(lam1, lo_new)) / (hi - lo_new)
        if degree * np.arccosh(max(t1, 1.0)) <= max_exp:
            break
        lo_new *= 0.8
    return lo_new


def _next_lo(lamA, k2: int, m_t: int, lo: float, hi: float,
             degree: int) -> float:
    """Window controller: move lo so ~(m_t+2) eigenvalues sit below it."""
    if k2 <= 0:
        lo_new = lo * 3.0
    else:
        lam = np.sort(np.asarray(lamA[:k2], np.float64))
        if k2 >= 2 and lam[-1] > lam[0]:
            g = (lam[-1] - lam[0]) / (k2 - 1)
        else:
            g = max(abs(lam[-1]) * 1e-3, (hi - lo) * 1e-6)
        # linear extrapolation from the mean converged gap, plus a
        # power-law guess (eigenvalue counts of elliptic operators grow
        # like lam^{dim/2}; exponent 0.8 splits the 2-D/3-D cases) —
        # take the larger, growth clamped to [1.5x, 12x]
        lo_lin = lam[-1] + 1.3 * g * max(m_t + 2 - k2, 1)
        lo_pow = lam[-1] * ((m_t + 2) / max(k2, 1)) ** 0.8 \
            if lam[-1] > 0 else lo_lin
        lo_new = float(np.clip(max(lo_lin, lo_pow), lo * 1.5, lo * 12.0))
    lo_new = min(lo_new, hi / 4.0)
    lam1 = float(lamA[0]) if k2 > 0 else 0.0
    lo_new = _clamp_window_exp(lo_new, lam1, hi, degree)
    return max(lo_new, lo * 1.0000001) if lo_new > lo else lo * 1.2


@reduces_over_op
def ks_cheb_smallest(op, nev: int, tol: float, ncv: int = 48,
                     degree: int = 300, seed: int = 202,
                     budget_s: float = None, log=None, m_extra: int = None,
                     tol_b: float = 1e-13, max_cycles: int = 2000,
                     lo0: float = None, hi: float = None, probe: bool = True,
                     block: int = 1, reorth: str = "full",
                     keep_den: int = 2, rot_mode: str = "exact",
                     nrot: int = 0):
    """k smallest eigenpairs of Hermitian ``op`` via Chebyshev-amplified
    Krylov-Schur.  Returns a result dict (lam, resid, X, stats); X holds
    the eigenvector rows on the operator's device (a partitioned
    operator's slab rows).  ``block`` > 1 runs the blocked filtered cycle
    (ncv must be a multiple of it); ``reorth`` 'full' or 'partial' the
    single-column one (module docstring)."""
    block = max(int(block), 1)
    if block > 1 and ncv % block != 0:
        raise ValueError(f"ncv={ncv} must be a multiple of block={block}")
    _check_rot_mode(rot_mode)
    nxr = block  # basis rows past ncv
    t_start = time.perf_counter()
    log = log or _logger.info
    dev, dtype = op.device, op.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    m_t = min(nev + (m_extra if m_extra is not None else max(3, nev // 4)),
              ncv - 4)
    stats = {"cols": 0, "cycles": 0, "adaptations": 0, "certs": 0,
             "probe_s": 0.0}
    n = op.shape[0]
    n_g = op.n_global  # a partitioned operator's rows over every rank

    # ---- start vector ---------------------------------------------------
    v0 = torch.randn(n_g, generator=gen, dtype=torch.float64, device=dev)
    # the global draw cut to this rank's rows (all of them on one process),
    # so a partitioned solve starts where the one-card one does
    v0 = op.local_rows(v0 / torch.linalg.vector_norm(v0)).to(dtype)

    # ---- bounds: hi from Gershgorin, lo from a plain one-cycle probe ----
    # the probe runs on its own small basis (<= 33 rows)
    if hi is None:
        hi = gershgorin_upper(op)
    if lo0 is None and probe:
        t0 = time.perf_counter()
        ncv_p = min(ncv, 32)
        with log_event("EPS_ChebProbe", cols=ncv_p):
            Vp = torch.zeros((ncv_p + 1, n), dtype=dtype, device=dev)
            Vp[0] = v0
            Hp = np.zeros((ncv_p + 1, ncv_p), dtype=_np_dtype(dtype))
            o = ks_hep_cycle(op, Vp, Hp, 0, 1e-30, gen, ncv=ncv_p,
                             which="smallest")
            th = o[4]  # ascending Ritz values; th[0] > lambda_1
        lo0 = float(th[0] + 2e-3 * max(th[-1] - th[0], 1e-30))
        stats["probe_s"] = time.perf_counter() - t0
        stats["cols"] += ncv_p
        log(f"cheb: probe ritz_min={th[0]:.4e} -> lo0={lo0:.4e}, "
            f"hi={hi:.4e} ({stats['probe_s']:.1f}s)")
        # keep the probe's best Ritz row as the start vector
        v0 = Vp[0] / vector_norm(Vp[0])
        del o, Vp, Hp
    elif lo0 is None:
        lo0 = hi * 1e-4
    # the INITIAL window must respect the range cap too (lam1 unknown yet:
    # clamp against the SPD worst case lam1=0)
    lo0 = _clamp_window_exp(float(lo0), 0.0, hi, degree)
    lo = float(lo0)
    V = torch.zeros((ncv + nxr, n), dtype=dtype, device=dev)
    V[0] = v0
    if block > 1:
        # leading block: row 0 = the probe's best Ritz row, then b-1 seeded
        # random rows; CholQR2 is lower-triangular, so row 0 keeps its
        # direction
        V[1:block] = op.local_rows(torch.randn(
            (block - 1, n_g), generator=gen, dtype=torch.float64, device=dev))
        V[:block] = _orthonormalize_rows(V, k=block)
    hdtype = _np_dtype(dtype)
    H = np.zeros((ncv + nxr, ncv), dtype=hdtype)
    del v0

    # ---- filtered cycles: split form -----------------------------------
    bop = _CheckedAmplifier(op, lo, hi, degree)

    def cyc(bop, V, H, j0, tol):
        if block > 1:
            return _hep_cycle_blocked_body(bop, V, H, j0, tol, gen, ncv=ncv,
                                           b=block, which="largest")
        return _hep_cycle_body(bop, V, H, j0, tol, gen, ncv=ncv,
                               which="largest", keep_den=keep_den, nrot=nrot,
                               reorth=reorth)

    j0 = 0
    k2 = 0
    k2_prev, stall = -1, 0
    result = None
    cur_tol_b = tol_b
    lastcert_resid = None
    last_cert_cycle = -10
    k2_floor = 0  # monotone lock watermark (reset when tol_b tightens)
    tail_ref = None  # (cycle, k2) watermark for slow-tail retightening

    def _set_window(lo_new, lamA_locked, k2):
        """Move the filter window; rebuild H for the locked rows."""
        nonlocal bop, lo
        lo = float(lo_new)
        bop = _CheckedAmplifier(op, lo, hi, degree)
        Hh = np.zeros((ncv + nxr, ncv), hdtype)
        if k2 > 0:
            pv = cheb_value(np.asarray(lamA_locked[:k2]), lo, hi, degree)
            Hh[np.arange(k2), np.arange(k2)] = pv.astype(hdtype)
        return Hh

    while stats["cycles"] < max_cycles:
        if budget_s is not None and any_rank(
                time.perf_counter() - t_start > budget_s):
            log("cheb: wall budget hit")
            break
        newcols = ncv - j0 * block  # j0 is in block units if block > 1
        with log_event("EPS_KSCycle", cols=newcols):
            o = cyc(bop, V, H, j0, cur_tol_b)
        top = np.abs(np.asarray(o[4])).max()
        if not np.isfinite(top) or top > _MAX_GROWTH:
            raise _window_fault(bop, top, "the filtered Ritz values reach")
        V, H = o[0], o[1]
        j0 = int(o[2])
        # monotone lock watermark: the projected eigh on the huge-range
        # filtered H can wiggle a locked row's errest past tol_b and
        # un-count it; the leading rows remain the best Ritz vectors either
        # way, and certification re-checks ground truth on A
        k2 = max(int(o[3]), k2_floor)
        k2_floor = k2
        stats["cycles"] += 1
        stats["cols"] += newcols

        if stats["cycles"] % 20 == 0:
            log(f"cheb: cycle {stats['cycles']}, k2={k2}, lo={lo:.4e}, "
                f"cols={stats['cols']}, "
                f"{time.perf_counter() - t_start:.0f}s")

        # ---- certification ----
        # triggers: (a) the full m_t block is locked; (b) early-cert — the
        # wanted block plus a margin is locked and half the budget is spent
        early = (k2 >= nev + 6 and budget_s is not None
                 and any_rank(time.perf_counter() - t_start > 0.5 * budget_s))
        spaced = stats["cycles"] - last_cert_cycle >= 3
        if (k2 >= m_t or early) and spaced:
            last_cert_cycle = stats["cycles"]
            # certified block: locked rows up to nev + boundary margin
            kc_cap = min(nev + max(m_extra or 6, 6) + 2, ncv - 1) \
                if m_extra is not None else min(nev + 8, ncv - 1)
            kc = min(k2, max(kc_cap, nev + 2), ncv - 1)
            # a basis that must be dropped to fit V + X + X' makes the
            # certification terminal: defer it until the run is committed
            # (early/budget or tol_b at floor)
            big = _must_drop_basis(V, kc)
            committed = early or cur_tol_b <= 5e-16
            if big and not committed:
                cur_tol_b = max(cur_tol_b / 30.0, 5e-16)
                log(f"cheb: defer certification (basis must drop to "
                    f"certify, tol_b still loose); tighten tol_b -> "
                    f"{cur_tol_b:.1e}")
                k2_prev, stall = -1, 0
                k2_floor = 0
                continue
            drop = big
            if drop:
                log("cheb: terminal certification (basis dropped)")
            Vbox = [V]
            if drop:
                V = None
                o = None
            tau_np, rel, X, nok = _certify(op, Vbox, kc, nev, tol, hi, stats,
                                           log, drop=drop,
                                           orthonormalize=reorth != "full")
            if nok >= nev or drop:
                # terminal either way when the basis was dropped: the
                # filtered cycles cannot resume without it
                result = {"lam": tau_np[:nev], "resid": rel[:nev], "X": X,
                          "lam_all": tau_np,
                          "resid_all": rel, "nconv": min(nok, nev)}
                break
            # no-progress guard: identical residual at the tol_b floor
            # means more cycles cannot help — return best effort
            cur_max = float(rel[:nev].max()) if np.all(
                np.isfinite(rel[:nev])) else np.inf
            if (cur_tol_b <= 5e-16 and lastcert_resid is not None
                    and cur_max > 0.5 * lastcert_resid):
                log("cheb: certification stalled at the accuracy floor")
                result = {"lam": tau_np[:nev], "resid": rel[:nev], "X": X,
                          "lam_all": tau_np, "resid_all": rel,
                          "nconv": nok}
                break
            lastcert_resid = cur_max
            # subspace not yet accurate enough: tighten the filtered
            # tolerance and keep cycling (locked rows stay; k2 may drop)
            cur_tol_b = max(cur_tol_b / 30.0, 5e-16)
            log(f"cheb: tighten tol_b -> {cur_tol_b:.1e}")
            del X
            k2_prev, stall = -1, 0
            k2_floor = 0  # stricter tol_b must be allowed to un-count
            continue

        # ---- stall -> window adaptation ----
        # early trigger: the next (unconverged) filtered Ritz value sits
        # at bulk level, i.e. no amplified eigenvalue remains visible
        # below the current window
        theta_next = float(o[4][min(k2, ncv - 1)])
        exhausted = theta_next < 50.0
        if k2 == k2_prev:
            stall += 1
        else:
            stall = 0
        k2_prev = k2
        # slow-tail trigger: the wanted eigenpairs are in but the extra
        # boundary pairs crawl under a heavily-overshot window — retighten
        # the window around the actual spectrum
        slow_tail = (k2 >= nev and k2 < m_t and tail_ref is not None
                     and stats["cycles"] - tail_ref[0] >= 4
                     and k2 - tail_ref[1] < 2)
        if tail_ref is None or k2 > tail_ref[1]:
            tail_ref = (stats["cycles"], k2)
        if stall >= 3 or (exhausted and k2 < m_t) or slow_tail:
            with log_event("EPS_ChebAdapt"):
                lamA = _rayleigh_diag(op, V, max(k2, 0))
                lamA_np = lamA[:max(k2, 1)]
                # NaN guard: a poisoned basis row must not poison the
                # controller — drop non-finite Rayleigh quotients; with none
                # left, fall back to the k2=0 growth path
                finite = np.isfinite(lamA_np)
                if not finite.all():
                    lamA_np = lamA_np[finite]
                    if lamA_np.size == 0:
                        lamA_np = np.asarray([0.0])
                if slow_tail and k2 >= 2 and lamA_np.size >= 2:
                    lam_s = np.sort(lamA_np)
                    lo_new = float(lam_s[-1]
                                   * ((m_t + 2) / k2) ** 0.8 * 1.1)
                    lo_new = max(lo_new, float(lam_s[-1]) * 1.05)
                    lo_new = min(lo_new, hi / 4.0)
                    lo_new = _clamp_window_exp(lo_new, float(lam_s[0]), hi,
                                               degree)
                    tag = "retighten"
                else:
                    lo_new = _next_lo(lamA_np, min(k2, lamA_np.size), m_t,
                                      lo, hi, degree)
                    tag = "adapt"
                if not np.isfinite(lo_new) or lo_new <= 0:
                    lo_new = lo  # keep the last good window
                log(f"cheb: {tag} lo {lo:.4e} -> {lo_new:.4e} (k2={k2})")
                H = _set_window(lo_new, lamA_np, k2)
                # blocked: restart at the last complete locked block; rows past
                # it stay Ritz vectors and re-enter through the starting block
                j0 = k2 // block
            stats["adaptations"] += 1
            stall = 0
            k2_prev = -1
            tail_ref = (stats["cycles"], k2)

    stats["lo"] = lo
    stats["hi"] = hi
    stats["degree"] = degree
    if result is None:
        # best effort (budget/cycle cap): certify + polish what's locked;
        # terminal, so the cycle basis is dropped after the first
        # Rayleigh-Ritz
        kc_cap = min(nev + max(m_extra or 6, 6) + 2, ncv - 1) \
            if m_extra is not None else min(nev + 8, ncv - 1)
        kc = max(min(k2, max(kc_cap, nev + 2), ncv - 1), 1)
        Vbox = [V]
        V = None
        o = None
        tau_np, rel, X, nok = _certify(op, Vbox, kc, nev, tol, hi, stats,
                                       log, drop=True,
                                       orthonormalize=reorth != "full")
        result = {"lam": tau_np[: min(kc, nev)],
                  "resid": rel[: min(kc, nev)], "X": X,
                  "lam_all": tau_np, "resid_all": rel}
        result["nconv"] = min(nok, kc)
    result.setdefault("nconv", nev)
    result["stats"] = stats
    return result


def _certify(op, Vbox, kc: int, nev: int, tol: float, hi: float, stats,
             log, drop: bool = False, orthonormalize: bool = False):
    """Rayleigh-Ritz certification on A + shifted inverse-iteration polish.

    Error at eigenvalues just outside the certified block decays only like
    lam_wanted/lam_boundary per round, so only the wanted rows are polished
    while Rayleigh-Ritz runs over the full locked block.  SPD spectra only.

    ``Vbox``: single-element list holding the basis; with ``drop=True`` the
    basis is released right after the first Rayleigh-Ritz (the caller must
    clear its own reference first), so the polish never holds V + X + X'.
    ``orthonormalize``: CholQR2 the leading kc rows first (a semi-orthogonal
    basis from the partial extension), then release the basis.
    Returns (tau ascending, rel resid, X rows, nconv-leading)."""
    with log_event("EPS_ChebCertify") as span:
        t_cert0 = time.perf_counter()
        stats["certs"] += 1
        V = Vbox[0]
        if orthonormalize:
            Vq = _orthonormalize_rows(V, k=kc)
            del V
            if drop:
                Vbox[0] = None
            V = Vq
        tau_np, res, X = _rr_refine(op, V, kc)
        del V
        if drop:
            Vbox[0] = None
        rel = res / np.maximum(np.abs(tau_np), 1e-300)
        nwant = min(nev, kc)
        nok = int(np.sum(np.cumprod(rel[:nwant] <= tol)))
        log(f"cheb: certify k={kc}: nconv={nok}/{nev} "
            f"(max rel resid of wanted {rel[:nwant].max():.2e})")
        polish_rounds = 0
        kpol = min(nev + 6, kc)
        while (nok < nwant and polish_rounds < 4
               and float(tau_np[0]) > 0
               and np.all(np.isfinite(rel[:nwant]))
               and rel[:nwant].max() < 1e-3):
            kap = max(float(hi) / max(float(tau_np[0]), 1e-300), 1.0)
            p_iters = int(np.clip(11.0 * np.sqrt(kap), 200, 3000))
            log(f"cheb: MINRES polish round {polish_rounds + 1} "
                f"(iters={p_iters}, rows={kpol}/{kc})...")
            X = _cg_polish(op, X, tau_np, k=kpol, iters=p_iters)
            X = _orthonormalize_rows(X, k=kc)
            tau_np, res, X = _rr_refine(op, X, kc)
            rel = res / np.maximum(np.abs(tau_np), 1e-300)
            nok = int(np.sum(np.cumprod(rel[:nwant] <= tol)))
            polish_rounds += 1
            stats["polish_rounds"] = stats.get("polish_rounds", 0) + 1
            worst = np.argsort(rel[:nwant])[-3:][::-1]
            log(f"cheb: after polish: nconv={nok}/{nev} "
                f"(max rel resid {rel[:nwant].max():.2e}; worst rows "
                f"{worst.tolist()} = "
                f"{[float(f'{rel[w]:.2e}') for w in worst]})")
        stats["cert_s"] = stats.get("cert_s", 0.0) + (time.perf_counter()
                                                      - t_cert0)
        stats["cert_nok"] = nok
        if polish_rounds > 0:
            stats["polish_ok"] = bool(nok >= nwant)
            if nok < nwant:
                log(f"cheb: POLISH FAILED to reach tol: nconv={nok}/{nwant}, "
                    f"max rel resid {rel[:nwant].max():.2e} — returning "
                    f"best-effort eigenpairs")
        if span is not None:
            span["polish_rounds"] = polish_rounds
    return tau_np, rel, X, nok
