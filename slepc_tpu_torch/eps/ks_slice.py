"""Spectrum slicing: all eigenvalues in an interval (``which=ALL``)
(``slepc_tpu/eps/ks_slice.py``).

Shift-and-invert Krylov-Schur runs at a moving shift, with the matrix
inertia at strategic points certifying that no eigenvalue is missed
(inertia = number of eigenvalues below sigma, read off the LDL^T
factorization); the interval is bisected until every subinterval's census
matches the eigenvalues found.

Factorization economy: a per-run :class:`_ShiftFactorCache` factorizes
A - sigma*B ONCE per distinct shift, serves the inertia certificate off the
LDL^T, and hands the same object to the sub-solver's STSinvert as its KSP.
Every factorization is logged as the event ``Slice_Factorization``.  A
tridiagonal or banded DIA operator keeps its DIA structure under the shift,
so its factorization, inertia and solves stay on the operator's device
(``ksp/tridiag_device.py``).

With ``eps.slice_npart = p > 1`` the interval splits into p
inertia-balanced partitions, which run one after another on the
operator's device.  The reference runs them concurrently, on a thread
pool on one device and on disjoint device groups on several
(``thread_map_submesh`` over ``slice_submeshes``).  On one card a
thread and a CUDA stream a partition ran slower than one after another:
each partition is a loop of small launches whose threads hand the
interpreter lock over at every torch call (ROADMAP W7; ``chip_smoke.py``
phase 8 times both).  Device groups need A, B and the factor cache placed
on each group's card, which waits for a test on several cards (ROADMAP
item 8).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ksp.ksp import KSP
from ..st.st import ST, STSinvert
from ..sys.events import log_event
from ..sys.sort import Which
from .base import EPS, EPSConvergedReason


class _ShiftFactorCache:
    """sigma -> factorized KSP on (A - sigma B), with inertia.

    One factorization per distinct shift serves BOTH the inertia
    certificate and the sinvert inner solves; probes are memoized so the
    partition-boundary search and the bisection worklist never re-factor a
    shift they have already visited."""

    def __init__(self, eps: EPS):
        mats = [eps.A] if eps.B is None else [eps.A, eps.B]
        self._st = ST(mats)  # for its explicit shifted matrix
        self._ksp: Dict[float, KSP] = {}
        self._inertia: Dict[float, int] = {}
        self.factorizations = 0

    def ksp(self, sigma: float) -> KSP:
        k = self._ksp.get(sigma)
        if k is None:
            with log_event("Slice_Factorization"):
                k = KSP(self._st._shifted_explicit(sigma, keep_dia=True),
                        method="direct")
                k._direct._factor()
            self._ksp[sigma] = k
            self.factorizations += 1
        return k

    def inertia(self, sigma: float) -> int:
        """Eigenvalues of (A, B) below sigma (B spd or identity)."""
        v = self._inertia.get(sigma)
        if v is not None:
            return v
        neg, zero, _ = self.ksp(sigma)._direct.inertia()
        if zero:
            # the shift hit an eigenvalue: perturb it
            return self.inertia(sigma * (1 + 1e-8) + 1e-12)
        self._inertia[sigma] = neg
        return neg

    def backends(self) -> Tuple[str, ...]:
        """The DirectSolver backends of the cached factorizations."""
        return tuple(sorted({k._direct.backend for k in self._ksp.values()}))


def _is_new(lam: float, found: List[float], tol: float) -> bool:
    return all(abs(lam - f) > max(1e-10, tol * 10 * max(1, abs(lam)))
               for f in found)


def _process_interval(eps: EPS, cache: _ShiftFactorCache,
                      a: float, b: float, total: int):
    """Inertia-certified bisection worklist for one partition; returns
    (lams, errs, Xs, its) for the eigenvalues found inside [a, b]."""
    found_lam: List[float] = []
    found_err: List[float] = []
    found_X: List[torch.Tensor] = []
    its_total = 0
    stack: List[Tuple[float, float, int]] = [(a, b, total)]
    guard = 0
    mats = [eps.A] if eps.B is None else [eps.A, eps.B]
    while stack and guard < 4 * total + 20:
        guard += 1
        lo, hi, cnt = stack.pop()
        if cnt <= 0:
            continue
        sigma = 0.5 * (lo + hi)
        sub = EPS(eps.A, eps.B, problem_type=eps.problem_type.value,
                  nev=cnt, tol=eps.tol,
                  ncv=min(eps.n, max(2 * cnt + 4, 16)))
        sub.set_target(sigma)
        sub.which = Which.TARGET_MAGNITUDE
        # the shift's cached factorization doubles as the sinvert KSP
        sub.set_st(STSinvert(mats, sigma=sigma, hermitian=eps.B is None,
                             ksp=cache.ksp(sigma)))
        sub.solve()
        its_total += sub.its
        for i in range(sub.nconv):
            lam_i = float(sub.eigenvalues[i])
            if lo - 1e-12 <= lam_i <= hi + 1e-12 \
                    and _is_new(lam_i, found_lam, eps.tol):
                found_lam.append(lam_i)
                found_err.append(float(sub.errests[i]))
                found_X.append(sub._eigenvectors[i])
        # census check: how many in (lo, hi) are now found?
        n_found = sum(1 for f in found_lam if lo - 1e-12 <= f <= hi + 1e-12)
        if n_found < cnt:
            # bisect at sigma with inertia certificates (memoized)
            cl = cache.inertia(sigma) - cache.inertia(lo)
            ch = cnt - cl
            nf_l = sum(1 for f in found_lam if lo - 1e-12 <= f <= sigma)
            nf_h = sum(1 for f in found_lam if sigma < f <= hi + 1e-12)
            if hi - lo < 1e-10 * max(1.0, abs(a), abs(b)):
                continue  # give up on a degenerate sliver (multiplicities)
            if cl - nf_l > 0:
                stack.append((lo, sigma, cl))
            if ch - nf_h > 0:
                stack.append((sigma, hi, ch))
    return found_lam, found_err, found_X, its_total


def _partitions(cache: _ShiftFactorCache, a: float, b: float, ia: int,
                ib: int, npart: int):
    """Inertia-balanced partition boundaries: bisection for the points
    where the census reaches i*total/npart (about 12 probe levels; every
    probe is memoized and seeds the factor cache)."""
    total = ib - ia
    bounds, counts, prev_i = [a], [], ia
    for i in range(1, npart):
        want = ia + (i * total) // npart
        lo_b, hi_b = bounds[-1], b
        for _ in range(12):
            mid = 0.5 * (lo_b + hi_b)
            if cache.inertia(mid) < want:
                lo_b = mid
            else:
                hi_b = mid
            if cache.inertia(hi_b) == want \
                    and hi_b - lo_b < 0.25 * (b - a) / npart:
                break
        bounds.append(hi_b)
        counts.append(cache.inertia(hi_b) - prev_i)
        prev_i = cache.inertia(hi_b)
    bounds.append(b)
    counts.append(ib - prev_i)
    return [(bounds[i], bounds[i + 1], counts[i])
            for i in range(npart) if counts[i] > 0]


def slice_solve(eps: EPS) -> None:
    """Compute ALL eigenvalues in eps.interval by inertia-certified
    bisection with shift-and-invert Krylov-Schur runs."""
    a, b = eps.interval
    cache = _ShiftFactorCache(eps)
    ia, ib = cache.inertia(a), cache.inertia(b)
    total = ib - ia
    if total <= 0:
        eps.nconv = 0
        eps.eigenvalues = np.array([])
        eps.errests = np.array([])
        eps._eigenvectors = torch.zeros((0, eps.n), dtype=eps.A.dtype,
                                        device=eps.A.device)
        eps.slice_factorizations = cache.factorizations
        eps.slice_backends = cache.backends()
        eps.reason = EPSConvergedReason.CONVERGED_TOL
        return

    npart = max(1, min(int(eps.slice_npart or 1), total))
    parts = [(a, b, total)] if npart == 1 \
        else _partitions(cache, a, b, ia, ib, npart)

    found_lam: List[float] = []
    found_err: List[float] = []
    found_X: List[torch.Tensor] = []
    its_total = 0
    for part in parts:
        lams, errs, Xs, its = _process_interval(eps, cache, *part)
        its_total += its
        for lam_i, err_i, x_i in zip(lams, errs, Xs):
            if _is_new(lam_i, found_lam, eps.tol):
                found_lam.append(lam_i)
                found_err.append(err_i)
                found_X.append(x_i)

    order = np.argsort(found_lam)
    eps.its = its_total
    eps.nconv = len(found_lam)
    eps.slice_factorizations = cache.factorizations
    eps.slice_backends = cache.backends()
    eps.eigenvalues = np.asarray(found_lam)[order]
    eps.errests = np.asarray(found_err)[order]
    eps._eigenvectors = torch.stack([found_X[i] for i in order]) \
        if found_X else torch.zeros((0, eps.n), dtype=eps.A.dtype,
                                    device=eps.A.device)
    eps.reason = (EPSConvergedReason.CONVERGED_TOL
                  if eps.nconv >= total else EPSConvergedReason.DIVERGED_ITS)
