"""PEP QSlice -- spectrum slicing for hyperbolic symmetric QEPs
(``slepc_tpu/pep/qslice.py``).

Reference: src/pep/impls/krylov/stoar/qslice.c (the STOAR variant behind
PEPSetInterval; Campos & Roman): for a hyperbolic QEP (M > 0 and
(x^H C x)^2 > 4 (x^H M x)(x^H K x) for all x) every eigenvalue is real
and the INERTIA of P(sigma) = sigma^2 M + sigma C + K is monotone in
sigma within each branch -- nu(P(b)) - nu(P(a)) counts the eigenvalues in
(a, b), certified by LDL^T factorizations exactly like linear spectrum
slicing (EPSSliceGetInertia).

The worklist mirrors eps/ks_slice.py: bisect with inertia certificates,
solve each subinterval with a targeted TOAR run (on the coefficients'
device), merge.  The inertia is the port's ``DirectSolver.inertia`` of
the explicit P(sigma).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def _qep_inertia(pep, sigma: float) -> int:
    """Negative-eigenvalue count of P(sigma) (LDL^T via DirectSolver)."""
    from ..ksp.direct import DirectSolver
    from ..mat.linop import SumOperator
    from .pep import operator_of

    P = SumOperator(tuple(pep.mats),
                    tuple(sigma ** i for i in range(len(pep.mats)))).explicit()
    if P is None:
        raise ValueError("PEP interval: the inertia of P(sigma) needs "
                         "coefficients with explicit matrices")
    neg, zero, pos = DirectSolver(operator_of(P, pep.device)).inertia()
    if zero:
        return _qep_inertia(pep, sigma * (1 + 1e-8) + 1e-12)
    return neg


def qslice_solve(pep) -> None:
    """All eigenvalues of the hyperbolic QEP in pep.interval."""
    a, b = pep.interval
    ia, ib = _qep_inertia(pep, a), _qep_inertia(pep, b)
    total = abs(ib - ia)
    n = pep.n
    if total <= 0:
        pep.nconv = 0
        pep._set_results(np.array([]), np.array([]),
                         torch.zeros((0, n), dtype=torch.complex128,
                                     device=pep.device))
        return

    def count(lo: float, hi: float) -> int:
        return abs(_qep_inertia(pep, hi) - _qep_inertia(pep, lo))

    found: List[Tuple[float, float, torch.Tensor]] = []
    its_total = 0
    stack: List[Tuple[float, float, int]] = [(a, b, total)]
    guard = 0
    from .pep import PEP

    while stack and guard < 4 * total + 20:
        guard += 1
        lo, hi, cnt = stack.pop()
        if cnt <= 0:
            continue
        sigma = 0.5 * (lo + hi)
        sub = PEP(pep.mats, nev=max(2, cnt), solver="toar",
                  tol=pep.tol, ncv=min(2 * n, max(2 * cnt + 6, 16)))
        sub.set_target(sigma)
        sub.solve()
        its_total += sub.its
        for i in range(sub.nconv):
            lam_i = complex(sub.eigenvalues[i])
            if abs(lam_i.imag) > 1e-8 * max(1.0, abs(lam_i)):
                continue
            lr = float(lam_i.real)
            if lo - 1e-12 <= lr <= hi + 1e-12:
                if all(abs(lr - f[0]) > max(1e-10, pep.tol * 10 * max(1, abs(lr)))
                       for f in found):
                    err_i = float(sub.errests[i]) if i < len(sub.errests) else 0.0
                    found.append((lr, err_i, sub._eigenvectors[i]))
        n_found = sum(1 for f in found if lo - 1e-12 <= f[0] <= hi + 1e-12)
        if n_found < cnt:
            if hi - lo < 1e-10 * max(1.0, abs(a), abs(b)):
                continue
            cl = count(lo, sigma)
            ch = cnt - cl
            nf_l = sum(1 for f in found if lo - 1e-12 <= f[0] <= sigma)
            nf_h = sum(1 for f in found if sigma < f[0] <= hi + 1e-12)
            if cl - nf_l > 0:
                stack.append((lo, sigma, cl))
            if ch - nf_h > 0:
                stack.append((sigma, hi, ch))

    found.sort(key=lambda t: t[0])
    pep.its = its_total
    pep.nconv = len(found)
    if found:
        dt = found[0][2].dtype
        for f in found[1:]:
            dt = torch.promote_types(dt, f[2].dtype)
        X = torch.stack([f[2].to(dt) for f in found])
    else:
        X = torch.zeros((0, n), dtype=torch.complex128, device=pep.device)
    pep._set_results(np.array([f[0] for f in found]),
                     np.array([f[1] for f in found]), X)
