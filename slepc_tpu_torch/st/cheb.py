"""Chebyshev spectral acceleration — the low-end amplifier operator
(``slepc_tpu/st/cheb.py``).

    B = p(A),   p(lam) = T_d( (hi + lo - 2 lam) / (hi - lo) )

maps the unwanted bulk [lo, hi] into [-1, 1] and grows like
cosh(d * acosh(t(lam))) for lam < lo: the smallest eigenvalues of A become
the largest of B with exponentially amplified relative gaps, and the
smallest-first order is kept (p is monotone decreasing on (-inf, lo]).
p(A) is an exact polynomial, so the Krylov-Schur cycle's residual machinery
applies unchanged, and every eigenvector of A is an eigenvector of every
p(A): the window can move between restarts while converged rows stay
locked.

One filtered apply is ``degree`` SpMVs of the base operator, chained by the
three-term Chebyshev recurrence in a Python loop (each SpMV is the DIA
kernel on the card, each recurrence step three in-place vector updates).
"""

from __future__ import annotations

import numpy as np
import torch


class ChebAmplifyOperator:
    """B = T_degree((hi + lo - 2 A)/(hi - lo)) over any ``mult`` operator."""

    def __init__(self, base, lo: float, hi: float, degree: int):
        self.base = base
        self.lo = float(lo)
        self.hi = float(hi)
        self.degree = int(degree)

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        d = self.degree
        if d <= 0:
            return x
        a = 2.0 / (self.hi - self.lo)
        b = (self.hi + self.lo) / (self.hi - self.lo)
        # t1 = L(x) = b x - a A x
        t1 = self.base.mult(x).mul_(-a).add_(x, alpha=b)
        tm1, tk = x, t1
        for _ in range(1, d):
            # t_{k+1} = 2 L(t_k) - t_{k-1} = 2b t_k - 2a A t_k - t_{k-1}
            nxt = self.base.mult(tk).mul_(-2.0 * a).add_(tk, alpha=2.0 * b) \
                .sub_(tm1)
            tm1, tk = tk, nxt
        return tk


def cheb_value(lam, lo, hi, degree: int):
    """Host evaluation of p(lam) = T_d(t(lam)) (stable cosh/cos form).

    Used to rebuild locked diagonal entries when the filter window moves:
    locked rows hold eigenvectors of A, whose filtered eigenvalue under the
    NEW window is exactly p_new(lam).
    """
    lam = np.asarray(lam, np.float64)
    t = (hi + lo - 2.0 * lam) / (hi - lo)
    out = np.empty_like(t)
    inside = np.abs(t) <= 1.0
    out[inside] = np.cos(degree * np.arccos(t[inside]))
    big = t > 1.0
    # clamp the argument: f64 cosh overflows at ~710
    arg = degree * np.arccosh(np.maximum(t[big], 1.0))
    out[big] = np.cosh(np.minimum(arg, 700.0))
    neg = t < -1.0
    argn = degree * np.arccosh(np.maximum(-t[neg], 1.0))
    out[neg] = ((-1.0) ** degree) * np.cosh(np.minimum(argn, 700.0))
    return out


def gershgorin_upper(op) -> float:
    """Upper bound on lambda_max from row sums of |a_ij| (safe ``hi``) of a
    DIA operator."""
    diags = getattr(op, "diags", None)
    if diags is None:
        raise NotImplementedError(
            "gershgorin_upper is ported for DIA operators only (ROADMAP.md, "
            "queue 1, 'Remainders of items 1-7')")
    return float(diags.abs().sum(dim=0).max())
