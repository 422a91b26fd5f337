"""STFilter -- Chebyshev polynomial filtering for interval eigenproblems
(``slepc_tpu/st/filter.py``).

p(A) amplifies the eigenvalues inside [a, b] and damps the rest, so a
Krylov solver on p(A) finds interior eigenvalues with SpMVs alone, without
a factorization.  p is a damped Chebyshev expansion of the indicator of
[a, b] (Jackson or Lanczos sigma damping), or a smooth erf base filter in
the spirit of the reference's FILTLAN, over the spectral range [lmin, lmax]
(given, or estimated by a short seeded Lanczos run with a margin).

The filtered apply is the three-term Chebyshev recurrence over the base
operator's ``mult`` -- kernel K2 (f64) or K1 (f32) for a DIA operator, K6
for a CSR one -- with the recurrence's vector updates in place; ``mult_block``
runs it on a (b, n) block over the base's ``mult_block`` (K5 for DIA).  The
eigenvalues of p(A) say nothing about lambda, so the consuming EPS recovers
Rayleigh quotients on the original A (``requires_rayleigh``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.linalg as sla
import torch

from ..mat.linop import LinearOperator, as_operand
from .st import ST


def estimate_spectral_bounds(A: LinearOperator, its: int = 30, seed: int = 7):
    """[lmin, lmax] bounds of a Hermitian operator by Lanczos + margin.  The
    start vector is ``default_rng(seed)`` normals, so both packages draw
    the same one; one host read per step."""
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.standard_normal(n)).to(A.device, A.dtype)
    v = v / torch.linalg.vector_norm(v)
    its = min(its, n)
    alphas, betas = [], []
    vprev = torch.zeros_like(v)
    beta = 0.0
    for _ in range(its):
        w = A.mult(v) - beta * vprev
        alpha = float(torch.dot(v, w))
        w = w - alpha * v
        beta = float(torch.linalg.vector_norm(w))
        alphas.append(alpha)
        betas.append(beta)
        if beta < 1e-12:
            break
        vprev = v
        v = w / beta
    T = np.diag(alphas)
    for i in range(len(alphas) - 1):
        T[i, i + 1] = T[i + 1, i] = betas[i]
    w = sla.eigvalsh(T)
    margin = betas[-1] if betas else 0.0
    return float(w[0] - margin), float(w[-1] + margin)


def _chebyshev_indicator_coeffs(degree: int, a: float, b: float,
                                lmin: float, lmax: float,
                                damping: str = "jackson") -> np.ndarray:
    """Chebyshev coefficients of the [a,b] indicator on [lmin, lmax]."""
    # map lambda -> t in [-1,1]: t = (2 lambda - (lmax+lmin)) / (lmax-lmin)
    c = (lmax + lmin) / 2
    e = (lmax - lmin) / 2
    ta = (a - c) / e
    tb = (b - c) / e
    ta, tb = np.clip(ta, -1, 1), np.clip(tb, -1, 1)
    th_a, th_b = np.arccos(ta), np.arccos(tb)  # th_b <= th_a
    k = np.arange(1, degree + 1)
    mu = np.empty(degree + 1)
    mu[0] = (th_a - th_b) / np.pi
    mu[1:] = 2.0 * (np.sin(k * th_a) - np.sin(k * th_b)) / (k * np.pi)
    if damping == "jackson":
        N = degree + 1
        kk = np.arange(N)
        g = ((N - kk + 1) * np.cos(np.pi * kk / (N + 1))
             + np.sin(np.pi * kk / (N + 1)) / np.tan(np.pi / (N + 1))) / (N + 1)
        mu *= g
    elif damping == "lanczos":
        kk = np.arange(degree + 1)
        with np.errstate(invalid="ignore"):
            g = np.sinc(kk / (degree + 1))
        mu *= g
    return mu


def _smooth_base_coeffs(degree: int, a: float, b: float,
                        lmin: float, lmax: float,
                        trans: Optional[float] = None) -> np.ndarray:
    """Chebyshev coefficients of a FILTLAN-style smooth base filter: 1 on
    the plateau, erf transitions straddling the endpoints with value 0.5
    exactly at a and b.  Ringing-free with a flat plateau; the transition
    band is ~16/degree, wider than Jackson's ~3/degree."""
    c = (lmax + lmin) / 2
    e = (lmax - lmin) / 2
    ta = float(np.clip((a - c) / e, -1, 1))
    tb = float(np.clip((b - c) / e, -1, 1))
    if trans is None:
        # an erf transition of scale s = tau/2 needs degree*s >~ 8 for the
        # truncated expansion to be ringing-free
        trans = max(0.12 * (tb - ta), 16.0 / max(degree, 16))
    tau = float(min(trans, 0.49 * (tb - ta) if tb > ta else trans))

    from scipy.special import erf

    def phi(t):
        s = tau / 2.0
        up = 0.5 * (1.0 + erf((t - ta) / s))
        dn = 0.5 * (1.0 + erf((tb - t) / s))
        return up * dn

    # Chebyshev projection by Gauss-Chebyshev quadrature
    N = max(8 * degree, 2048)
    theta = (np.arange(N) + 0.5) * np.pi / N
    vals = phi(np.cos(theta))
    k = np.arange(degree + 1)
    mu = 2.0 / N * (np.cos(np.outer(k, theta)) @ vals)
    mu[0] *= 0.5
    return mu


class FilterOperator(LinearOperator):
    """p(A) = sum_k mu_k T_k((A - c I) / e) over the base operator A."""

    def __init__(self, base: LinearOperator, mu: np.ndarray, c: float,
                 e: float):
        self.base = base
        self.mu = [float(m) for m in mu]
        self.c, self.e = float(c), float(e)
        self.shape = base.shape
        self.dtype = base.dtype
        self.device = base.device

    @property
    def degree(self) -> int:
        return len(self.mu) - 1

    @property
    def nnz(self):
        return self.base.nnz * self.degree

    def _recurrence(self, apply, x: torch.Tensor) -> torch.Tensor:
        # T_0 = x, T_1 = As x, T_{k+1} = 2 As T_k - T_{k-1}, with
        # As = (A - c I) / e
        c, e, mu = self.c, self.e, self.mu

        def As(v):
            return apply(v).sub_(v, alpha=c).div_(e)

        tkm1, tk = x, As(x)
        y = x * mu[0] + tk * mu[1]
        for k in range(1, self.degree):
            tkp1 = As(tk).mul_(2.0).sub_(tkm1)
            y.add_(tkp1, alpha=mu[k + 1])
            tkm1, tk = tk, tkp1
        return y

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = as_operand(x, "FilterOperator.mult", self.dtype, self.device,
                           self.shape[1])
        return self._recurrence(self.base.mult, x)

    mult_h = mult  # p(A) of a Hermitian A

    def mult_block(self, X: torch.Tensor) -> torch.Tensor:
        """p(A) on each row of the (b, n) block X: the same recurrence on
        the base's ``mult_block``."""
        if not torch.is_tensor(X):
            X = as_operand(X, "FilterOperator.mult_block", self.dtype,
                           self.device, self.shape[1], ndims=(2,))
        return self._recurrence(LinearOperator.block_of(self.base), X)


class STFilter(ST):
    """Polynomial filter transform: Op = p(A) for the interval [a, b]."""

    name = "filter"
    requires_rayleigh = True  # the consumer recovers Rayleigh quotients

    def __init__(self, matrices, interval=(0.0, 1.0), degree: int = 100,
                 spectral_range: Optional[tuple] = None,
                 damping: str = "jackson", transition: Optional[float] = None):
        """damping: 'jackson' (damped indicator, the sharpest transition at
        ~3/degree; default), 'lanczos' (sigma-damped) or 'filtlan' (smooth
        erf base filter: flat plateau and 0.5 at the endpoints, a wider
        ~16/degree transition)."""
        super().__init__(matrices, sigma=0.0)
        self.interval = tuple(interval)
        self.degree = int(degree)
        self.range = spectral_range
        self.damping = damping
        self.transition = transition

    def _compute_operator(self) -> LinearOperator:
        A = self.A
        if self.range is None:
            self.range = estimate_spectral_bounds(A)
        lmin, lmax = self.range
        a, b = self.interval
        return FilterOperator(A, self._coeffs(a, b, lmin, lmax),
                              (lmax + lmin) / 2.0, (lmax - lmin) / 2.0)

    def _coeffs(self, a, b, lmin, lmax) -> np.ndarray:
        if self.damping == "filtlan":
            return _smooth_base_coeffs(self.degree, a, b, lmin, lmax,
                                       self.transition)
        return _chebyshev_indicator_coeffs(self.degree, a, b, lmin, lmax,
                                           self.damping)

    def filter_value(self, lam) -> np.ndarray:
        """p(lambda) evaluated on host scalars (thresholds, diagnostics)."""
        lmin, lmax = self.range
        a, b = self.interval
        mu = self._coeffs(a, b, lmin, lmax)
        t = (2.0 * np.asarray(lam, dtype=float) - (lmax + lmin)) / (lmax - lmin)
        t = np.clip(t, -1.0, 1.0)
        th = np.arccos(t)
        acc = mu[0] * np.ones_like(t)
        for k in range(1, len(mu)):
            acc = acc + mu[k] * np.cos(k * th)
        return acc

    def back_transform(self, eigs):
        # not invertible: the consumer recovers Rayleigh quotients
        return eigs
