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
or CSR kernel on the card, each recurrence step three in-place vector
updates).  ``mult_block`` runs the same recurrence on a (b, n) block, with
the block SpMV (kernel K5 for a DIA base) per step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mat.linop import AIJOperator, DIAOperator, LinearOperator, as_operand
from ..ops.csr import csr_spmv
from ..sys.events import log_event


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

    @property
    def nnz(self):
        """Flop accounting: one apply streams the base ``degree`` times."""
        return int(getattr(self.base, "nnz", 0)) * max(self.degree, 1)

    def _recurrence(self, apply, x: torch.Tensor) -> torch.Tensor:
        """The ``degree`` steps on x, (n,) or a (b, n) block, inside the
        span ``ST_ChebApply`` (counts: ``degree``, and ``rows`` 1 or b)."""
        d = self.degree
        if d <= 0:
            return x
        a = 2.0 / (self.hi - self.lo)
        b = (self.hi + self.lo) / (self.hi - self.lo)
        with log_event("ST_ChebApply", degree=d,
                       rows=x.shape[0] if x.dim() == 2 else 1):
            # t1 = L(x) = b x - a A x
            t1 = apply(x).mul_(-a).add_(x, alpha=b)
            tm1, tk = x, t1
            for _ in range(1, d):
                # t_{k+1} = 2 L(t_k) - t_{k-1} = 2b t_k - 2a A t_k - t_{k-1}
                nxt = apply(tk).mul_(-2.0 * a).add_(tk, alpha=2.0 * b) \
                    .sub_(tm1)
                tm1, tk = tk, nxt
        return tk

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = as_operand(x, "ChebAmplifyOperator.mult", self.dtype,
                           self.device, self.shape[1])
        return self._recurrence(self.base.mult, x)

    def mult_block(self, X: torch.Tensor) -> torch.Tensor:
        """B applied to each row of the (b, n) block X: the same recurrence
        and in-place passes as :meth:`mult`, on whole blocks over the base's
        ``mult_block`` (kernel K5 for a DIA base; one ``mult`` per row for a
        base that has none)."""
        if not torch.is_tensor(X):
            X = as_operand(X, "ChebAmplifyOperator.mult_block", self.dtype,
                           self.device, self.shape[1], ndims=(2,))
        return self._recurrence(LinearOperator.block_of(self.base), X)


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
    """Upper bound on lambda_max from row sums of |a_ij| (safe ``hi``).

    DIA: the row sums of |diags|.  AIJ: the rigorous row-sum bound
    max_i sum_j |a_ij| from the CSR arrays, computed as |A| 1 with the CSR
    SpMV (K6 on the card over the operator's own row plan: |A| shares its
    rowptr; deterministic, no atomics).  The reference falls
    back to its power iteration for AIJ only because its hybrid pack hides
    the row sums (ROADMAP.md queue 3).  Any other operator: 30 steps of
    power iteration from a seeded ``torch.Generator``, times 1.1 -- an
    estimate, NOT a guaranteed bound.  A partitioned operator
    (``parallel/halo.py``): its slab's bound, the maximum over the ranks
    (one all-reduce MAX).
    """
    from ..parallel.halo import SlabOperator

    if isinstance(op, SlabOperator):
        t = torch.tensor([gershgorin_upper(op.slab)], dtype=torch.float64,
                         device=op.device)
        return float(op.mesh.allreduce(t, "max")[0])
    if isinstance(op, DIAOperator):
        return float(op.diags.abs().sum(dim=0).max())
    if isinstance(op, AIJOperator):
        ones = torch.ones(op.shape[1], dtype=op.dtype, device=op.device)
        sums = csr_spmv(op.rowptr, op.cols, op.vals.abs(), ones, op.shape[1],
                        plan=op.row_plan())
        return float(sums.max()) if sums.numel() else 0.0
    gen = torch.Generator(device=op.device).manual_seed(7)
    v = torch.randn(op.shape[0], generator=gen, dtype=op.dtype,
                    device=op.device)
    for _ in range(30):
        w = op.mult(v)
        v = w / torch.linalg.vector_norm(w)
    return float(torch.linalg.vector_norm(op.mult(v))) * 1.1
