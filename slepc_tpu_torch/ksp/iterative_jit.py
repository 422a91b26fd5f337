"""Fixed-iteration MINRES (``slepc_tpu/ksp/iterative_jit.py:64``).

Branch-free, as in the reference: the scalars of the Paige-Saunders
recurrence stay 0-d tensors on the vector's device and, once the residual
passes the floor, the updates are masked to zero, so the host never waits
on the device inside the loop and extra iterations are harmless (the count
is an upper bound, not an exact schedule).  CG and the rest of KSP are still
to be ported (ROADMAP.md, queue 1, item 9).
"""

from __future__ import annotations

import torch


def minres_fixed(mult, b: torch.Tensor, iters: int,
                 rtol: float = 1e-14) -> torch.Tensor:
    """MINRES on a symmetric (possibly indefinite) operator, fixed steps.

    Standard Paige-Saunders recurrence (Lanczos + Givens on the
    tridiagonal); covers interior-shift (A - sigma I) solves where CG breaks
    down.  ``mult``: v -> A v on tensors shaped like ``b``.
    """
    x = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    beta0 = torch.linalg.vector_norm(b)
    v = b / torch.where(beta0 > 0, beta0, one)
    v_old = torch.zeros_like(b)
    w = torch.zeros_like(b)
    w_old = torch.zeros_like(b)
    eta = beta0
    c, c_old = one, one
    s, s_old = zero, zero
    beta = beta0
    stop = rtol * beta0

    for _ in range(iters):
        live = eta.abs() > stop
        r_new = mult(v)
        alpha = torch.dot(v, r_new)
        r_new.sub_(alpha * v).sub_(beta * v_old)
        beta_new = torch.linalg.vector_norm(r_new)
        # two previous rotations
        delta = c * alpha - c_old * s * beta
        gamma2 = s * alpha + c_old * c * beta
        epsilon = s_old * beta
        # new rotation annihilating beta_new
        gamma1 = torch.sqrt(delta * delta + beta_new * beta_new)
        gsafe = torch.where(gamma1 > 0, gamma1, one)
        c_new = delta / gsafe
        s_new = beta_new / gsafe
        w_new = (v - gamma2 * w - epsilon * w_old) / gsafe
        x.add_(torch.where(live, c_new * eta, zero) * w_new)
        eta = torch.where(live, -s_new * eta, eta)
        v_new = r_new / torch.where(beta_new > 0, beta_new, one)
        v_old, v = v, v_new
        w_old, w = w, w_new
        c_old, c = c, c_new
        s_old, s = s, s_new
        beta = beta_new
    return x
