"""Fixed-iteration CG and MINRES (``slepc_tpu/ksp/iterative_jit.py``): the
inner solves of the device shift-and-invert tier (``st/sinvert_jit.py``).

Branch-free, as in the reference: the scalars of each recurrence stay 0-d
tensors on the vector's device and, once the residual passes the floor, the
updates are masked to zero (``torch.where``), so the host never waits on the
device inside the loop -- a host read per step would cost ``iters``
synchronizations per Krylov column -- and extra iterations are harmless
(the count is an upper bound, not an exact schedule).

MINRES's dots and norms go through ``sys/mesh.py``'s reductions, so the
Chebyshev driver's polish runs on a row mesh's slab rows too.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..mat.linop import as_operand
from ..sys.mesh import allreduce, vector_norm


def cg_fixed(mult: Callable, b: torch.Tensor, iters: int,
             Minv: Optional[Callable] = None,
             x0: Optional[torch.Tensor] = None,
             rtol: float = 1e-14) -> torch.Tensor:
    """Conjugate gradients on an SPD operator, fixed ``iters`` steps.

    ``mult``: v -> A v on tensors shaped like ``b``; ``Minv``: optional SPD
    preconditioner application.  Returns x with ||b - A x|| <= ~rtol ||b||
    once the budget allows (updates masked after convergence).  x, r and p
    are updated in place.  A numpy ``b`` (or ``x0``) goes to the device
    of the other when that is a tensor, else to the default device (the
    array rule, ``mat/linop.py`` ``as_operand``).
    """
    if not torch.is_tensor(b):
        dev = x0.device if torch.is_tensor(x0) else None
        b = as_operand(b, "cg_fixed", None, dev)
    if x0 is not None and not torch.is_tensor(x0):
        x0 = as_operand(x0, "cg_fixed", b.dtype, b.device, b.shape[0])
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - mult(x) if x0 is not None else b.clone()
    z = Minv(r) if Minv is not None else r
    p = z.clone()
    rz = torch.dot(r, z)
    stop2 = (rtol * torch.linalg.vector_norm(b)) ** 2
    for _ in range(iters):
        Ap = mult(p)
        pAp = torch.dot(p, Ap)
        live = (torch.dot(r, r) > stop2) & (pAp > 0)
        alpha = torch.where(live, rz / torch.where(pAp != 0, pAp, one), zero)
        x.add_(alpha * p)
        r.sub_(alpha * Ap)
        z = Minv(r) if Minv is not None else r
        rz2 = torch.dot(r, z)
        beta = torch.where(live, rz2 / torch.where(rz != 0, rz, one), zero)
        p.mul_(beta).add_(z)
        rz = torch.where(live, rz2, rz)
    return x


def minres_fixed(mult: Callable, b: torch.Tensor, iters: int,
                 rtol: float = 1e-14) -> torch.Tensor:
    """MINRES on a symmetric (possibly indefinite) operator, fixed steps.

    Standard Paige-Saunders recurrence (Lanczos + Givens on the
    tridiagonal); covers interior-shift (A - sigma I) solves where CG breaks
    down.  ``mult``: v -> A v on tensors shaped like ``b``; a numpy ``b``
    goes to the default device.
    """
    if not torch.is_tensor(b):
        b = as_operand(b, "minres_fixed")
    x = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    beta0 = vector_norm(b)
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
        alpha = allreduce(torch.dot(v, r_new))
        r_new.sub_(alpha * v).sub_(beta * v_old)
        beta_new = vector_norm(r_new)
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
