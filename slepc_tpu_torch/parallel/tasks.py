"""Batched shifted solves over contour points, and a host thread pool
(``slepc_tpu/parallel/tasks.py``, in part).

Reference: SLEPc's subcommunicator machinery for CISS integration points
(slepccontour.c:85-168).  The reference batches the points' shifted solves
into one vmapped BiCGStab; here every point of a batch runs in one PyTorch
loop over a (points, L, n) block, each step one block product of the
operator (``mult_block``: kernel K5 for a real DIA operator, applied to
the complex block's real and imaginary rows, ``mat/linop.py``
``apply_by_parts``) and a few elementwise updates.  A point whose residual
passed its tolerance keeps its iterate while the others go on (the
vmapped while-loop's lockstep: a batch stops at its largest count).  Host
factorizations run on a thread pool (:func:`thread_map`).

Layout: a right-hand side block is the row-major (L, n) tensor of the
reference's (n, L) columns, and the solutions come back as (points, L, n).

Not ported: the device meshes ``make_task_mesh``, ``slice_submeshes`` and
``thread_map_submesh`` (ROADMAP.md, queue 1, item 16).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..mat.linop import (AIJOperator, DenseOperator, DIAOperator,
                         LinearOperator, apply_by_parts)
from ..ops.csr import row_of_entry

_TODO_MESH = ("a task mesh for the contour points is still to be ported "
              "(ROADMAP.md, queue 1, item 16)")


def _op_diag(op, n: int) -> torch.Tensor:
    """The operator's diagonal (for Jacobi preconditioning): a DIA
    operator's main diagonal (zeros without one), a dense matrix's, a CSR
    matrix's on-diagonal entries summed per row; zeros for an operator
    with no diagonal to read (a shell or composed operator), as the
    reference returns."""
    if isinstance(op, DIAOperator):
        if 0 in op.offsets:
            return op.diags[op.offsets.index(0)][:n]
        return torch.zeros(n, dtype=op.dtype, device=op.device)
    if isinstance(op, DenseOperator):
        return torch.diagonal(op.A)
    if isinstance(op, AIJOperator):
        rows = row_of_entry(op.rowptr)
        on = op.cols.to(torch.int64) == rows
        d = torch.zeros(n, dtype=op.dtype, device=op.device)
        return d.index_add_(0, rows[on], op.vals[on])
    return torch.zeros(n, dtype=op.dtype, device=op.device)


def solve_dtype(A, B=None) -> torch.dtype:
    """The complex type of the shifted solves: complex128 for a float64 /
    complex128 pencil, complex64 for single precision (the reference runs
    complex128 throughout; the port's kernels take one precision a call)."""
    dt = A.dtype if B is None else torch.promote_types(A.dtype, B.dtype)
    return torch.promote_types(dt, torch.complex64)


def _block_mult(op, X: torch.Tensor) -> torch.Tensor:
    """op on every row of the (P, L, n) block X (complex rows of a real
    operator as their real and imaginary parts)."""
    P, L, n = X.shape
    Y = apply_by_parts(LinearOperator.block_of(op), X.reshape(P * L, n),
                       op.dtype)
    return Y.reshape(P, L, n)


def _bicgstab_block_counted(A, B, z: torch.Tensor, R: torch.Tensor,
                            diagA: torch.Tensor, diagB: torch.Tensor,
                            tol: float, maxiter: int):
    """Jacobi-preconditioned BiCGStab for (z_j B - A) Y_j = R at every
    point z_j at once, with an iteration counter per point.  The (L, n)
    block R is one long vector (one Krylov sequence per point, the
    reference's contract, tasks.py:84-90).  A point stops when
    ||r_j|| <= tol ||R|| or after ``maxiter`` steps and keeps its iterate
    from then on.  Returns (Y (P, L, n), iters (P,) numpy ints)."""
    P = z.shape[0]
    d = z[:, None] * diagB[None, :] - diagA[None, :]
    dinv = torch.where(d.abs() > 1e-300, 1.0 / d, torch.ones_like(d))
    zb = z[:, None, None]

    def mv(X):
        BX = _block_mult(B, X) if B is not None else X
        return zb * BX - _block_mult(A, X)

    def prec(X):
        return dinv[:, None, :] * X

    def vdot(a, c):  # per point, over its (L, n) block
        return torch.linalg.vecdot(a.reshape(a.shape[0], -1),
                                   c.reshape(c.shape[0], -1), dim=1)

    def one(t):  # a zero denominator taken as one
        return torch.where(t == 0, torch.ones_like(t), t)

    atol2 = (tol * float(torch.linalg.vector_norm(R))) ** 2
    rhat = R[None]
    x = torch.zeros((P,) + tuple(R.shape), dtype=R.dtype, device=R.device)
    r = R.expand_as(x).clone()
    p = torch.zeros_like(x)
    v = torch.zeros_like(x)
    rho = torch.ones(P, dtype=R.dtype, device=R.device)
    alpha, omega = rho.clone(), rho.clone()
    k = torch.zeros(P, dtype=torch.int64, device=R.device)
    while True:
        act = (k < maxiter) & (vdot(r, r).real > atol2)
        if not bool(act.any()):
            break
        a3 = act[:, None, None]
        rho1 = vdot(rhat, r)
        beta = (rho1 / one(rho)) * (alpha / one(omega))
        p_new = r + beta[:, None, None] * (p - omega[:, None, None] * v)
        phat = prec(p_new)
        v_new = mv(phat)
        alpha_new = rho1 / one(vdot(rhat, v_new))
        s = r - alpha_new[:, None, None] * v_new
        shat = prec(s)
        t = mv(shat)
        omega_new = vdot(t, s) / one(vdot(t, t))
        x = torch.where(a3, x + alpha_new[:, None, None] * phat
                        + omega_new[:, None, None] * shat, x)
        r = torch.where(a3, s - omega_new[:, None, None] * t, r)
        p = torch.where(a3, p_new, p)
        v = torch.where(a3, v_new, v)
        rho = torch.where(act, rho1, rho)
        alpha = torch.where(act, alpha_new, alpha)
        omega = torch.where(act, omega_new, omega)
        k += act.to(torch.int64)
        del p_new, v_new, phat, s, shat, t
    return x, k.cpu().numpy()


def _diags(A, B, n: int):
    diagA = _op_diag(A, n)
    diagB = _op_diag(B, n) if B is not None else \
        torch.ones(n, dtype=A.dtype, device=A.device)
    return diagA, diagB


def _rhs(A, B, RHS) -> torch.Tensor:
    R = RHS if torch.is_tensor(RHS) else torch.from_numpy(np.asarray(RHS))
    return R.to(A.device, solve_dtype(A, B)).contiguous()


def batched_shifted_solves(A, B, z: np.ndarray, RHS, *, tol: float = 1e-10,
                           maxiter: int = 1000, mesh=None) -> torch.Tensor:
    """Y[j] = (z_j B - A)^{-1} RHS for all contour points j, in one batch
    (Jacobi-preconditioned BiCGStab, B=None meaning the identity).  RHS is
    (L, n); returns Y as a (npt, L, n) complex tensor on A's device.  The
    reference runs jax.scipy's BiCGStab here, which also stops a point on a
    breakdown; ``mesh`` (a task mesh sharding the points over device
    groups) is ROADMAP item 16 and raises."""
    if mesh is not None:
        raise NotImplementedError(_TODO_MESH)
    R = _rhs(A, B, RHS)
    diagA, diagB = _diags(A, B, R.shape[1])
    zt = torch.from_numpy(np.asarray(z, dtype=complex)).to(A.device, R.dtype)
    return _bicgstab_block_counted(A, B, zt, R, diagA.to(R.dtype),
                                   diagB.to(R.dtype), tol, maxiter)[0]


def batched_shifted_solves_adaptive(
        A, B, z: np.ndarray, RHS, *, tols: np.ndarray, maxiter: int = 1000,
        nbuckets: int = 3,
        consume: Optional[Callable[[np.ndarray, torch.Tensor], None]] = None):
    """Per-point-tolerance contour solves: the points are ordered by an
    expected cost, log(1/tol_j) / |Im z_j| (a distance-to-the-spectrum
    proxy for a real spectrum), and cut into ``nbuckets`` batches, each
    solved at its tightest tolerance, so that loose points stop earlier
    (within one batch the loop runs to its largest count).  Reference
    role: the per-point inner-KSP tolerance control of the contour
    machinery (slepccontour.c:22-118, ciss.c:283-316).

    ``consume(idx, Yb)``, when given, takes each batch's solutions (Yb
    (len(idx), L, n) for the points ``idx``) as they come, and no (npt, L,
    n) block is kept; else the solutions come back whole.  Returns (Y or
    None, info) with info's per-bucket {points, tol, iters} and
    ``inner_iters``, the sum over buckets of points x largest count."""
    R = _rhs(A, B, RHS)
    L, n = R.shape
    npt = len(z)
    zc = np.asarray(z, dtype=complex)
    diagA, diagB = _diags(A, B, n)
    diagA, diagB = diagA.to(R.dtype), diagB.to(R.dtype)
    tols = np.asarray(tols, dtype=float)
    dist = np.maximum(np.abs(zc.imag), 1e-3 * np.maximum(np.abs(zc), 1.0))
    est = np.log(1.0 / np.clip(tols, 1e-16, 1e-1)) / dist
    order = np.argsort(est)
    Y = None if consume is not None else \
        torch.empty((npt, L, n), dtype=R.dtype, device=R.device)
    info = {"buckets": [], "inner_iters": 0}
    for bkt in range(nbuckets):
        idx = order[bkt * npt // nbuckets: (bkt + 1) * npt // nbuckets]
        if idx.size == 0:
            continue
        tol_b = float(tols[idx].min())
        zt = torch.from_numpy(zc[idx]).to(A.device, R.dtype)
        Yb, it = _bicgstab_block_counted(A, B, zt, R, diagA, diagB, tol_b,
                                         maxiter)
        if consume is not None:
            consume(idx, Yb)
        else:
            Y[torch.from_numpy(idx).to(R.device)] = Yb
        del Yb
        it_max = int(np.max(it))
        info["buckets"].append({"points": int(idx.size), "tol": tol_b,
                                "iters": it_max})
        info["inner_iters"] += it_max * int(idx.size)
    return Y, info


def thread_map(fn, items: Sequence, max_workers: Optional[int] = None):
    """Run fn over items on a thread pool, preserving order: the host tier
    of the subcommunicator task parallelism (scipy's factorizations release
    the interpreter lock).  CISS's per-point factorizations use it."""
    from concurrent.futures import ThreadPoolExecutor

    if len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=max_workers or min(8, len(items))) \
            as ex:
        return list(ex.map(fn, items))
