"""Task parallelism: batched shifted solves over contour points, task
meshes, slicing sub-meshes and a host thread pool
(``slepc_tpu/parallel/tasks.py``).

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

The reference's subcommunicators (SLEPc's PetscSubcomm) map to process
groups here: :func:`make_task_mesh` is a ``torch.distributed`` group over
the ranks, and ``batched_shifted_solves(mesh=)`` gives each rank a
contiguous block of the points and one all-gather joins the solutions.
:func:`slice_submeshes` groups the visible cards, and
:func:`thread_map_submesh` runs each item with its group's lead card as
the current card.  That moves no tensor: an item whose tensors already
sit on a card runs there.  :func:`slice_partition_leads` is the same
rule over the ranks of a task mesh: spectrum slicing runs partition i on
the lead rank of group i mod the number of groups (``eps/ks_slice.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..mat.linop import (AIJOperator, DenseOperator, DIAOperator,
                         LinearOperator, apply_by_parts)
from ..ops.csr import row_of_entry
from ..sys.mesh import RowMesh


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
    breakdown.  With a task mesh (:func:`make_task_mesh`) each rank solves
    a contiguous block of the points (every rank holds A and B whole) and
    one all-gather gives every rank all of Y."""
    R = _rhs(A, B, RHS)
    diagA, diagB = _diags(A, B, R.shape[1])
    zc = np.asarray(z, dtype=complex)
    npt = len(zc)
    lo, hi = (0, npt) if mesh is None else mesh.row_range(npt)
    zt = torch.from_numpy(zc[lo:hi]).to(A.device, R.dtype)
    Y = _bicgstab_block_counted(A, B, zt, R, diagA.to(R.dtype),
                                diagB.to(R.dtype), tol, maxiter)[0]
    if mesh is None:
        return Y
    return mesh.gather_rows(Y.permute(1, 2, 0), npt).permute(2, 0, 1)


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


def make_task_mesh(ntasks: Optional[int] = None,
                   device=None) -> Optional[RowMesh]:
    """A process group over the contour points (reference
    ``make_task_mesh``, tasks.py:30): the first ``ntasks`` ranks (default:
    all).  Every rank must call it (a group is made collectively); a rank
    outside the group gets None and solves every point itself.
    ``device``: as :class:`~slepc_tpu_torch.sys.mesh.RowMesh`'s."""
    import torch.distributed as dist

    world = dist.get_world_size()
    ntasks = world if ntasks is None else min(int(ntasks), world)
    if ntasks == world:
        return RowMesh(None, device)
    group = dist.new_group(list(range(ntasks)))
    return RowMesh(group, device) if dist.get_rank() < ntasks else None


def slice_submeshes(npart: int, devices: Optional[Sequence] = None):
    """Disjoint contiguous groups of cards for spectrum slicing's
    partitions (reference ``slice_submeshes``, tasks.py:211; SLEPc's npart
    subcommunicators, ks-slice.c:341-416): ``devices`` (default: every
    visible CUDA card) split into at most ``npart`` groups of equal size,
    in order.  None when fewer than two devices are given or one partition
    is asked for (nothing to split)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if npart <= 1 or len(devices) < 2:
        return None
    return _split(npart, devices)


def _split(npart: int, members: Sequence):
    """``members`` in at most ``npart`` contiguous groups of max(1,
    len // npart), in order (the reference's rule, tasks.py:227-229)."""
    per = max(1, len(members) // npart)
    ngroups = min(npart, len(members) // per)
    return [tuple(members[i * per:(i + 1) * per]) for i in range(ngroups)]


def slice_partition_leads(nparts: int, world: int):
    """The rank that runs each of ``nparts`` slicing partitions over the
    ranks 0 .. world-1 of a task mesh: the ranks split as
    :func:`slice_submeshes` splits cards (each group one of SLEPc's npart
    subcommunicators), and partition i goes to the lead of group i mod
    the number of groups (:func:`thread_map_submesh`'s rule); rank 0 for
    all of them when there is nothing to split."""
    groups = _split(nparts, list(range(world))) \
        if nparts > 1 and world > 1 else [(0,)]
    return [groups[i % len(groups)][0] for i in range(nparts)]


def thread_map_submesh(fn, items: Sequence, meshes=None,
                       max_workers: Optional[int] = None):
    """:func:`thread_map` with item i run under ``torch.cuda.device`` of
    the lead card of group i mod len(meshes): what ``fn`` allocates on the
    current card lands there, while tensors it is handed stay on their own
    devices.  ``meshes`` None is plain :func:`thread_map`, the reference's
    rule (tasks.py:239-240).  Spectrum slicing does not call it: on one
    card a thread a partition lost to one after another (the threads hand
    the interpreter lock over at every torch call, ROADMAP W7), so its
    partitions run as ranks, by the same rule
    (:func:`slice_partition_leads`)."""
    if not meshes:
        return thread_map(fn, items, max_workers)

    def run(ix_item):
        ix, item = ix_item
        lead = meshes[ix % len(meshes)][0]
        if lead.type != "cuda":
            return fn(item)
        with torch.cuda.device(lead):
            return fn(item)

    return thread_map(run, list(enumerate(items)), max_workers)


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
