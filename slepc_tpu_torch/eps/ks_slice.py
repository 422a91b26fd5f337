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
inertia-balanced partitions.  In one process they run one after another
on the operator's device.  Given a task mesh over several
``torch.distributed`` ranks (``set_partitions(p, mesh=make_task_mesh())``,
``parallel/tasks.py``), the solve is collective over that mesh, as a SLEPc
solve is over its communicator: every rank of it solves the same whole
(not row-partitioned) A and B on the same interval with the same p, the
partitions run concurrently, partition i on the lead rank of group i mod
the number of groups (``slice_partition_leads``, the reference's
``slice_submeshes`` rule), and every rank ends with the whole result
(:func:`_slice_ranks`).  These ranks are SLEPc's npart subcommunicators
(ks-slice.c:341-416); the reference runs a thread a partition on a
device group of its own (``thread_map_submesh``).  On one card a thread
and a CUDA stream a partition lost to one after another, its threads
handing the interpreter lock over at every torch call (ROADMAP W7;
``chip_smoke.py`` phase 8 times both forms and the ranks).  Without a
mesh a solve is the rank's own, whatever the process group.  The search,
each partition and the gather are the events ``Slice_Search``,
``Slice_Partition`` and ``Slice_Gather``.

Every sub-solve confirms a candidate with ||A x - lambda B x|| on the
original pencil, under the caller's convergence test, before it counts
(``set_true_residual``), so ``tol`` bounds every returned pair's true
residual and the errests are that residual.  The reference certifies on
the shift-and-invert estimate alone, which let a pair through at 1.75e-8
with tol 1e-8 (ROADMAP queue 3, F3).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ksp.ksp import KSP
from ..parallel.tasks import slice_partition_leads
from ..st.st import ST, STSinvert
from ..sys.events import log_event
from ..sys.mesh import RowMesh
from ..sys.sort import Which
from .base import EPS, EPSConvergedReason, EPSError


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
        # a candidate counts once ||A x - lam B x|| on the pencil passes
        # the caller's test (the shift-and-invert estimate alone let a
        # pair through at 1.75e-8 with tol 1e-8); errests are that residual
        sub.conv_test = eps.conv_test
        sub.set_true_residual()
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


def _rank_mesh(eps: EPS) -> Optional[RowMesh]:
    """Slicing's mesh when its partitions run as ranks: the task mesh
    handed to ``set_partitions(p, mesh=...)``, over more than one rank.
    Without one a solve is the rank's own (SLEPc's PETSC_COMM_SELF), and
    its partitions run one after another."""
    mesh = eps.slice_mesh
    if mesh is None or mesh.world < 2:
        return None
    for M in (eps.A, eps.B):
        if getattr(M, "mesh", None) is not None \
                or getattr(M, "row_shard", None) is not None:
            raise EPSError("spectrum slicing over a task mesh needs the "
                           "whole operator on every rank, not a "
                           "row-partitioned one")
    return mesh


def _agree(mesh: RowMesh, failed: Optional[BaseException], npart: int,
           parts, census: Tuple[int, int], searched: int) -> None:
    """The first collective of a sliced solve over ranks, before any rank
    takes a branch of its own: one all-reduce (max of v and -v) of a
    fixed-size header (each rank's failure flag, p, the partition count,
    the census, the search's factorizations and a hash of the
    boundaries).  Raises :class:`EPSError` on every rank when the census
    or the boundary search failed on one, or when the ranks differ."""
    digest = hashlib.blake2b(np.asarray(parts, np.float64).tobytes(),
                             digest_size=6).digest()
    flags = torch.zeros(mesh.world, dtype=torch.float64)
    flags[mesh.rank] = failed is not None
    v = torch.cat([flags, torch.tensor(
        [npart, len(parts), *census, searched,
         int.from_bytes(digest, "little")], dtype=torch.float64)])
    both = mesh.allreduce(torch.cat([v, -v]).to(mesh.device), "max").cpu()
    bad = [r for r in range(mesh.world) if both[r] > 0]
    if bad:
        raise EPSError(f"spectrum slicing: the census or the boundary "
                       f"search failed on rank(s) {bad}") from failed
    k = v.numel()
    if not (torch.equal(both[mesh.world:k], v[mesh.world:])
            and torch.equal(-both[k + mesh.world:], v[mesh.world:])):
        raise EPSError("spectrum slicing: the ranks' partitions, census or "
                       "partition boundaries differ; every rank of the "
                       "mesh must solve the same operators on the same "
                       "interval with the same partitions")


def _slice_ranks(eps: EPS, cache: _ShiftFactorCache, parts,
                 mesh: RowMesh):
    """The partitions on the lead ranks of the rank groups, at the same
    time.  Returns, on every rank, every partition's (lams, errs, Xs, 0)
    in partition order, the iterations of all partitions and the
    factorizations of all ranks (the boundary search's once).

    Two collectives after :func:`_agree`: one all-reduce (sum) of each
    rank's failure flag, pair count, iterations and own factorizations,
    so that a failed partition raises :class:`EPSError` on every rank
    before anyone waits at the gather; then one all-gather of the pairs
    (values, errests and eigenvectors as bytes, padded to the largest
    count)."""
    dev, world, rank = mesh.device, mesh.world, mesh.rank
    searched = cache.factorizations
    leads = slice_partition_leads(len(parts), world)
    mine: List[Tuple[int, tuple]] = []
    failed = None
    for i, part in enumerate(parts):
        if leads[i] != rank:
            continue
        try:
            with log_event("Slice_Partition", sync=True):
                mine.append((i, _process_interval(eps, cache, *part)))
        except Exception as err:  # raised on every rank below
            failed = err
            break

    # per rank: failed, pairs, its, own factorizations
    stats = torch.zeros((world, 4), dtype=torch.float64)
    stats[rank] = torch.tensor(
        [failed is not None, sum(len(r[0]) for _, r in mine),
         sum(r[3] for _, r in mine), cache.factorizations - searched],
        dtype=torch.float64)
    per_rank = mesh.allreduce(stats.to(dev)).cpu().to(torch.int64)
    bad = [r for r in range(world) if per_rank[r, 0]]
    if bad:
        raise EPSError(f"spectrum slicing: a partition failed on rank(s) "
                       f"{bad}") from failed
    eps.slice_partition_ranks = leads

    counts = per_rank[:, 1].tolist()
    results = [([], [], [], 0) for _ in parts]
    m = max(counts)
    if m > 0:
        with log_event("Slice_Gather", sync=True):
            _gather(eps, mesh, mine, m, counts, results)
    return (results, int(per_rank[:, 2].sum()),
            searched + int(per_rank[:, 3].sum()))


def _gather(eps: EPS, mesh: RowMesh, mine, m: int, counts, results):
    """One all-gather of every rank's pairs into ``results`` (by
    partition): each rank sends (3, m) float64 of values, errests and
    partition indices, then its (m, n) eigenvectors, both padded to the
    largest count m."""
    dev = mesh.device
    xdt = eps.A.dtype if eps.B is None else \
        torch.promote_types(eps.A.dtype, eps.B.dtype)
    meta = torch.zeros((3, m), dtype=torch.float64)
    X = torch.zeros((m, eps.n), dtype=xdt, device=dev)
    j = 0
    for i, (lams, errs, Xs, _) in mine:
        k = len(lams)
        meta[:, j: j + k] = torch.tensor([lams, errs, [i] * k],
                                         dtype=torch.float64)
        if k:
            X[j: j + k] = torch.stack(Xs).to(xdt)
        j += k
    # the eigenvectors and every rank's bytes start 16-aligned (a
    # complex128 view needs it): meta's 24 m bytes rounded up
    nmeta = -(-meta.numel() * meta.element_size() // 16) * 16
    nx = X.numel() * X.element_size()
    packed = torch.zeros(nmeta + nx + (-(nmeta + nx)) % 16,
                         dtype=torch.uint8, device=dev)
    packed[:meta.numel() * meta.element_size()] = \
        meta.reshape(-1).view(torch.uint8).to(dev)
    packed[nmeta: nmeta + nx] = X.reshape(-1).view(torch.uint8)
    got = mesh.allgather(packed)
    for r in range(mesh.world):
        meta_r = got[r, :3 * m * 8].view(torch.float64).reshape(3, m).cpu()
        X_r = got[r, nmeta: nmeta + nx].view(xdt).reshape(m, eps.n)
        for j in range(counts[r]):
            lams, errs, Xs, _ = results[int(meta_r[2, j])]
            lams.append(float(meta_r[0, j]))
            errs.append(float(meta_r[1, j]))
            Xs.append(X_r[j])


def slice_solve(eps: EPS) -> None:
    """Compute ALL eigenvalues in eps.interval by inertia-certified
    bisection with shift-and-invert Krylov-Schur runs."""
    a, b = eps.interval
    mesh = _rank_mesh(eps)
    cache = _ShiftFactorCache(eps)
    npart = max(1, int(eps.slice_npart or 1))
    ia = ib = 0
    parts: list = []
    failed = None
    eps.slice_partition_ranks = []
    try:
        with log_event("Slice_Search", sync=True):
            ia, ib = cache.inertia(a), cache.inertia(b)
            if ib > ia:
                parts = [(a, b, ib - ia)] if min(npart, ib - ia) == 1 \
                    else _partitions(cache, a, b, ia, ib,
                                     min(npart, ib - ia))
    except Exception as err:
        if mesh is None:
            raise
        failed = err
    if mesh is not None:
        _agree(mesh, failed, npart, parts, (ia, ib), cache.factorizations)
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

    if mesh is None:
        results = []
        for part in parts:
            with log_event("Slice_Partition", sync=True):
                results.append(_process_interval(eps, cache, *part))
        eps.slice_partition_ranks = [0] * len(parts)
        its_total = sum(r[3] for r in results)
        factorizations = cache.factorizations
    else:
        results, its_total, factorizations = _slice_ranks(
            eps, cache, parts, mesh)

    found_lam: List[float] = []
    found_err: List[float] = []
    found_X: List[torch.Tensor] = []
    for lams, errs, Xs, _ in results:
        for lam_i, err_i, x_i in zip(lams, errs, Xs):
            if _is_new(lam_i, found_lam, eps.tol):
                found_lam.append(lam_i)
                found_err.append(err_i)
                found_X.append(x_i)

    order = np.argsort(found_lam)
    eps.its = its_total
    eps.nconv = len(found_lam)
    eps.slice_factorizations = factorizations
    eps.slice_backends = cache.backends()
    eps.eigenvalues = np.asarray(found_lam)[order]
    eps.errests = np.asarray(found_err)[order]
    eps._eigenvectors = torch.stack([found_X[i] for i in order]) \
        if found_X else torch.zeros((0, eps.n), dtype=eps.A.dtype,
                                    device=eps.A.device)
    eps.reason = (EPSConvergedReason.CONVERGED_TOL
                  if eps.nconv >= total else EPSConvergedReason.DIVERGED_ITS)
