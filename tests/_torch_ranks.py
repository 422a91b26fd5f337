"""Cases of the port's row partition, run on gloo ranks on the DEV.

Each ``case_*(mesh)`` runs on every rank of ``mesh`` (a ``RowMesh``) and
returns a dict of numpy-able values (rank 0's is kept); with ``mesh`` None
the same code runs the one-rank port, which the tests hold the partitioned
run against.  Run as a script it is one rank:

    python tests/_torch_ranks.py OUTDIR STORE WORLD RANK case[,case...] \
        [BACKEND DEVICE]

It imports torch and the port only (never JAX), starts ``BACKEND`` (gloo by
default; nccl on cards) from a ``file://`` store, builds every operator on
``DEVICE`` (the DEV by default), runs the cases in order and writes rank
0's results, with the kernel launches each case made, to
OUTDIR/<case>.npz; a failing case writes OUTDIR/error<rank>.txt and exits
1.  ``tests/test_torch_parallel*.py`` spawn the ranks on the DEV with a
timeout, ``tests/test_torch_gpu.py`` on the card.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import scipy.sparse as sp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import slepc_tpu_torch as stt  # noqa: E402
from slepc_tpu_torch.sys import mesh as meshmod  # noqa: E402

DEV = "cpu"  # the cases' device; main() may set a card


def _np(t):
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _counters(mesh):
    return {} if mesh is None else {f"n_{k}": v
                                    for k, v in mesh.counters.items()}


def _rows(op, X):
    """The global block from a partitioned operator's slab rows (all
    ranks), or X itself for a one-rank operator."""
    return op.gather(X) if hasattr(op, "gather") else X


def _solve(mesh, eps):
    """Solve with the mesh installed.  Returns the eigenvectors gathered to
    global rows and the solve's collective counts (before the gather)."""
    meshmod.set_mesh(mesh)
    try:
        eps.solve()
    finally:
        meshmod.set_mesh(None)
    counts = _counters(mesh)
    X = eps._eigenvectors[:eps.nconv]
    if mesh is not None:
        X = mesh.gather_rows(X, eps.n)
    return X, counts


def _resid(A, lam, X):
    out = []
    for i in range(len(lam)):
        r = A.mult(X[i]) - float(lam[i]) * X[i]
        out.append(float(torch.linalg.vector_norm(r)
                         / (abs(lam[i]) * torch.linalg.vector_norm(X[i]))))
    return np.asarray(out)


# ---- operators ---------------------------------------------------------------

def case_spmv_shard(mesh):
    A0 = stt.laplacian_1d(1024, device=DEV)
    A = A0 if mesh is None else stt.shard_operator(A0, mesh)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1024))
    y = A.mult(x.to(DEV))
    out = {"y": _np(y), "form": str(A.shard_form), **_counters(mesh)}
    if mesh is not None:  # the operator handed in is left as it was
        y0 = A0.mult(x.to(DEV))
        out.update(orig_form=str(A0.shard_form),
                   orig_gathers=mesh.counters["allgather"] - out["n_allgather"],
                   orig_equal=bool(torch.equal(y0, y)))
    return out


def _halo(mesh, A):
    return A if mesh is None else stt.HaloDIAOperator.from_dia(A, mesh)


def case_halo_spmv(mesh):
    A = stt.laplacian_2d(40, 40, device=DEV)
    H = _halo(mesh, A)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1600))
    xs = H.local_rows(x) if mesh is not None else x
    if mesh is not None:
        mesh.reset_counters()
    y = H.mult(xs)
    y2 = H.mult(y)
    out = _counters(mesh)
    halos_zero = True if mesh is None else bool(
        (xs[: H.h] == 0).all() and (xs[H.h + H.nloc:] == 0).all()
        and (y[: H.h] == 0).all() and (y[H.h + H.nloc:] == 0).all())
    if mesh is not None:  # the module function on the same slab
        out["fn_equal"] = bool(torch.equal(
            stt.dia_spmv_halo(H.diags, xs, offsets=A.offsets, mesh=mesh), y))
    return {"y": _np(_rows(H, y)), "y2": _np(_rows(H, y2)),
            "halos_zero": halos_zero, **out}


def case_halo_spmm(mesh):
    A = stt.laplacian_2d(40, 40, device=DEV)
    H = _halo(mesh, A)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 1600)))
    Xs = H.local_rows(X) if mesh is not None else X
    if mesh is not None:
        mesh.reset_counters()
    Y = H.mult_block(Xs)
    out = _counters(mesh)
    if mesh is not None:
        out["fn_equal"] = bool(torch.equal(stt.parallel.dia_spmm_halo(
            H.diags, Xs, offsets=A.offsets, mesh=mesh), Y))
    return {"Y": _np(_rows(H, Y)), **out}


def case_halo_numpy(mesh):
    """The array rule on a rank: every product of the partitioned operators
    takes the rank's numpy shard, its slab row(s) or its own rows, and
    answers as it does for the same tensor slab; the gathered products
    against the global operator's."""
    if mesh is None:
        return {}
    from slepc_tpu_torch.parallel import dia_spmm_halo

    rng = np.random.default_rng(3)
    n = 1600
    d = rng.standard_normal((3, n))
    d[0, :40] = d[2, -1] = 0.0  # entries outside the matrix
    A = stt.DIAOperator((-40, 0, 1), d, device=DEV)
    H = stt.HaloDIAOperator.from_dia(A, mesh)
    G = stt.parallel.ShardedGELLPaddedOperator(
        stt.from_scipy(A.to_scipy(), device=DEV), mesh)
    x = rng.standard_normal(n)
    X = rng.standard_normal((3, n))
    lo, hi = H.lo, H.hi

    def slab(op, v):
        return op.local_rows(torch.from_numpy(v)).to(DEV)

    names, errs, kinds = [], [], []
    for name, fn, t_in, np_ins, want in [
            ("mult", H.mult, slab(H, x), [x[lo:hi]], A.mult),
            ("mult_h", H.mult_h, slab(H, x), [x[lo:hi]], A.mult_h),
            ("rmult", H.rmult, slab(H, x), [x[lo:hi]], A.mult_h),
            ("mult_block", H.mult_block, slab(H, X), [X[:, lo:hi]],
             A.mult_block),
            ("dia_spmv_halo", lambda v: stt.dia_spmv_halo(
                H.diags, v, offsets=H.offsets, mesh=mesh), slab(H, x), [],
             A.mult),
            ("dia_spmm_halo", lambda v: dia_spmm_halo(
                H.diags, v, offsets=H.offsets, mesh=mesh), slab(H, X), [],
             A.mult_block),
            ("gell_mult_h", G.mult_h, slab(G, x), [x[lo:hi]], A.mult_h)]:
        y_t = fn(t_in.clone())
        full = x if t_in.dim() == 1 else X
        ref = _np(want(torch.from_numpy(full).to(DEV)))
        got = _np(mesh.gather_rows(y_t[..., H.h: H.h + H.nloc], n)
                  if name != "gell_mult_h" else G.gather(y_t))
        names.append(name + ":tensor")
        errs.append(float(np.abs(got - ref).max()))
        kinds.append(True)
        # the slab row as numpy, and (for the operators) the rank's rows
        for v in [_np(t_in)] + np_ins:
            y = fn(v)
            names.append(f"{name}:numpy{v.shape[-1]}")
            errs.append(float((y - y_t).abs().max()))
            kinds.append(torch.is_tensor(y) and y.device == y_t.device)
    return {"names": np.array(names), "errs": np.array(errs),
            "tensors": np.array(kinds)}


def case_halo_adjoint(mesh):
    """HaloDIAOperator's adjoint apply (``rmult``) and gathered ``to_dense``
    on a non-symmetric DIA operator."""
    rng = np.random.default_rng(2)
    n = 300
    d = rng.standard_normal((3, n))
    A = stt.DIAOperator((-2, 0, 1), d, device=DEV)
    H = _halo(mesh, A)
    x = torch.from_numpy(rng.standard_normal(n))
    xs = H.local_rows(x) if mesh is not None else x
    if mesh is None:
        return {"yh": _np(A.mult_h(x)), "dense": _np(A.to_dense())}
    return {"yh": _np(_rows(H, H.rmult(xs))), "dense": _np(H.to_dense())}


def case_padded_f32(mesh):
    A = stt.laplacian_2d(64, 64, dtype=torch.float32, device=DEV)
    op = A if mesh is None else stt.HaloDIAOperator.from_dia(A, mesh)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    xp = op.local_rows(x) if mesh is not None else x
    if mesh is not None:
        mesh.reset_counters()
    yp = op.mult(xp)
    yp2 = op.mult(yp)
    out = _counters(mesh)
    return {"y": _np(_rows(op, yp)), "y2": _np(_rows(op, yp2)), **out}


def case_ring(mesh):
    """The two-process check: a cross-rank reduction and a boundary
    exchange across the rank boundary."""
    n, h = 1024, 8
    x = torch.arange(n, dtype=torch.float64, device=DEV)
    if mesh is None:
        return {"sumsq": float((x * x).sum())}
    lo, hi = mesh.row_range(n)
    s = mesh.allreduce((x[lo:hi] ** 2).sum().reshape(1))
    slab = torch.zeros(hi - lo + 2 * h, dtype=torch.float64, device=DEV)
    slab[h: h + hi - lo] = x[lo:hi]
    mesh.halo_exchange(slab, h, hi - lo)
    want = torch.zeros_like(slab)
    a, b = max(lo - h, 0), min(hi + h, n)
    want[a - (lo - h): b - (lo - h)] = x[a:b]
    return {"sumsq": float(s[0]), "halo_ok": bool(torch.equal(slab, want)),
            **_counters(mesh)}


def case_tsqr(mesh):
    from slepc_tpu_torch.bv.orthog import tsqr

    X = np.random.default_rng(0).standard_normal((512, 12))
    Xr = torch.from_numpy(np.ascontiguousarray(X.T)).to(DEV)
    if mesh is None:
        Q, R = tsqr(Xr)
        return {"Q": _np(Q), "R": R}
    lo, hi = mesh.row_range(512)
    mesh.reset_counters()
    Q, R = tsqr(Xr[:, lo:hi].contiguous(), mesh)
    out = _counters(mesh)
    return {"Q": _np(mesh.gather_rows(Q, 512)), "R": R, **out}


def case_bv_tsqr(mesh):
    """BV's TSQR block type inside a partitioned solve's reductions."""
    from slepc_tpu_torch.bv.bv import BV, OrthogBlockType

    X = np.random.default_rng(2).standard_normal((8, 600))
    A = stt.laplacian_1d(600, device=DEV)
    H = _halo(mesh, A)
    rows = H.local_rows(torch.from_numpy(X)) if mesh is not None \
        else torch.from_numpy(X)
    bv = BV(rows.shape[1], 8, array=rows.clone())
    with meshmod.reducing(H):
        R = bv.orthogonalize(OrthogBlockType.TSQR)
    return {"Q": _np(_rows(H, bv.array)), "R": R}


def case_task_ciss(mesh):
    from slepc_tpu_torch.parallel.tasks import (batched_shifted_solves,
                                                make_task_mesh)

    n = 120
    A = stt.laplacian_1d(n, device=DEV)
    V = np.random.default_rng(0).standard_normal((n, 4))
    rg = stt.RGEllipse(center=0.65, radius=0.16, vscale=0.3)
    z, _ = rg.contour(16)
    tm = None if mesh is None else make_task_mesh(device=DEV)
    if tm is not None:
        tm.reset_counters()
    Y = batched_shifted_solves(A, None, z, V.T, tol=1e-12, mesh=tm)
    out = _counters(tm)
    eps = stt.EPS(A, problem_type="hep", solver="ciss", tol=1e-9,
                  options=stt.Options())
    eps.ciss_solver = "batched"
    eps.ciss_task_mesh = tm
    eps.set_rg(rg)
    eps.solve()
    return {"Y0": _np(Y[0]), "Y7": _np(Y[7]), "npt": int(Y.shape[0]),
            "nconv": eps.nconv, "lam": np.sort(eps.eigenvalues.real), **out}


def case_markov_nhep(mesh):
    A = stt.markov(15, device=DEV)
    if mesh is not None:
        A = stt.shard_operator(A, mesh)
        mesh.reset_counters()
    eps = stt.EPS(A, problem_type="nhep", which="largest_magnitude", nev=3,
                  options=stt.Options())
    eps.solve()
    return {"nconv": eps.nconv, "lam": eps.eigenvalues[:3],
            "form": str(A.shard_form), **_counters(mesh)}


def case_svd_shard(mesh):
    As = sp.random(512, 256, density=0.02,
                   random_state=np.random.default_rng(1), format="csr")
    A = stt.from_scipy(As, device=DEV)
    if mesh is not None:
        A = stt.shard_operator(A, mesh)
        mesh.reset_counters()
    svd = stt.SVD(A, nsv=3, solver="trlanczos")
    svd.solve()
    return {"sigma": np.asarray(svd.sigma[:3]), "form": str(A.shard_form),
            "form_h": str(A.shard_form_h), **_counters(mesh)}


def case_svd_dense(mesh):
    """tests/test_modules.py's 120 x 80 SVD, a dense matrix's rows through
    shard_operator."""
    Ad = np.random.default_rng(0).standard_normal((120, 80)) / np.sqrt(120)
    A = stt.DenseOperator(Ad, device=DEV)
    if mesh is not None:
        A = stt.shard_operator(A, mesh)
        mesh.reset_counters()
    svd = stt.SVD(A, nsv=5, solver="trlanczos")
    svd.solve()
    return {"sigma": np.asarray(svd.sigma[:5]), "nconv": svd.nconv,
            "form": str(A.shard_form), "form_h": str(A.shard_form_h),
            **_counters(mesh)}


def case_slice_submeshes(mesh):
    from slepc_tpu_torch.parallel.tasks import (slice_submeshes,
                                                thread_map_submesh)

    devs = [f"cuda:{i}" for i in range(8)]
    groups = slice_submeshes(4, devices=devs)
    g9 = slice_submeshes(9, devices=devs)
    cpu_groups = slice_submeshes(2, devices=[DEV] * 4)
    out = thread_map_submesh(lambda v: v * 2, [1, 2, 3, 4, 5], cpu_groups)
    return {"groups": np.asarray([[d.index for d in g] for g in groups]),
            "n9": len(g9), "one": slice_submeshes(1, devices=devs) is None,
            "few": slice_submeshes(4, devices=devs[:1]) is None,
            "mapped": np.asarray(out)}


# ---- the Krylov-Schur fast path ------------------------------------------------

def case_ks_cycle(mesh):
    from slepc_tpu_torch.eps.ks_jit import ks_hep_cycle

    A = stt.laplacian_2d(32, 30, device=DEV)
    H = _halo(mesh, A)
    n, ncv = 960, 24
    v0 = np.random.default_rng(0).standard_normal(n)
    v0 /= np.linalg.norm(v0)
    V = torch.zeros((ncv + 1, H.shape[0]), dtype=torch.float64, device=DEV)
    V[0] = H.local_rows(torch.from_numpy(v0)) if mesh is not None \
        else torch.from_numpy(v0).to(DEV)
    Hm = np.zeros((ncv + 1, ncv))
    gen = torch.Generator(device=DEV).manual_seed(0)
    j0, k2, cycles, first = 0, 0, 0, None
    if mesh is not None:
        mesh.reset_counters()
    for _ in range(60):
        V, Hm, j0, k2, theta, errest, beta = ks_hep_cycle(
            H, V, Hm, j0, 1e-10, gen, ncv=ncv, which="largest")
        cycles += 1
        if first is None and mesh is not None:
            first = dict(mesh.counters)
        if k2 >= 4:
            break
    out = {"theta": theta[:4], "cycles": cycles}
    if mesh is not None:
        out.update({"first_allreduce": first["allreduce"],
                    "first_allgather": first["allgather"],
                    "first_halo": first["halo"], "ncv": ncv})
    return out


def _eps_smallest(mesh, A, **kw):
    eps = stt.EPS(A, problem_type="hep", which="smallest_real",
                  options=stt.Options(), **kw)
    return eps


def case_eps_f64(mesh):
    """The reference's sharded fast-path case: the smallest end of
    laplacian_1d(128), nev 4, ncv 48."""
    A = stt.laplacian_1d(128, device=DEV)
    eps = _eps_smallest(mesh, A, nev=4, ncv=48, max_it=400)
    X, counts = _solve(mesh, eps)
    lam = np.asarray(eps.eigenvalues[:eps.nconv])
    return {"nconv": eps.nconv, "lam": lam, "its": eps.its,
            "resid": _resid(A, lam, X), **counts}


def case_eps_f32(mesh):
    """The reference's sharded Pallas fast-path case in f32."""
    A = stt.laplacian_2d(64, 64, dtype=torch.float32, device=DEV)
    eps = _eps_smallest(mesh, A, nev=4, ncv=32, max_it=300, tol=1e-5)
    counts = _solve(mesh, eps)[1]
    return {"nconv": eps.nconv, "lam": np.asarray(eps.eigenvalues[:4]),
            **counts}


def c128_diags(n=300):
    """A complex Hermitian tridiagonal with a spread top end: -0.3i, the
    diagonal 2 + 6 (i/n)^8, +0.3i."""
    main = 2.0 + 6.0 * np.linspace(0.0, 1.0, n) ** 8
    return np.stack([np.full(n, 0.3j), main.astype(complex),
                     np.full(n, -0.3j)])


def case_eps_c128(mesh):
    """A complex Hermitian DIA operator on the partition (K2c on the
    slab, complex all-reduces)."""
    A = stt.DIAOperator((-1, 0, 1), c128_diags(), device=DEV)
    eps = stt.EPS(A, problem_type="hep", which="largest_real", nev=4,
                  options=stt.Options())
    X, counts = _solve(mesh, eps)
    lam = np.asarray(eps.eigenvalues[:eps.nconv])
    return {"nconv": eps.nconv, "lam": lam, "resid": _resid(A, lam, X),
            **counts}


def case_cheb(mesh):
    """The Chebyshev driver (ks_cheb_smallest through EPS)."""
    A = stt.laplacian_3d(10, 11, 12, device=DEV)
    eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=6,
                  tol=1e-8, options=stt.Options.from_cli(
                      "-eps_ncv 24 -eps_cheb_degree 40"))
    X, counts = _solve(mesh, eps)
    lam = np.asarray(eps.eigenvalues[:eps.nconv])
    return {"nconv": eps.nconv, "lam": lam, "resid": _resid(A, lam, X),
            "cycles": eps.cheb_stats["cycles"], **counts}


def case_cheb_blocked(mesh):
    """The blocked filtered cycle (cheb_block 4: K5 on the slab, one block
    exchange a step)."""
    A = stt.laplacian_3d(10, 11, 12, device=DEV)
    eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=6,
                  tol=1e-8, options=stt.Options.from_cli(
                      "-eps_ncv 24 -eps_cheb_degree 40"))
    eps.cheb_block = 4
    X, counts = _solve(mesh, eps)
    lam = np.asarray(eps.eigenvalues[:eps.nconv])
    return {"nconv": eps.nconv, "lam": lam, "resid": _resid(A, lam, X),
            **counts}


def case_blocked(mesh):
    """The blocked cycle (block_size 4) of the fast path."""
    A = stt.laplacian_2d(30, 29, device=DEV)
    eps = _eps_smallest(mesh, A, nev=4, ncv=40, max_it=2000)
    eps.block_size = 4
    X, counts = _solve(mesh, eps)
    lam = np.asarray(eps.eigenvalues[:eps.nconv])
    return {"nconv": eps.nconv, "lam": lam, "resid": _resid(A, lam, X),
            **counts}


def case_partial(mesh):
    """Partial reorthogonalization on the mesh (its dots go through the
    same reductions)."""
    A = stt.laplacian_1d(128, device=DEV)
    eps = _eps_smallest(mesh, A, nev=4, ncv=48, max_it=400)
    eps.set_reorthogonalization("partial")
    X, counts = _solve(mesh, eps)
    lam = np.asarray(eps.eigenvalues[:eps.nconv])
    return {"nconv": eps.nconv, "lam": lam, "resid": _resid(A, lam, X)}


def case_fallback(mesh):
    """A DIA operator whose reach passes the nearest neighbour (a periodic
    wrap, offsets +-(n - 1)): the fast path runs the solve on
    shard_operator's form and leaves the operator handed in as it was."""
    n = 64
    d = np.zeros((5, n))
    d[0, n - 1] = d[4, 0] = -1.0          # A[n-1, 0] and A[0, n-1]
    d[1, 1:] = d[3, :-1] = -1.0
    d[2] = 2.0 + 6.0 * np.linspace(0.0, 1.0, n) ** 8
    A = stt.DIAOperator((1 - n, -1, 0, 1, n - 1), d, device=DEV)
    eps = stt.EPS(A, problem_type="hep", which="largest_real", nev=4,
                  options=stt.Options())
    X, counts = _solve(mesh, eps)
    lam = np.asarray(eps.eigenvalues[:eps.nconv])
    out = {"nconv": eps.nconv, "lam": lam, "resid": _resid(A, lam, X),
           **counts}
    if mesh is not None:
        before = mesh.counters["allgather"]
        y = A.mult(torch.ones(n, dtype=torch.float64, device=DEV))
        out.update(untouched=A.row_shard is None and A.shard_form is None,
                   after_gathers=mesh.counters["allgather"] - before,
                   y_after=_np(y))
    return out


def rcm_laplacian(nx, ny):
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    L = stt.laplacian_2d(nx, ny, device=DEV).to_scipy().tocsr()
    rng = np.random.default_rng(3)
    P = rng.permutation(L.shape[0])
    L = L[P][:, P].tocsr()
    perm = reverse_cuthill_mckee(L, symmetric_mode=True)
    return L[perm][:, perm].tocsr()


def case_csr_rcm(mesh):
    """The partitioned CSR form (K6 on the slab) on an RCM-ordered
    laplacian_2d(64, 64)."""
    A = stt.from_scipy(rcm_laplacian(64, 64), device=DEV)
    eps = _eps_smallest(mesh, A, nev=4, ncv=32, max_it=600, tol=1e-8)
    X, counts = _solve(mesh, eps)
    lam = np.asarray(eps.eigenvalues[:eps.nconv])
    return {"nconv": eps.nconv, "lam": lam, "resid": _resid(A, lam, X),
            **counts}


# ---- spectrum slicing's partitions as ranks -----------------------------------

def host_ldl_pencil(nx=10, ny=7):
    """tests/test_torch_slice.py's generalized pencil: a permuted 2-D
    Laplacian (CSR: the host native LDL^T) and a diagonal B."""
    n = nx * ny
    bd = 1.0 + 0.3 * np.cos(np.arange(n) * 0.2)
    perm = np.random.default_rng(0).permutation(n)
    As = stt.laplacian_2d(nx, ny, device="cpu").to_scipy().tocsr()
    return As[perm][:, perm].tocsr(), bd


def gauge(offsets, diags, seed=11):
    """U A U^H for U = diag(exp(2 pi i u)), u from default_rng(seed)
    (tests/test_torch_inertia.py's): the same offsets and spectrum,
    complex Hermitian when A is symmetric."""
    d = np.asarray(diags).astype(np.complex128)
    n = d.shape[1]
    phi = 2 * np.pi * np.random.default_rng(seed).random(n)
    for k, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, n - o)
        d[k, lo:hi] *= np.exp(1j * (phi[lo:hi] - phi[lo + o:hi + o]))
    return d


def _gauged(L):
    return stt.DIAOperator(L.offsets, gauge(tuple(L.offsets),
                                            L.diags.cpu().numpy()),
                           device=DEV)


def slice_problem(name):
    """(operators on DEV, interval, problem type) of a slicing case."""
    if name == "tri":
        return [stt.laplacian_1d(400, device=DEV)], (0.5, 0.9), "hep"
    if name == "empty":
        return [stt.laplacian_1d(50, device=DEV)], (4.5, 5.0), "hep"
    if name == "grid":  # block-tridiagonal LDL^T
        return [stt.laplacian_2d(12, 9, device=DEV)], (1.0, 2.0), "hep"
    # tests/test_torch_inertia.py's complex Hermitian cases: a banded
    # LDL^H and the complex tridiagonal count
    if name == "cgrid":
        return [_gauged(stt.laplacian_2d(12, 9, device="cpu"))], \
            (1.0, 2.0), "hep"
    if name == "c1d":
        return [_gauged(stt.laplacian_1d(300, device="cpu"))], \
            (0.5, 0.9), "hep"
    As, bd = host_ldl_pencil()
    return ([stt.from_scipy(As, device=DEV),
             stt.DIAOperator((0,), bd[None, :], device=DEV)], (0.8, 1.7),
            "ghep")


def _ranks_differ(mesh, t):
    """The largest difference of ``t`` on any rank from rank 0's."""
    if mesh is None:
        return 0.0
    got = mesh.allgather(t.to(mesh.device))
    return float((got - got[0]).abs().max()) if got.numel() else 0.0


def run_slice(mesh, problem, npart, interval=None, own=False):
    """Slice ``problem`` with ``npart`` partitions: as ranks over a task
    mesh of every rank when ``mesh`` is given, else (or with ``own``, each
    rank's solve its own) one after another.  ``interval`` replaces the
    problem's."""
    from slepc_tpu_torch.parallel import make_task_mesh
    from slepc_tpu_torch.sys.events import get_event

    ops, default, pt = slice_problem(problem)
    eps = stt.EPS(*ops, problem_type=pt, options=stt.Options())
    eps.set_interval(*(interval or default))
    smesh = None if mesh is None or own else make_task_mesh(device=DEV)
    eps.set_partitions(npart, mesh=smesh)
    stt.log_begin()
    eps.solve()
    ev = {k: get_event("Slice_" + k) or {"count": 0, "time": 0.0}
          for k in ("Search", "Partition", "Gather")}
    X = eps._eigenvectors[:eps.nconv]
    lam = np.asarray(eps.eigenvalues, dtype=float)
    # read before _ranks_differ adds its own all-gathers
    counters = {} if smesh is None else \
        {f"s_{k}": v for k, v in smesh.counters.items()}
    return {"nconv": eps.nconv, "n": eps.n, "lam": lam, "its": eps.its,
            "facts": eps.slice_factorizations, "reason": eps.reason.name,
            "backends": ",".join(eps.slice_backends),
            "resid": np.asarray([eps.compute_error(i)
                                 for i in range(eps.nconv)]),
            "errests": np.asarray(eps.errests, dtype=float),
            "leads": np.asarray(eps.slice_partition_ranks),
            "ranks": eps.slice_mesh is not None,
            **{f"ev_{k}_{f}": e[f] for k, e in ev.items()
               for f in ("count", "time")},
            "dlam": _ranks_differ(smesh, torch.from_numpy(lam)),
            "dX": _ranks_differ(smesh, X),
            **counters}


def _slice_case(problem, npart):
    return lambda mesh: run_slice(mesh, problem, npart)


for _pb in ("tri", "ldl"):
    for _p in (2, 3):
        globals()[f"case_slice_{_pb}_p{_p}"] = _slice_case(_pb, _p)
case_slice_grid_p2 = _slice_case("grid", 2)
case_slice_cgrid_p2 = _slice_case("cgrid", 2)
case_slice_c1d_p3 = _slice_case("c1d", 3)
case_slice_empty = _slice_case("empty", 2)


def case_slice_own(mesh):
    """No task mesh under a process group of two: each rank slices an
    interval of its own (SLEPc's PETSC_COMM_SELF), one partition after
    another, with no collective.  Rank 0 returns its result and every
    rank's count."""
    lo, hi = ((0.5, 0.7), (0.7, 0.9))[mesh.rank]
    r = run_slice(mesh, "tri", 2, interval=(lo, hi), own=True)
    counts = mesh.allgather(torch.tensor([r["nconv"]],
                                         device=mesh.device))
    r["counts"] = _np(counts).ravel()
    return r


def _raises_on_every_rank(mesh, patch, run, want):
    """``run()`` with ``eps/ks_slice.py``'s function ``patch`` raising on
    rank 1: every rank must raise EPSError with ``want`` in its message
    (no rank left waiting at a collective)."""
    from slepc_tpu_torch.eps import ks_slice

    def boom(*args):
        raise RuntimeError(f"{patch} failed")

    keep = getattr(ks_slice, patch) if patch else None
    if patch and mesh.rank == 1:
        setattr(ks_slice, patch, boom)
    try:
        run()
    except stt.EPSError as err:
        assert want in str(err), str(err)
        return {"raised": True, "msg": str(err)}
    finally:
        if patch:
            setattr(ks_slice, patch, keep)
    raise AssertionError(f"no EPSError on rank {mesh.rank}")


def case_slice_fail(mesh):
    """Rank 1's partition raises."""
    return _raises_on_every_rank(
        mesh, "_process_interval", lambda: run_slice(mesh, "tri", 2),
        "a partition failed on rank(s) [1]")


def case_slice_search_fail(mesh):
    """Rank 1's boundary search raises, before any partition."""
    return _raises_on_every_rank(
        mesh, "_partitions", lambda: run_slice(mesh, "tri", 2),
        "boundary search failed on rank(s) [1]")


def case_slice_differ(mesh):
    """Rank 1 slices another interval over the same task mesh."""
    interval = ((0.5, 0.9), (0.5, 0.85))[mesh.rank]
    return _raises_on_every_rank(
        mesh, None, lambda: run_slice(mesh, "tri", 2, interval=interval),
        "differ")


def spawn(tmp, world: int, cases, timeout: float = 120.0,
          backend: str = "gloo", device: str = "cpu"):
    """Run ``cases`` on ``world`` gloo ranks (this file as a script, in
    ``tmp``); returns rank 0's results by case.  A rank that fails, or
    ranks that outlive ``timeout``, raise AssertionError; every rank is
    killed before this returns."""
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks talk on loopback
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp),
         str(tmp / "store"), str(world), str(r), ",".join(cases), backend,
         device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{world} ranks outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errors = "".join(f.read_text() for f in tmp.glob("error*.txt"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{errors}\n{out[-3000:]}"
    return {c: dict(np.load(tmp / f"{c}.npz")) for c in cases}


def run_case(name, mesh):
    torch.manual_seed(0)
    return globals()["case_" + name](mesh)


def main(argv):
    import datetime

    import torch.distributed as dist

    global DEV
    out, store, world, rank = argv[1], argv[2], int(argv[3]), int(argv[4])
    cases = argv[5].split(",")
    backend, DEV = (argv[6], argv[7]) if len(argv) > 7 else ("gloo", "cpu")
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    mesh = stt.make_row_mesh(device=DEV)
    try:
        for name in cases:
            mesh.reset_counters()
            before = stt.launch_counts()
            res = run_case(name, mesh)
            res.update({"k_" + k: v - before[k]
                        for k, v in stt.launch_counts().items()})
            if rank == 0:
                np.savez(os.path.join(out, name + ".npz"), **res)
    except Exception:
        with open(os.path.join(out, f"error{rank}.txt"), "w") as f:
            f.write(f"case {name}:\n{traceback.format_exc()}")
        sys.stdout.flush()
        os._exit(1)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
