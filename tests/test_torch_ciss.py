"""CISS of slepc_tpu_torch (``eps/ciss.py``), its batched shifted solves
(``parallel/tasks.py``) and the contour machinery (``sys/contour.py``)
against slepc_tpu's, on the CPU.

The reference's own cases, on both packages with the same operators and the
same numpy probing block (``default_rng(0)``):
  * tests/test_eps_advanced.py:44-76: the ellipse around the 1-D
    Laplacian's values in (0.49, 0.81) (Rayleigh-Ritz) and a nonsymmetric
    dense matrix of 60 rows (point solves by host LU: ``auto`` picks
    ``factorized`` on the CPU);
  * tests/test_eps_advanced.py:179-192: the block-Hankel extraction;
  * tests/test_round3.py:46-67: the batched solves with adaptive per-point
    tolerances against one fixed-tolerance bucket on laplacian_1d(200).

Held: nconv equal, the same values within 1e-9 (the reference tests hold
them to 1e-7 / 1e-8 of the closed form), the same refinement count.
``ciss_inner_iters`` equal on a diagonally dominant tridiagonal operator
whose point solves take about ten BiCGStab steps.  On the Laplacian's
contour the point solves take hundreds of steps and BiCGStab amplifies
rounding (in either package a 1e-16 change of the right-hand side grows to
1e-8 in five steps), so there the two counts are held within 5% (they
differ by 1% to 2%).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu.parallel import tasks as jtasks
from slepc_tpu.sys import contour as jcontour
from slepc_tpu_torch import interop
from slepc_tpu_torch.parallel import tasks as ttasks
from slepc_tpu_torch.sys import contour as tcontour


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small solves: the test workers share
    the host's cores, and an oversubscribed torch thread pool makes a
    small product a hundred times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(make, configure, **kw):
    out = []
    for pkg in (jst, tst):
        A = make()
        if pkg is tst:
            A = interop.operator_from_slepc_tpu(A, device="cpu")
        eps = pkg.EPS(A, solver="ciss", options=pkg.Options(), **kw)
        configure(eps, pkg)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv and te.its == je.its
    k = te.nconv
    key = lambda v: np.lexsort((np.round(v.imag, 8), np.round(v.real, 8)))
    jl = np.asarray(je.eigenvalues[:k], complex)
    tl = np.asarray(te.eigenvalues[:k], complex)
    np.testing.assert_allclose(tl[key(tl)], jl[key(jl)], rtol=0, atol=1e-9)
    assert te._eigenvectors.shape == (k, A.shape[0])
    return je, te


def _ellipse(c, r, v=1.0, **attrs):
    def configure(eps, pkg):
        eps.set_rg(pkg.RGEllipse(center=c, radius=r, vscale=v))
        for name, val in attrs.items():
            setattr(eps, name, val)
    return configure


@pytest.mark.parametrize("extraction", ["rr", "hankel"])
def test_ciss_ellipse(extraction):
    n = 100
    exact = tst.laplacian_1d_eigs(n)
    inside = np.sort(exact[np.abs(exact - 0.65) < 0.16])
    je, te = _both(lambda: jst.laplacian_1d(n),
                   _ellipse(0.65, 0.16, 0.3, ciss_extraction=extraction),
                   problem_type="hep", tol=1e-9)
    assert te.nconv == len(inside)
    np.testing.assert_allclose(np.sort(te.eigenvalues.real), inside,
                               rtol=1e-7)
    assert not hasattr(te, "ciss_inner_iters")  # factorized on the CPU
    assert max(te.compute_error(i) for i in range(te.nconv)) < 1e-8


def test_ciss_nonsymmetric():
    rng = np.random.default_rng(1)
    n = 60
    Ad = rng.standard_normal((n, n)) / np.sqrt(n)
    w = np.linalg.eigvals(Ad)
    inside = w[np.abs(w - 0.3) < 0.35]
    je, te = _both(lambda: jst.DenseOperator(Ad), _ellipse(0.3, 0.35),
                   problem_type="nhep", tol=1e-8)
    assert te.nconv >= len(inside) - 1
    for lam in te.eigenvalues[: te.nconv]:
        assert np.min(np.abs(w - lam)) < 1e-6


def test_ciss_batched_adaptive_against_fixed():
    """tests/test_round3.py:46 (the inner counts: see the module
    docstring)."""
    n = 200
    exact = tst.laplacian_1d_eigs(n)
    want = exact[(exact > 0.5) & (exact < 0.8)]
    inner = {}
    for adaptive in (True, False):
        je, te = _both(lambda: jst.laplacian_1d(n),
                       _ellipse(0.65, 0.15, 0.4, ciss_solver="batched",
                                ciss_adaptive=adaptive),
                       problem_type="hep", tol=1e-8)
        assert te.nconv == len(want)
        assert np.abs(np.sort(te.eigenvalues.real) - want).max() < 1e-8
        assert abs(te.ciss_inner_iters - je.ciss_inner_iters) \
            <= 0.05 * je.ciss_inner_iters
        assert len(te.ciss_inner_buckets) == (3 if adaptive else 1)
        assert [b["points"] for b in te.ciss_inner_buckets] == \
            [b["points"] for b in je.ciss_inner_buckets]
        np.testing.assert_allclose([b["tol"] for b in te.ciss_inner_buckets],
                                   [b["tol"] for b in je.ciss_inner_buckets],
                                   rtol=1e-12)
        assert te.ciss_point_residuals.shape == (32,)
        inner[adaptive] = te.ciss_inner_iters
    assert inner[True] < 0.95 * inner[False], inner


def _dominant(n=120):
    d = np.linspace(1.0, 10.0, n)
    off = np.full(n, 0.05)
    return jst.DIAOperator((-1, 0, 1), np.stack(
        [np.r_[0.0, off[1:]], d, np.r_[off[:-1], 0.0]]))


@pytest.mark.parametrize("adaptive", [True, False])
def test_ciss_batched_inner_iters_equal(adaptive):
    """A diagonally dominant tridiagonal DIA operator: about ten BiCGStab
    steps a point, the same counts bucket by bucket in both packages."""
    je, te = _both(_dominant, _ellipse(2.5, 0.5, 0.3, ciss_solver="batched",
                                       ciss_adaptive=adaptive),
                   problem_type="hep", tol=1e-9)
    assert te.nconv == je.nconv == 13
    assert te.ciss_inner_iters == je.ciss_inner_iters
    assert te.ciss_inner_buckets == je.ciss_inner_buckets
    np.testing.assert_allclose(te.ciss_point_residuals,
                               je.ciss_point_residuals, rtol=0.5, atol=1e-13)
    assert not hasattr(te, "ciss_refactored_points")


def test_ciss_stalled_points_are_solved_again_by_lu(monkeypatch):
    """A point whose BiCGStab stops at its step limit short of its
    tolerance is solved again by a host LU and listed in
    ciss_refactored_points."""
    import functools

    from slepc_tpu_torch.eps import ciss as tciss

    monkeypatch.setattr(tciss, "batched_shifted_solves_adaptive",
                        functools.partial(
                            ttasks.batched_shifted_solves_adaptive,
                            maxiter=5))
    n = 100
    A = tst.laplacian_1d(n, device="cpu")
    eps = tst.EPS(A, problem_type="hep", solver="ciss", tol=1e-9,
                  options=tst.Options())
    eps.set_rg(tst.RGEllipse(center=0.65, radius=0.16, vscale=0.3))
    eps.ciss_solver = "batched"
    eps.ciss_adaptive = False
    eps.solve()
    assert eps.ciss_inner_iters == 32 * 5
    assert eps.ciss_refactored_points == list(range(32))
    exact = tst.laplacian_1d_eigs(n)
    inside = np.sort(exact[np.abs(exact - 0.65) < 0.16])
    assert eps.nconv == len(inside)
    np.testing.assert_allclose(np.sort(eps.eigenvalues.real), inside,
                               rtol=1e-8)


def test_ciss_task_mesh_solves_as_without_a_mesh(tmp_path):
    """The task mesh over the contour points: on a one-rank gloo group
    here it gives the solve and the batched solves without a mesh; the 2-
    and 4-rank runs are in tests/test_torch_parallel.py."""
    import torch.distributed as dist

    A = tst.laplacian_1d(50, device="cpu")
    rg = tst.RGEllipse(center=0.65, radius=0.16)
    z, _ = rg.contour(8)
    R = np.random.default_rng(0).standard_normal((2, 50))
    runs = []
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        tm = ttasks.make_task_mesh(device="cpu")
        for mesh in (None, tm):
            eps = tst.EPS(A, problem_type="hep", solver="ciss",
                          options=tst.Options())
            eps.ciss_solver = "batched"
            eps.set_rg(rg)
            eps.ciss_task_mesh = mesh
            eps.solve()
            Y = ttasks.batched_shifted_solves(A, None, z, R, mesh=mesh)
            runs.append((eps.nconv, np.sort(eps.eigenvalues.real), Y))
        assert tm.counters["allgather"] == 2
    finally:
        dist.destroy_process_group()
    (n0, lam0, Y0), (n1, lam1, Y1) = runs
    assert n0 == n1 > 0
    np.testing.assert_allclose(lam1, lam0, rtol=1e-12)
    torch.testing.assert_close(Y1, Y0, rtol=0, atol=0)


def test_op_diag_matches_the_reference():
    rng = np.random.default_rng(3)
    M = sp.random(40, 40, density=0.2, random_state=4, format="csr")
    M = (M + sp.identity(40)).tocsr()
    ops = [jst.laplacian_1d(40), jst.DIAOperator((-1, 1), np.ones((2, 40))),
           jst.DenseOperator(rng.standard_normal((40, 40))),
           jst.from_scipy(M)]
    for jop in ops:
        want = np.asarray(jtasks._op_diag(jop, 40))
        got = ttasks._op_diag(interop.operator_from_slepc_tpu(
            jop, device="cpu"), 40).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    shell = tst.ShellOperator((40, 40), torch.float64, lambda x: x,
                              device="cpu")
    assert not ttasks._op_diag(shell, 40).any()


def test_batched_shifted_solves_match_the_reference():
    """All points in one batch (B = None and a diagonal B): both packages'
    solutions within their tolerance of the exact ones."""
    n, L = 60, 4
    rng = np.random.default_rng(5)
    R = rng.standard_normal((n, L))
    z = np.array([2.0 + 1.0j, 3.5 - 0.5j, -1.0 + 0.2j])
    A = _dominant(n)
    Ad = A.to_scipy().toarray()
    for bd in (None, 1.0 + rng.random(n)):
        Bj = None if bd is None else jst.DenseOperator(np.diag(bd))
        Bt = None if bd is None else tst.DenseOperator(np.diag(bd),
                                                       device="cpu")
        Yj = np.asarray(jtasks.batched_shifted_solves(A, Bj, z, R, tol=1e-12))
        Yt = ttasks.batched_shifted_solves(
            interop.operator_from_slepc_tpu(A, device="cpu"), Bt, z,
            torch.from_numpy(R.T.copy()), tol=1e-12)
        assert Yt.shape == (3, L, n) and Yt.dtype == torch.complex128
        Bm = np.eye(n) if bd is None else np.diag(bd)
        for j in range(3):
            exact = np.linalg.solve(z[j] * Bm - Ad, R)
            np.testing.assert_allclose(Yt[j].numpy().T, exact, rtol=0,
                                       atol=1e-10)
            np.testing.assert_allclose(Yt[j].numpy().T, Yj[j], rtol=0,
                                       atol=1e-10)


def test_adaptive_solves_consume_bucket_by_bucket():
    n, L = 60, 3
    rng = np.random.default_rng(6)
    R = torch.from_numpy(rng.standard_normal((L, n)))
    z, _ = tst.RGEllipse(center=5.0, radius=2.0, vscale=0.5).contour(12)
    tols = np.geomspace(1e-12, 1e-6, 12)
    A = interop.operator_from_slepc_tpu(_dominant(n), device="cpu")
    Y, info = ttasks.batched_shifted_solves_adaptive(A, None, z, R,
                                                     tols=tols, nbuckets=3)
    seen = {}
    none, info2 = ttasks.batched_shifted_solves_adaptive(
        A, None, z, R, tols=tols, nbuckets=3,
        consume=lambda idx, Yb: seen.update(zip(idx.tolist(), Yb)))
    assert none is None and info2 == info and sorted(seen) == list(range(12))
    for j, Yj in seen.items():
        assert torch.equal(Yj, Y[j])
    Yr, info_r = jtasks.batched_shifted_solves_adaptive(
        _dominant(n), None, z, R.numpy().T, tols=tols, nbuckets=3)
    assert info_r == info
    np.testing.assert_allclose(Y.numpy().transpose(0, 2, 1), np.asarray(Yr),
                               rtol=0, atol=1e-9)


def test_thread_map_keeps_the_order():
    assert ttasks.thread_map(lambda x: x * x, list(range(20))) == \
        [x * x for x in range(20)]
    assert ttasks.thread_map(abs, [-3]) == [3]


def test_contour_module_matches_the_reference():
    n, L, M = 30, 3, 4
    rng = np.random.default_rng(7)
    A = rng.standard_normal((n, n))
    rhs = rng.standard_normal((n, L))
    z, w = tst.RGEllipse(center=0.5, radius=1.0).contour(8)

    def solve_at(zj, R):
        return np.linalg.solve(zj * np.eye(n) - A, R)

    S_t = tcontour.contour_moments(solve_at, rhs, z, w, M)
    S_j = jcontour.contour_moments(solve_at, rhs, z, w, M)
    np.testing.assert_array_equal(S_t, S_j)
    np.testing.assert_array_equal(tcontour.rank_reveal(S_t),
                                  jcontour.rank_reveal(S_j))
    for a, b in zip(tcontour.hankel_pencil(S_t, L, M),
                    jcontour.hankel_pencil(S_j, L, M)):
        np.testing.assert_array_equal(a, b)
    assert tcontour.rank_reveal(np.zeros((n, 2))).shape == (n, 1)
