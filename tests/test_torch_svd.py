"""The SVD module of slepc_tpu_torch (``svd/``, ``ds/types.py`` DSSVD,
DSHSVD, DSGSVD) against slepc_tpu's, on the CPU.

Each reference case has a twin here, both packages fed the same numpy
matrices (the port's SVD built from the reference's settings by
``interop.svd_from_slepc_tpu``):
  * tests/test_modules.py:21-61: the five solvers on a 120 x 80 matrix
    (the randomized one with spectral decay), the smallest singular values
    by ``cross``, ``trlanczos`` on a sparse 300 x 200 CSR matrix;
  * tests/test_modules_advanced.py:80-112, 180-209: the GSVD by joint
    bidiagonalization (``trlanczos``) and by the cross pencil (``cross``),
    the JBD's smallest values and its ill-conditioned pair, the hyperbolic
    SVD with its signature;
  * tests/test_reference_golden.py:56-75: the Grcar singular values to four
    decimals;
  * tests/test_round2.py:323-331: the ``-svd_*`` options;
  * tests/test_classes.py:228: DSSVD (and DSHSVD, DSGSVD).
Besides: the discrete gradient of a 6 x 7 x 8 grid (G^T G is
``laplacian_3d``, so sigma = sqrt(laplacian_3d_eigs)), its complex128 twin
with phases on the edges, and a float32 run.

Tolerances: singular values within 1e-10 relative of the reference in f64
and c128 (both walk the same steps: rounding of a few hundred operations on
~1e2-row vectors), 1e-5 in f32; vectors equal up to a unit phase (1 -
|<x_ref, x>| <= 1e-8; the randomized sketch's 1e-6); ``its`` equal.
"""

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu.mat.linop import AIJOperator as JAIJ
from slepc_tpu_torch import interop


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small solves: the test workers share
    the host's cores, and an oversubscribed torch thread pool makes a
    small product a hundred times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches keep the AIJ operators a module ran and
    raise when the process later runs another of the same shape (this
    module's 300 x 200 case is tests/test_modules.py's own): drop them
    when the module starts and when it ends."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def grcar():
    """The n = 30 Grcar matrix as one slepc_tpu AIJ operator for both
    cases (the reference's jit cache raises when it meets a second CSR
    operator of the same shape)."""
    n = 30
    G = sp.diags([-np.ones(n - 1), np.ones(n), np.ones(n - 1),
                  np.ones(n - 2), np.ones(n - 3)], [-1, 0, 1, 2, 3],
                 format="csr")
    return JAIJ.from_scipy(G.astype(np.float64))


def _rect_test_matrix(m=120, n=80, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)) / np.sqrt(m)


def _both(A, **kw):
    """The reference's SVD of the slepc_tpu operator A (and B) and the
    port's, built from the same settings, both solved."""
    j = jst.SVD(A, **kw)
    t = interop.svd_from_slepc_tpu(j, device="cpu")
    j.solve()
    t.solve()
    return j, t


def _same_vectors(X_ref, X, k, tol=1e-8):
    """The first k columns agree up to a unit phase."""
    for i in range(k):
        a, b = X_ref[:, i], X[:, i]
        c = abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert 1.0 - c <= tol, (i, 1.0 - c)


def _held(j, t, k, rtol=1e-10, vtol=1e-8, its=True):
    assert t.nconv == j.nconv >= k
    np.testing.assert_allclose(t.sigma[:k], np.asarray(j.sigma)[:k],
                               rtol=rtol, atol=0)
    _same_vectors(np.asarray(j.U), t.U, k, vtol)
    _same_vectors(np.asarray(j.V), t.V, k, vtol)
    if its:
        assert t.its == j.its


@pytest.mark.parametrize("solver", ["cross", "cyclic", "trlanczos",
                                    "randomized", "lapack"])
def test_svd_largest(solver):
    Ad = _rect_test_matrix()
    if solver == "randomized":
        U0, s0, V0h = np.linalg.svd(Ad, full_matrices=False)
        Ad = (U0 * (s0 * np.exp(-0.15 * np.arange(len(s0))))) @ V0h
    j, t = _both(jst.DenseOperator(Ad), nsv=5, solver=solver)
    _held(j, t, 5, vtol=1e-6 if solver == "randomized" else 1e-8)
    s_ref = np.linalg.svd(Ad, compute_uv=False)
    rtol, errtol = (2e-2, 5e-2) if solver == "randomized" else (1e-6, 1e-5)
    np.testing.assert_allclose(t.sigma[:5], s_ref[:5], rtol=rtol)
    for i in range(5):
        assert abs(t.compute_error(i) - j.compute_error(i)) <= 1e-9
        assert t.compute_error(i) < errtol


def test_svd_smallest():
    Ad = _rect_test_matrix(60, 50, seed=1)
    j, t = _both(jst.DenseOperator(Ad), nsv=3, which="smallest",
                 solver="cross")
    _held(j, t, 3)
    s_ref = np.sort(np.linalg.svd(Ad, compute_uv=False))
    np.testing.assert_allclose(np.sort(t.sigma[:3]), s_ref[:3], rtol=1e-5)


def test_svd_sparse_lanczos():
    rng = np.random.default_rng(4)
    As = sp.random(300, 200, density=0.02, random_state=rng, format="csr")
    j, t = _both(jst.from_scipy(As), nsv=4, solver="trlanczos")
    assert isinstance(t.A, tst.AIJOperator)
    _held(j, t, 4)
    np.testing.assert_allclose(
        t.sigma[:4], np.linalg.svd(As.toarray(), compute_uv=False)[:4],
        rtol=1e-6)


@pytest.mark.parametrize("solver", ["trlanczos", "cross"])
def test_svd_gsvd(solver):
    """trlanczos: the joint bidiagonalization; cross: the cross pencil
    through EPS GHEP."""
    rng = np.random.default_rng(0)
    m, p, n = 50, 40, 30
    Ad = rng.standard_normal((m, n))
    Bd = rng.standard_normal((p, n))
    lam = sla.eigh(Ad.T @ Ad, Bd.T @ Bd, eigvals_only=True)
    sig_ref = np.sqrt(np.sort(lam)[::-1])
    j, t = _both(jst.DenseOperator(Ad), B=jst.DenseOperator(Bd), nsv=3,
                 solver=solver)
    _held(j, t, 3)
    _same_vectors(np.asarray(j.X), t.X, 3)
    np.testing.assert_allclose(t.sigma[:3], sig_ref[:3], rtol=1e-6)
    for i in range(3):
        x = t.X[:, i]
        r = Ad.T @ (Ad @ x) - t.sigma[i] ** 2 * (Bd.T @ (Bd @ x))
        assert np.linalg.norm(r) / np.linalg.norm(x) < 1e-6


def test_svd_hsvd():
    rng = np.random.default_rng(0)
    m, n = 40, 25
    Ad = rng.standard_normal((m, n))
    om = np.sign(rng.standard_normal(m))
    om[0] = 1
    M = Ad.T @ (om[:, None] * Ad)
    sig_ref = np.sqrt(np.sort(np.abs(np.linalg.eigvalsh(0.5 * (M + M.T))))
                      [::-1])
    j, t = _both(jst.DenseOperator(Ad), omega=om, nsv=3)
    _held(j, t, 3)
    np.testing.assert_array_equal(t.sign[:3], np.asarray(j.sign)[:3])
    np.testing.assert_allclose(t.sigma[:3], sig_ref[:3], rtol=1e-6)
    G = t.U[:, :3].T @ (om[:, None] * t.U[:, :3])
    np.testing.assert_allclose(np.diag(G), t.sign[:3], atol=1e-6)


def test_svd_gsvd_jbd_smallest_and_conditioning():
    rng = np.random.default_rng(3)
    m, p, n = 60, 50, 35
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    Vt, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Ad = U @ np.diag(np.logspace(0, -5, n)) @ Vt.T
    Bd = rng.standard_normal((p, n))
    lam = sla.eigh(Ad.T @ Ad, Bd.T @ Bd, eigvals_only=True)
    sig_ref = np.sqrt(np.maximum(np.sort(lam)[::-1], 0))
    j, t = _both(jst.DenseOperator(Ad), B=jst.DenseOperator(Bd), nsv=3,
                 ncv=20)
    _held(j, t, 3)
    np.testing.assert_allclose(t.sigma[:3], sig_ref[:3], rtol=1e-5)
    A2 = rng.standard_normal((m, n))
    lam2 = sla.eigh(A2.T @ A2, Bd.T @ Bd, eigvals_only=True)
    j, t = _both(jst.DenseOperator(A2), B=jst.DenseOperator(Bd), nsv=2,
                 ncv=20, which="smallest", max_it=80)
    _held(j, t, 2)
    np.testing.assert_allclose(np.sort(t.sigma[:2]),
                               np.sqrt(np.maximum(np.sort(lam2), 0))[:2],
                               rtol=1e-5)


@pytest.mark.parametrize("which,digits", [("largest", "3.2215"),
                                          ("smallest", "0.9551")])
def test_svd_grcar_reference_test1_digits(grcar, which, digits):
    j, t = _both(grcar, nsv=1, which=which)
    _held(j, t, 1)
    assert f"{float(t.sigma[0]):.4f}" == digits


def test_module_options_surface():
    try:
        tst.set_global_options("-svd_nsv 3 -svd_type cross -svd_ncv 17 "
                               "-svd_tol 1e-9 -svd_max_it 55")
        svd = tst.SVD(tst.laplacian_1d(32, device="cpu"))
        assert (svd.nsv, svd.solver, svd.ncv, svd.tol, svd.max_it) == \
            (3, "cross", 17, 1e-9, 55)
        svd.solve()
        assert svd.nconv >= 3
        np.testing.assert_allclose(
            svd.sigma[:3],
            tst.laplacian_1d_eigs(32)[::-1][:3], rtol=1e-8)
    finally:
        tst.set_global_options({})


def test_ds_svd_types():
    rng = np.random.default_rng(12)
    Bm = rng.standard_normal((9, 6))
    U, s, Vh = tst.DSSVD().solve(Bm)
    np.testing.assert_allclose(U @ np.diag(s) @ Vh, Bm, atol=1e-12)
    for got, ref in zip(tst.DSSVD().solve_bidiag(np.arange(1.0, 5.0),
                                                 np.ones(3)),
                        jst.DSSVD().solve_bidiag(np.arange(1.0, 5.0),
                                                 np.ones(3))):
        np.testing.assert_array_equal(got, ref)
    om = np.sign(rng.standard_normal(9))
    om[0] = 1
    for got, ref in zip(tst.DSHSVD().solve(Bm, om),
                        jst.DSHSVD().solve(Bm, om)):
        np.testing.assert_array_equal(got, ref)
    Cm = rng.standard_normal((7, 6))
    for got, ref in zip(tst.DSGSVD().solve(Bm, Cm),
                        jst.DSGSVD().solve(Bm, Cm)):
        np.testing.assert_array_equal(got, ref)


def gradient_3d(nx, ny, nz, phases=None):
    """G = [I (x) I (x) D_x; I (x) D_y (x) I; D_z (x) I (x) I] of an
    nx x ny x nz grid with Dirichlet boundary edges, unknowns x fastest (as
    laplacian_3d orders them); D_d is the (n_d + 1) x n_d difference
    matrix.  ``phases`` (one per unknown): G U^H with U = diag(e^{i phi}),
    so G^H G = U L U^H, the gauge-transformed Laplacian."""
    def D(k):
        return sp.diags([np.ones(k), -np.ones(k)], [0, -1], shape=(k + 1, k))

    def eye(k):
        return sp.identity(k, format="csr")

    G = sp.vstack([sp.kron(eye(nz), sp.kron(eye(ny), D(nx))),
                   sp.kron(eye(nz), sp.kron(D(ny), eye(nx))),
                   sp.kron(D(nz), sp.kron(eye(ny), eye(nx)))]).tocsr()
    if phases is not None:
        G = (G @ sp.diags(np.exp(-1j * phases))).tocsr()
    return G


@pytest.mark.parametrize("solver", ["trlanczos", "cross"])
def test_gradient_against_the_closed_form(solver):
    nx, ny, nz = 6, 7, 8
    G = gradient_3d(nx, ny, nz)
    L = tst.laplacian_3d(nx, ny, nz, device="cpu").to_scipy()
    assert abs(G.T @ G - L).max() == 0  # G^T G is the 7-point Laplacian
    j, t = _both(jst.from_scipy(G), nsv=6, ncv=24, tol=1e-10, solver=solver)
    _held(j, t, 6)
    exact = np.sqrt(tst.laplacian_3d_eigs(nx, ny, nz))[::-1][:6]
    np.testing.assert_allclose(t.sigma[:6], exact, rtol=1e-9)
    for i in range(6):
        assert t.compute_error(i) < 1e-8


def test_gradient_complex128_trlanczos():
    nx, ny, nz = 6, 7, 8
    phi = 2 * np.pi * np.random.default_rng(11).random(nx * ny * nz)
    G = gradient_3d(nx, ny, nz, phases=phi)
    j, t = _both(jst.from_scipy(G), nsv=6, ncv=24, tol=1e-10)
    assert t.U.dtype == np.complex128
    _held(j, t, 6)
    exact = np.sqrt(tst.laplacian_3d_eigs(nx, ny, nz))[::-1][:6]
    np.testing.assert_allclose(t.sigma[:6], exact, rtol=1e-9)
    for i in range(6):
        assert t.compute_error(i) < 1e-8


def test_float32_trlanczos():
    Ad = _rect_test_matrix().astype(np.float32)
    j, t = _both(jst.DenseOperator(Ad), nsv=4, solver="trlanczos")
    assert t.U.dtype == np.float32
    _held(j, t, 4, rtol=1e-5, vtol=1e-4, its=False)
    assert abs(t.its - j.its) <= 1  # f32 rounding may move one restart
    np.testing.assert_allclose(t.sigma[:4], np.linalg.svd(
        Ad.astype(np.float64), compute_uv=False)[:4], rtol=1e-4)
