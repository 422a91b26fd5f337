"""GHIEP of slepc_tpu_torch -- the pseudo-Lanczos arm of the general
Krylov-Schur loop (``eps/krylovschur.py``), the omega signatures of
``bv/`` and the indefinite DS types (``ds/types.py``, ``ds/compact.py``) --
against slepc_tpu's, on the CPU.

The DS types and the indefinite Arnoldi step take the same numpy inputs in
both packages and agree to rounding (1e-12).  The solves are held to the
reference's published digits (test18) and to scipy, and each value within
1e-9 of the reference's.  Their trajectories differ on purpose: the
reference's arm starts its signature at +1 whatever the start vector's B
norm and keeps theta and beta (e^T Q) in H at a restart (not sig theta and
omega_nv beta (e^T Q)), so its next projection is inconsistent, looks
complex and the solve re-runs as GNHEP; the port's stays in the
pseudo-Lanczos arm (ROADMAP queue 3).  A pencil with complex pairs
re-runs as GNHEP in both.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp
import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu.bv import orthog as jorthog
from slepc_tpu.bv.krylov import arnoldi_extend as jarnoldi
from slepc_tpu.ds import compact as jcompact
from slepc_tpu.ds import types as jtypes
from slepc_tpu_torch.bv import orthog as torthog
from slepc_tpu_torch.bv.krylov import arnoldi_extend as tarnoldi
from slepc_tpu_torch.ds import compact as tcompact
from slepc_tpu_torch.ds import types as ttypes


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solve(pkg, Ad, Bd, target=None, **kw):
    dev = {} if pkg is jst else {"device": "cpu"}
    eps = pkg.EPS(pkg.DenseOperator(Ad, **dev),
                  None if Bd is None else pkg.DenseOperator(Bd, **dev),
                  problem_type="ghiep", options=pkg.Options(), **kw)
    if target is not None:
        eps.set_target(target)
    eps.solve()
    return eps


def _values_held(je, te, Ad, Bd, k, rel=1e-9, resid=1e-8):
    """k values of each package, each port value within ``rel`` of one of
    the reference's and of scipy's pencil, its true residual ||A x - lam B
    x|| / (|lam| ||x||) <= ``resid``."""
    assert je.nconv >= k and te.nconv >= k
    w = sla.eigvals(Ad, Bd)
    jl = np.asarray(je.eigenvalues[: je.nconv])
    for i in range(k):
        lam = complex(te.eigenvalues[i])
        assert np.min(np.abs(jl - lam)) <= rel * abs(lam)
        assert np.min(np.abs(w - lam)) <= rel * abs(lam)
        assert te.compute_error(i) <= resid


def _test18():
    m = 10
    Ad = tst.laplacian_2d(m, m, device="cpu").to_dense().numpy()
    Ad = Ad * (4.0 / Ad[0, 0])  # the unscaled 5-point stencil
    return Ad, np.fliplr(np.eye(m * m))


def test_test18_published_digits_in_both_packages():
    """tests/test_reference_golden.py:250-275 (the reference's test18.c):
    0.16203, -0.39851 twice, 0.63499."""
    Ad, Bd = _test18()
    want = np.sort([0.16203, -0.39851, -0.39851, 0.63499])
    out = []
    for pkg in (jst, tst):
        eps = _solve(pkg, Ad, Bd, target=0.0, nev=4, ncv=20)
        got = np.sort(np.round(np.real(eps.eigenvalues[:4]), 5))
        np.testing.assert_allclose(got, want, atol=1.1e-5)
        out.append(eps)
    je, te = out
    # tol bounds the estimate of the shift-and-invert operator; the true
    # residual of the pencil is larger by up to ||A|| ||x||_B / ||x|| (9.1e-8
    # here), so it is held at 1e-6, and at tol with set_true_residual below
    _values_held(je, te, Ad, Bd, 4, resid=1e-6)
    assert te.gnhep_resolve is False  # the port stays in pseudo-Lanczos


def test_test18_true_residual():
    """test18 with set_true_residual: each pair counts only once its true
    residual on the pencil is below tol."""
    Ad, Bd = _test18()
    eps = tst.EPS(tst.DenseOperator(Ad, device="cpu"),
                  tst.DenseOperator(Bd, device="cpu"), problem_type="ghiep",
                  nev=4, ncv=20, options=tst.Options())
    eps.set_target(0.0)
    eps.set_true_residual()
    eps.solve()
    assert eps.nconv >= 4 and eps.gnhep_resolve is False
    assert max(eps.compute_error(i) for i in range(4)) <= 1e-8
    want = np.sort([0.16203, -0.39851, -0.39851, 0.63499])
    np.testing.assert_allclose(np.sort(np.real(eps.eigenvalues[:4])), want,
                               atol=1.1e-5)


@pytest.mark.parametrize("target", [None, 0.3], ids=["shift", "sinvert"])
def test_definite_pencil_stays_in_pseudo_lanczos(target):
    """laplacian_1d(40) (SPD) against B = diag(+-1): real values, the
    pseudo-Lanczos arm to the end, the signature of every locked vector
    +-1."""
    n = 40
    Ad = tst.laplacian_1d(n, device="cpu").to_dense().numpy()
    Bd = np.diag(np.where(np.arange(n) % 3 == 0, -1.0, 1.0))
    je = _solve(jst, Ad, Bd, target, nev=3, ncv=16)
    te = _solve(tst, Ad, Bd, target, nev=3, ncv=16)
    _values_held(je, te, Ad, Bd, 3, resid=1e-7)
    assert te.gnhep_resolve is False
    assert np.abs(np.imag(te.eigenvalues[: te.nconv])).max() == 0.0


def test_complex_pairs_rerun_as_gnhep():
    """A symmetric indefinite A against B = diag(+-1) has complex pairs:
    the projection shows them and both packages re-solve as GNHEP, on the
    same restart."""
    n = 40
    rng = np.random.default_rng(3)
    M = 0.2 * rng.standard_normal((n, n))
    Ad = np.diag(np.linspace(-2, 2, n)) + 0.5 * (M + M.T)
    Bd = np.diag(np.where(np.arange(n) % 2 == 0, -1.0, 1.0))
    je = _solve(jst, Ad, Bd, nev=3, ncv=16, which="largest_real")
    te = _solve(tst, Ad, Bd, nev=3, ncv=16, which="largest_real")
    assert te.gnhep_resolve is True and te.problem_type.value == "ghiep"
    assert te.nconv == je.nconv and te.its == je.its
    _values_held(je, te, Ad, Bd, 3)
    assert np.abs(np.imag(te.eigenvalues[:3])).max() > 0.1


def test_dia_and_csr_pencil_matches_reference():
    """test18's pencil on a 12 x 13 grid as the chip's phase 14b builds it
    at 95 x 97: A a DIA operator, B the anti-identity as CSR (from_scipy),
    host-factorized shift-and-invert at target 0, against the reference
    (its AIJ operator) and ARPACK on A^-1 B."""
    import jax
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    nx, ny = 12, 13
    n = nx * ny
    Bs = sp.csr_matrix((np.ones(n), (np.arange(n), np.arange(n)[::-1])),
                       shape=(n, n))
    out = []
    for pkg in (jst, tst):
        dev = {} if pkg is jst else {"device": "cpu"}
        A = pkg.laplacian_2d(nx, ny, **dev)
        B = pkg.from_scipy(Bs, **dev)
        eps = pkg.EPS(A, B, problem_type="ghiep", nev=4, ncv=20,
                      options=pkg.Options())
        eps.set_target(0.0)
        eps.solve()
        out.append(eps)
    jax.clear_caches()  # the reference's jit caches hold its CSR operator
    je, te = out
    assert type(te.B).__name__ == "AIJOperator"
    assert type(te.A).__name__ == "DIAOperator"
    assert te.gnhep_resolve is False
    As = tst.laplacian_2d(nx, ny, device="cpu").to_scipy().tocsc()
    lu = spla.splu(As)
    mu = spla.eigs(spla.LinearOperator((n, n), dtype=float,
                                       matvec=lambda x: lu.solve(Bs @ x)),
                   k=4, which="LM", return_eigenvectors=False)
    ref = 1.0 / mu
    jl = np.asarray(je.eigenvalues[: je.nconv])
    assert te.nconv >= 4 and je.nconv >= 4
    for i in range(4):
        lam = complex(te.eigenvalues[i])
        assert np.min(np.abs(ref - lam)) <= 1e-9 * abs(lam)
        assert np.min(np.abs(jl - lam)) <= 1e-9 * abs(lam)
        assert te.compute_error(i) <= 1e-7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dsghiep_hyperbolic_matches_reference(seed):
    """tests/test_round4.py:150-175: a definite T and a random signature."""
    rng = np.random.default_rng(seed)
    n = 12
    M = rng.standard_normal((n, n))
    T = M @ M.T + n * np.eye(n)
    omega = np.sign(rng.standard_normal(n))
    wj, Gj = jtypes.DSGHIEP().solve(T, omega)
    w, G = ttypes.DSGHIEP().solve(T, omega)
    np.testing.assert_allclose(w, wj, rtol=0, atol=1e-12 * np.abs(wj).max())
    np.testing.assert_allclose(G, Gj, rtol=0, atol=1e-12 * np.abs(Gj).max())
    ref = np.sort(sla.eig(T, np.diag(omega))[0].real)
    assert np.allclose(np.sort(w.real), ref, rtol=1e-8, atol=1e-8)
    S = G.T @ np.diag(omega) @ G
    assert np.abs(S - np.diag(np.diag(S))).max() < 1e-8
    assert np.sum(np.diag(S) > 0) == np.sum(omega > 0)


def test_dsghiep_complex_pairs_fallback_matches_reference():
    """tests/test_round4.py:178-185: indefinite T with complex pairs."""
    T = np.array([[0.0, 1.0], [1.0, 0.2]])
    omega = np.array([1.0, -1.0])
    wj, Xj = jtypes.DSGHIEP().solve(T, omega)
    w, X = ttypes.DSGHIEP().solve(T, omega)
    np.testing.assert_allclose(np.sort_complex(w), np.sort_complex(wj),
                               atol=1e-12)
    ref = np.sort_complex(sla.eig(T, np.diag(omega))[0])
    assert np.allclose(np.sort_complex(np.asarray(w, complex)), ref,
                       rtol=1e-8, atol=1e-8)


def test_hz_hyperbolic_jacobi_matches_reference():
    """tests/test_classes.py:560-599: a definite-type pencil built from a
    known Omega-orthogonal G0."""
    rng = np.random.default_rng(0)
    n = 12
    om = np.array([1.0] * 7 + [-1.0] * 5)
    rng.shuffle(om)
    G0 = np.eye(n)
    for _ in range(80):
        i, j = sorted(rng.choice(n, 2, replace=False))
        if om[i] == om[j]:
            th = rng.uniform(-1, 1)
            R = np.array([[np.cos(th), np.sin(th)],
                          [-np.sin(th), np.cos(th)]])
        else:
            y = rng.uniform(-0.4, 0.4)
            R = np.array([[np.cosh(y), np.sinh(y)],
                          [np.sinh(y), np.cosh(y)]])
        G0[:, [i, j]] = G0[:, [i, j]] @ R
    d = rng.uniform(0.5, 3.0, n)
    Gi = np.linalg.inv(G0)
    T = Gi.T @ np.diag(d) @ Gi
    wj, Gj, okj = jtypes._hz_hyperbolic_jacobi(T, om)
    w, G, ok = ttypes._hz_hyperbolic_jacobi(T, om)
    assert ok and okj
    np.testing.assert_allclose(w, wj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(G, Gj, rtol=0, atol=1e-12 * np.abs(Gj).max())
    assert np.abs(np.sort(w) - np.sort(d * om)).max() < 1e-12
    assert np.abs(G.T @ np.diag(om) @ G - np.diag(om)).max() < 1e-12
    w2, X2 = ttypes.DSGHIEP().solve(T, om)
    assert not np.iscomplexobj(w2)
    assert np.abs(T @ X2 - (om[:, None] * X2) * w2[None, :]).max() < \
        1e-7 * np.linalg.norm(T)
    Tind = T.copy()
    Tind[0, 0] = -Tind[0, 0]
    wi, _ = ttypes.DSGHIEP().solve(Tind, om)  # falls back, no error
    np.testing.assert_allclose(np.sort_complex(np.asarray(wi, complex)),
                               np.sort_complex(np.asarray(
                                   jtypes.DSGHIEP().solve(Tind, om)[0],
                                   complex)), atol=1e-10)


def test_solve_arrow_ghiep_matches_reference():
    """tests/test_classes.py:189-199: the compact GHIEP form, on the same
    draws (the test's generator after its HEP cases)."""
    rng = np.random.default_rng(3)
    for m, k in [(16, 7), (25, 12), (9, 0), (9, 1), (6, 5)]:
        rng.standard_normal(m), rng.standard_normal(m - 1)
    rng.standard_normal((8, 8))
    m, k = 12, 5
    d = rng.standard_normal(m)
    e = 0.1 * rng.standard_normal(m - 1)
    om = np.where(rng.standard_normal(m) > 0, 1.0, -1.0)
    T = tcompact.arrow_expand(d, e, k)
    w, X = tcompact.solve_arrow_ghiep(d, e, om, k)
    assert np.abs(T @ X - (om[:, None] * X) * w[None, :]).max() < 1e-9
    wj, Xj = jcompact.solve_arrow_ghiep(d, e, om, k)
    np.testing.assert_allclose(np.sort_complex(np.asarray(w, complex)),
                               np.sort_complex(np.asarray(wj, complex)),
                               atol=1e-12)


def test_arnoldi_extend_with_omega_matches_reference():
    """The pseudo-Lanczos step on a small indefinite B: the signature, the
    basis and H against the reference's jitted arnoldi_extend, 1e-12."""
    n, m = 40, 8
    Ad = tst.laplacian_1d(n, device="cpu").to_dense().numpy()
    om = np.where(np.arange(n) % 3 == 0, -1.0, 1.0)
    v0 = np.random.default_rng(1).standard_normal(n)
    s0 = v0 @ (om * v0)
    V = np.zeros((n, m + 1))
    V[:, 0] = v0 / np.sqrt(abs(s0))
    omega0 = np.ones(m + 1)
    omega0[0] = np.sign(s0)
    Vj, Hj, bj, brkj, omj = jarnoldi(
        jst.DenseOperator(Ad), jnp.asarray(V), jnp.zeros((m + 1, m)), 0, m,
        0, jst.DenseOperator(np.diag(om)), jnp.asarray(omega0))
    Vt = torch.from_numpy(V.T.copy())
    H = np.zeros((m + 1, m))
    omega = omega0.copy()
    _, H, beta, brk = tarnoldi(
        tst.DenseOperator(Ad, device="cpu"), Vt, H, 0, m, 0,
        tst.DenseOperator(np.diag(om), device="cpu"), omega=omega)
    assert not brk and not bool(brkj)
    np.testing.assert_array_equal(omega, np.asarray(omj))
    assert (omega < 0).any()
    Vref = np.asarray(Vj).T
    assert np.abs(Vt.numpy() - Vref).max() <= 1e-12 * np.abs(Vref).max()
    assert np.abs(H - np.asarray(Hj)).max() <= 1e-12 * np.abs(H).max()
    assert abs(beta - float(bj)) <= 1e-12 * beta
    # B-orthonormal with the signature: V^T B V = diag(omega)
    G = Vt.numpy() @ (om[:, None] * Vt.numpy().T)
    assert np.abs(G - np.diag(omega)).max() < 1e-10


def test_indefinite_bv_orthonormalize_and_svqb_match_reference():
    """BV.set_matrix(B, indef=True): orthonormalize_column signs the row
    by its B norm; svqb(omega=) against the reference's."""
    n = 30
    rng = np.random.default_rng(9)
    om = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    Bt = tst.DenseOperator(np.diag(om), device="cpu")
    bv = tst.BV(n, 3, device="cpu")
    bv.set_matrix(Bt, indef=True)
    X = rng.standard_normal((n, 3))
    for j in range(3):
        bv.set_column(j, X[:, j])
        bv.orthonormalize_column(j)
    V = bv.array.numpy()
    G = V @ (om[:, None] * V.T)
    assert np.abs(G - np.diag(bv.omega)).max() < 1e-12
    Y = rng.standard_normal((n, 4))
    sig = np.array([1.0, -1.0, 1.0, -1.0])
    Qj, Tj = jorthog.svqb(jnp.asarray(Y), lambda x: jnp.asarray(om)[:, None]
                          * x if x.ndim == 2 else jnp.asarray(om) * x,
                          jnp.asarray(sig))
    Q, T = torthog.svqb(torch.from_numpy(Y.T.copy()), Bt.mult, sig)
    np.testing.assert_allclose(T, np.asarray(Tj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Q.numpy().T, np.asarray(Qj), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(Qj)).max())
