"""Twins of the JAX package's round tests, run on the port alone.

The sources are ``tests/test_round2.py``, ``test_round3.py``,
``test_round4.py``, ``test_round5.py``, ``test_native_ldl.py`` and
``test_bv_pallas.py``: each twin keeps its original's name, inputs (numpy,
from the same seeds) and ground truth (scipy, numpy, closed forms) at the
same bound, runs ``slepc_tpu_torch`` on the CPU and reads its tensors with
``.cpu().numpy()``.  The originals that an earlier ``tests/test_torch_*.py``
test holds, and the tests of TPU machinery, are not repeated here;
``docs/torch.md`` ("The surface") maps every one of them.  Where the
original reads a private attribute (``eps._eigenvectors``) the twin reads
the public getter; where it passes ``key=jax.random.PRNGKey(s)`` the twin
passes ``seed=s`` (a kept divergence); where it calls ``A.mult`` on an
(n, k) block the twin calls ``mult_block`` on its rows.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import slepc_tpu_torch as st
from slepc_tpu_torch.eps.cheb_accel import ks_cheb_smallest
from slepc_tpu_torch.mat.generators import (laplacian_1d_eigs, laplacian_2d,
                                            laplacian_2d_eigs, laplacian_3d,
                                            laplacian_3d_eigs)
from slepc_tpu_torch.sys.sort import Which

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu_in_one_thread():
    """Every constructor's default device is the CPU while the module runs,
    and torch runs on one thread (many small solves); both restored
    after."""
    threads = torch.get_num_threads()
    st.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    st.set_default_device(None)
    torch.set_num_threads(threads)


def _np(x):
    """A result (tensor or array) as a host numpy array."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------------------
# tests/test_round2.py
# ------------------------------------------------------------------


def test_blocked_ks_cycle():
    A = st.laplacian_2d(40, 40, dtype=np.float64)  # double eigenvalues
    exact = laplacian_2d_eigs(40, 40, k=4)
    eps = st.EPS(A, problem_type="hep", which="smallest_real", nev=4,
                 ncv=32, tol=1e-9, max_it=200)
    eps.block_size = 4
    eps.solve()
    assert eps.nconv >= 4
    np.testing.assert_allclose(np.sort(eps.eigenvalues[:4].real), exact,
                               rtol=1e-7)


def test_jd_inner_gmres_interior():
    A = st.laplacian_1d(200)
    exact = laplacian_1d_eigs(200)
    tgt = 1.0
    eps = st.EPS(A, problem_type="hep", solver="jd", nev=2, ncv=24,
                 tol=1e-8, max_it=300)
    eps.set_target(tgt)
    eps.solve()
    assert eps.nconv >= 2
    want = np.sort(exact[np.argsort(np.abs(exact - tgt))[:2]])
    got = np.sort(eps.eigenvalues[:2].real)
    np.testing.assert_allclose(got, want, rtol=1e-7)


def test_gd_blocked_expansion():
    A = st.laplacian_2d(24, 23)
    exact = laplacian_2d_eigs(24, 23, k=3)
    eps = st.EPS(A, problem_type="hep", solver="gd",
                 which="smallest_real", nev=3, ncv=24, tol=1e-8, max_it=400)
    eps.davidson_bs = 2
    eps.solve()
    assert eps.nconv >= 3
    np.testing.assert_allclose(np.sort(eps.eigenvalues[:3].real), exact,
                               rtol=1e-6)


def test_slicing_factorization_cache():
    A = st.laplacian_1d(300)
    exact = laplacian_1d_eigs(300)
    lo, hi = 0.5, 0.7
    inside = np.sort(exact[(exact > lo) & (exact < hi)])
    eps = st.EPS(A, problem_type="hep", tol=1e-9)
    eps.set_interval(lo, hi)
    eps.solve()
    assert eps.nconv == len(inside)
    np.testing.assert_allclose(np.sort(eps.eigenvalues.real), inside,
                               rtol=1e-8)
    assert eps.slice_factorizations <= 8


def test_lanczos_light_reorth_modes():
    A = st.laplacian_2d(32, 31, dtype=np.float64)
    exact_l = laplacian_2d_eigs(32, 31)[::-1][:3]
    for mode in ("local", "selective", "periodic"):
        eps = st.EPS(A, problem_type="hep", solver="lanczos",
                     which="largest_real", nev=3, ncv=22, tol=1e-9,
                     max_it=500)
        eps.set_reorthogonalization(mode)
        eps.solve()
        assert eps.nconv >= 3, mode
        got = np.sort(eps.eigenvalues[:3].real)[::-1]
        np.testing.assert_allclose(got, exact_l, rtol=1e-8, err_msg=mode)


def test_cli_driven_golden(capsys):
    """Against the port's copy of the script, examples_torch/ex_cli.py."""
    spec = importlib.util.spec_from_file_location(
        "ex_cli_torch", REPO / "examples_torch" / "ex_cli.py")
    ex_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex_cli)
    try:
        eps = ex_cli.main(["-n", "30", "-m", "29", "-eps_nev", "4",
                           "-eps_smallest_real", "-eps_tol", "1e-10",
                           "-eps_converged_reason", "-eps_error_relative"])
        out = capsys.readouterr().out
        assert eps.nconv >= 4
        # golden eigenvalues of the 30x29 Laplacian (closed form)
        for s in ("0.0212175", "0.0518963", "0.0539661", "0.0846449"):
            assert s in out, s
        assert "CONVERGED_TOL" in out
        # sinvert via -st_type
        eps2 = ex_cli.main(["-n", "24", "-m", "23", "-eps_nev", "3",
                            "-eps_target", "0.5", "-st_type", "sinvert"])
        assert eps2.nconv >= 3
    finally:
        st.set_global_options({})


def test_module_options_surface():
    try:
        st.set_global_options(
            "-svd_nsv 3 -svd_type cross -pep_nev 5 -pep_type toar "
            "-mfn_ncv 17 -nep_nev 2")
        svd = st.SVD(st.laplacian_1d(32))
        assert svd.nsv == 3 and svd.solver == "cross"
        pep = st.PEP()
        assert pep.nev == 5 and pep.solver == "toar"
        mfn = st.MFN(st.laplacian_1d(32))
        assert mfn.ncv == 17
        nep = st.NEP()
        assert nep.nev == 2
    finally:
        st.set_global_options({})


# ------------------------------------------------------------------
# tests/test_round3.py
# ------------------------------------------------------------------


def test_power_fused_chunk_matches_host():
    A = laplacian_2d(12, 12, dtype=np.float64)
    lam_max = np.sort(np.linalg.eigvalsh(_np(A.to_dense())))[::-1][:2]

    eps = st.EPS(A, problem_type="hep", nev=2, tol=1e-9, max_it=20000)
    eps.set_type("power")
    eps.solve()
    assert eps.nconv == 2
    got = np.sort(eps.eigenvalues.real)[::-1]
    assert np.allclose(got, lam_max, rtol=1e-7)

    # host path (chunk=1 disables fusion) agrees
    eps2 = st.EPS(A, problem_type="hep", nev=2, tol=1e-9, max_it=20000)
    eps2.set_type("power")
    eps2.power_chunk = 1
    eps2.solve()
    assert eps2.nconv == 2
    assert np.allclose(np.sort(eps2.eigenvalues.real)[::-1], got, rtol=1e-8)


def test_power_fused_deflation_orthogonality():
    A = laplacian_2d(10, 10, dtype=np.float64)
    eps = st.EPS(A, problem_type="hep", nev=3, tol=1e-8, max_it=20000)
    eps.set_type("power")
    eps.solve()
    assert eps.nconv == 3
    V = _np(eps.get_eigenvectors())
    G = V.conj().T @ V
    assert np.allclose(G, np.eye(3), atol=1e-6)


def test_ciss_adaptive_tolerances():
    n = 200
    A = st.laplacian_1d(n)
    exact = laplacian_1d_eigs(n)
    want = exact[(exact > 0.5) & (exact < 0.8)]
    inner = {}
    for adaptive in (True, False):
        eps = st.EPS(A, problem_type="hep", solver="ciss", tol=1e-8)
        eps.set_rg(st.RGEllipse(center=0.65, radius=0.15, vscale=0.4))
        eps.ciss_solver = "batched"
        eps.ciss_adaptive = adaptive
        eps.solve()
        got = np.sort(eps.eigenvalues[: eps.nconv].real)
        assert eps.nconv == len(want)
        assert np.abs(got - want).max() < 1e-8
        inner[adaptive] = eps.ciss_inner_iters
    assert inner[True] < 0.95 * inner[False], inner


def test_gd_fused_matches_host():
    n = 500
    d = np.linspace(1, 50, n)
    A = sp.diags([d, -np.ones(n - 1), -np.ones(n - 1)], [0, -1, 1],
                 format="csr")
    exact = np.sort(np.linalg.eigvalsh(A.toarray()))[:3]
    op = st.from_scipy(A)
    for fused in (True, False):
        eps = st.EPS(op, problem_type="hep", which=Which.SMALLEST_REAL,
                     nev=3, solver="gd", ncv=20, max_it=2000, tol=1e-8)
        eps.set_st(st.STPrecond([op]))
        eps.gd_fused = fused
        eps.solve()
        assert eps.nconv >= 3, fused
        got = np.sort(eps.eigenvalues[:3].real)
        np.testing.assert_allclose(got, exact, rtol=1e-7)


# ------------------------------------------------------------------
# tests/test_round4.py
# ------------------------------------------------------------------


def test_cheb_operator_matches_dense():
    from slepc_tpu_torch.st.cheb import ChebAmplifyOperator, cheb_value

    A = laplacian_3d(6, 5, 4, dtype=np.float64)
    Ad = _np(A.to_dense())
    w, U = np.linalg.eigh(Ad)
    lo, hi = float(w[8] * 1.1), 13.0
    for d in (0, 1, 2, 7, 20):
        bop = ChebAmplifyOperator(A, lo, hi, d)
        x = np.random.default_rng(d).standard_normal(A.shape[0])
        y = _np(bop.mult(x))  # a numpy x: the array rule
        yref = U @ (cheb_value(w, lo, hi, d) * (U.T @ x))
        assert np.abs(y - yref).max() <= 1e-11 * max(np.abs(yref).max(), 1)


def test_cheb_value_branches():
    from numpy.polynomial.chebyshev import chebval

    from slepc_tpu_torch.st.cheb import cheb_value

    d = 9
    coef = np.zeros(d + 1)
    coef[d] = 1.0
    lo, hi = 2.0, 10.0
    lam = np.array([0.0, 1.9, 2.0, 5.0, 10.0, 11.5])  # below / in / above
    t = (hi + lo - 2 * lam) / (hi - lo)
    ref = chebval(t, coef)
    got = cheb_value(lam, lo, hi, d)
    assert np.allclose(got, ref, rtol=1e-10)
    # monotone decreasing below lo => smallest-first order preserved
    lam_small = np.linspace(0.0, 1.99, 40)
    p = cheb_value(lam_small, lo, hi, d)
    assert np.all(np.diff(p) < 0)


def test_gershgorin_upper_bounds_spectrum():
    from slepc_tpu_torch.st.cheb import gershgorin_upper

    A = laplacian_3d(7, 6, 5, dtype=np.float64)
    lam_max = np.linalg.eigvalsh(_np(A.to_dense()))[-1]
    g = gershgorin_upper(A)
    assert lam_max <= g <= 12.0 + 1e-12


def test_cheb_smallest_driver_converges():
    A = laplacian_3d(16, 17, 18, dtype=np.float64)
    res = ks_cheb_smallest(A, nev=10, tol=1e-8, ncv=32, degree=60)
    exact = laplacian_3d_eigs(16, 17, 18, k=10)
    assert res["nconv"] == 10
    assert np.abs(res["lam"][:10] - exact).max() < 1e-10
    assert res["resid"][:10].max() < 1e-8
    # the amplified run must be cheap: a few restarts, not thousands
    assert res["stats"]["cols"] < 400


def test_cheb_adaptation_from_bad_window():
    A = laplacian_3d(12, 13, 14, dtype=np.float64)
    exact = laplacian_3d_eigs(12, 13, 14, k=6)
    # lo0 below lambda_1: nothing is amplified until the controller moves
    res = ks_cheb_smallest(A, nev=6, tol=1e-8, ncv=28, degree=50,
                           lo0=float(exact[0]) * 0.5, probe=False)
    assert res["nconv"] == 6
    assert res["stats"]["adaptations"] >= 1
    assert np.abs(res["lam"][:6] - exact).max() < 1e-10


def test_eps_cheb_route():
    A = laplacian_3d(10, 11, 12, dtype=np.float64)
    eps = st.EPS(A, problem_type="hep", which=Which.SMALLEST_REAL,
                 nev=5, ncv=24, tol=1e-9)
    eps.cheb_degree = 40
    eps.solve()
    exact = laplacian_3d_eigs(10, 11, 12, k=5)
    assert eps.nconv >= 5
    assert np.abs(np.sort(eps.eigenvalues[:5].real) - exact).max() < 1e-9
    X = _np(eps.get_eigenvectors()[:, :5])
    R = np.asarray(A.to_scipy() @ X) - X * eps.eigenvalues[:5].real
    assert np.linalg.norm(R, axis=0).max() < 1e-7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dsghiep_hyperbolic_vs_scipy(seed):
    from slepc_tpu_torch.ds.types import DSGHIEP

    rng = np.random.default_rng(seed)
    n = 12
    M = rng.standard_normal((n, n))
    T = M @ M.T + n * np.eye(n)  # definite
    omega = np.sign(rng.standard_normal(n))
    w, G = DSGHIEP().solve(T, omega)
    w, G = _np(w), _np(G)
    ref = np.sort(sla.eig(T, np.diag(omega))[0].real)
    assert np.allclose(np.sort(w.real), ref, rtol=1e-8, atol=1e-8)
    S = G.T @ np.diag(omega) @ G
    assert np.abs(S - np.diag(np.diag(S))).max() < 1e-8
    assert np.allclose(np.abs(np.diag(S)), 1.0, atol=1e-8)
    assert np.sum(np.diag(S) > 0) == np.sum(omega > 0)
    for j in range(n):
        r = T @ G[:, j] - w[j] * (omega * G[:, j])
        assert np.linalg.norm(r) < 1e-7 * np.linalg.norm(T)


def test_dsghiep_indefinite_fallback_complex_pairs():
    from slepc_tpu_torch.ds.types import DSGHIEP

    T = np.array([[0.0, 1.0], [1.0, 0.2]])
    omega = np.array([1.0, -1.0])
    w, X = DSGHIEP().solve(T, omega)
    ref = np.sort_complex(sla.eig(T, np.diag(omega))[0])
    assert np.allclose(np.sort_complex(np.asarray(_np(w), complex)), ref,
                       rtol=1e-8, atol=1e-8)


def _bse_pair(n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    if complex_:
        Rm = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        Rm = 0.5 * (Rm + Rm.conj().T) + 2 * n * np.eye(n)
        Cm = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        Cm = 0.5 * (Cm + Cm.T)  # complex symmetric
    else:
        Rm = rng.standard_normal((n, n))
        Rm = 0.5 * (Rm + Rm.T) + 2 * n * np.eye(n)
        Cm = rng.standard_normal((n, n))
        Cm = 0.5 * (Cm + Cm.T)
    Hd = np.block([[Rm, Cm], [-Cm.conj(), -Rm.conj()]])
    return Rm, Cm, Hd


@pytest.mark.parametrize("variant,complex_", [("auto", False),
                                              ("projected", False),
                                              ("auto", True)])
def test_bse_variants_vs_dense(variant, complex_):
    from slepc_tpu_torch.mat.linop import DenseOperator
    from slepc_tpu_torch.mat.structured import create_bse

    n = 16
    Rm, Cm, Hd = _bse_pair(n, 3, complex_)
    lam_pos = np.sort(sla.eig(Hd)[0].real)
    lam_pos = lam_pos[lam_pos > 0][:4]
    H = create_bse(DenseOperator(Rm), DenseOperator(Cm))
    eps = st.EPS(H, problem_type="bse", nev=4, ncv=14, tol=1e-9)
    eps.set_type("bse")
    eps.bse_variant = variant
    eps.solve()
    assert eps.nconv >= 4
    assert np.allclose(np.sort(eps.eigenvalues[:4].real), lam_pos,
                       rtol=1e-6, atol=1e-8)


def test_cg_minres_fixed_solve():
    from slepc_tpu_torch.ksp.iterative_jit import cg_fixed, minres_fixed

    rng = np.random.default_rng(1)
    n = 120
    M = rng.standard_normal((n, n))
    A = torch.from_numpy(M @ M.T + n * np.eye(n))
    b = rng.standard_normal(n)  # a numpy b: the array rule
    x = cg_fixed(lambda v: A @ v, b, 200)
    assert np.linalg.norm(_np(A @ x) - b) < 1e-10 * np.linalg.norm(b)
    # MINRES on an indefinite symmetric system
    Ai = torch.from_numpy(M + M.T + 0.1 * np.eye(n))
    xi = minres_fixed(lambda v: Ai @ v, b, 400)
    assert np.linalg.norm(_np(Ai @ xi) - b) < 1e-8 * np.linalg.norm(b)


def test_sinvert_device_operator_matches_direct():
    import scipy.sparse.linalg as spla

    from slepc_tpu_torch.st.sinvert_jit import SinvertCGOperator

    nx, ny, nz = 10, 11, 12
    n = nx * ny * nz
    A = laplacian_3d(nx, ny, nz, dtype=np.float64)
    bd = 1.0 + 0.5 * np.sin(np.arange(n) * 0.01)
    op = SinvertCGOperator.from_dia(A, sigma=0.0,
                                    b_diag=torch.from_numpy(bd), iters=400)
    x = np.random.default_rng(0).standard_normal(n)
    # the port's vectors are flat: mult, where the original pads
    y = _np(op.mult(x))
    yref = np.sqrt(bd) * spla.spsolve(
        sp.csr_matrix(A.to_scipy()), np.sqrt(bd) * x)
    assert np.abs(y - yref).max() < 1e-10 * np.abs(yref).max()


@pytest.mark.parametrize("n,rho", [(12, 1.0), (60, 0.25), (60, -3.0),
                                   (150, 4.0)])
def test_dpr1_eig_matches_dense(n, rho):
    rng = np.random.default_rng(n)
    d = np.sort(rng.standard_normal(n) * 2.0)
    z = rng.standard_normal(n)
    d[4] = d[3]            # exact cluster -> Givens deflation
    z[7] = 1e-19           # tiny component -> deflation pass 1
    from slepc_tpu_torch.ds.bdc import dpr1_eig

    M = np.diag(d) + rho * np.outer(z, z)
    w, Q = dpr1_eig(d, z, rho)
    we = np.linalg.eigvalsh(M)
    nrm = np.abs(we).max()
    assert np.abs(w - we).max() < 1e-12 * max(nrm, 1.0)
    assert np.abs(Q.T @ Q - np.eye(n)).max() < 1e-12
    assert np.abs(Q @ np.diag(w) @ Q.T - M).max() < 1e-12 * max(nrm, 1.0)


def test_dpr1_eig_rotates_given_basis():
    from slepc_tpu_torch.ds.bdc import dpr1_eig

    rng = np.random.default_rng(5)
    n = 40
    d = np.sort(rng.standard_normal(n))
    z = rng.standard_normal(n)
    B, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w1, Q1 = dpr1_eig(d, z, 1.7)
    w2, Q2 = dpr1_eig(d, z, 1.7, basis=B)
    assert np.allclose(w1, w2)
    dots = np.abs(np.sum((B @ Q1) * Q2, axis=0))
    assert np.abs(dots - 1.0).max() < 1e-10


@pytest.mark.parametrize("nb,bs", [(4, 9), (7, 12), (3, 40)])
def test_bdc_eig_exact_matches_eigh(nb, bs):
    from slepc_tpu_torch.ds.bdc import bdc_eig, block_tridiag_dense

    rng = np.random.default_rng(nb * 100 + bs)
    Ds = [0.5 * (D + D.T) for D in
          (rng.standard_normal((bs, bs)) for _ in range(nb))]
    Es = [0.4 * rng.standard_normal((bs, bs)) for _ in range(nb - 1)]
    M = block_tridiag_dense(Ds, Es)
    w, Q = bdc_eig(Ds, Es, tau=0.0, dense_cutoff=10)
    we = np.linalg.eigvalsh(M)
    n = M.shape[0]
    assert np.abs(w - we).max() < 1e-10 * max(1.0, np.abs(we).max())
    assert np.abs(Q.T @ Q - np.eye(n)).max() < 1e-12
    assert np.abs(Q @ np.diag(w) @ Q.T - M).max() < 1e-10


def test_bdc_eig_tau_bounds_error():
    from slepc_tpu_torch.ds.bdc import bdc_eig, block_tridiag_dense

    rng = np.random.default_rng(77)
    nb, bs = 6, 16
    Ds = [0.5 * (D + D.T) + np.diag(np.linspace(1, 2, bs))
          for D in (0.1 * rng.standard_normal((bs, bs))
                    for _ in range(nb))]
    Es = [0.01 * rng.standard_normal((bs, bs)) for _ in range(nb - 1)]
    M = block_tridiag_dense(Ds, Es)
    we = np.linalg.eigvalsh(M)
    for tau in (1e-3, 1e-6):
        w, Q = bdc_eig(Ds, Es, tau=tau, dense_cutoff=8)
        assert np.abs(w - we).max() < 10 * tau * np.abs(M).max()
        assert np.abs(Q.T @ Q - np.eye(M.shape[0])).max() < 1e-10


def test_dshep_solve_block_tridiag_routes():
    from slepc_tpu_torch.ds.bdc import block_tridiag_dense
    from slepc_tpu_torch.ds.types import DSHEP

    rng = np.random.default_rng(3)
    Ds = [0.5 * (D + D.T) for D in
          (rng.standard_normal((8, 8)) for _ in range(5))]
    Es = [0.3 * rng.standard_normal((8, 8)) for _ in range(4)]
    ds = DSHEP()
    w_dense, _ = ds.solve_block_tridiag(Ds, Es)           # eigh route
    w_bdc, Q = ds.solve_block_tridiag(Ds, Es, force=True)  # D&C route
    assert np.abs(w_dense - w_bdc).max() < 1e-10
    M = block_tridiag_dense(Ds, Es)
    assert np.abs(Q @ np.diag(w_bdc) @ Q.T - M).max() < 1e-10


def test_dsnep_contour_batched_quadrature():
    from slepc_tpu_torch.ds.types import DSNEP

    rng = np.random.default_rng(11)
    k = 6
    A0 = rng.standard_normal((k, k))
    A1 = rng.standard_normal((k, k))
    A2 = rng.standard_normal((k, k))

    def Tfun(lam):
        return A0 + lam * A1 + lam * lam * A2

    Z = np.zeros((2 * k, 2 * k), dtype=complex)
    Z[:k, k:] = np.eye(k)
    Z[k:, :k] = -np.linalg.solve(A2, A0)
    Z[k:, k:] = -np.linalg.solve(A2, A1)
    lam_all = np.linalg.eigvals(Z)
    center, radius = 0.0, 0.8
    inside = lam_all[np.abs(lam_all - center) < radius * 0.95]
    lam, X = DSNEP().solve_contour(Tfun, center, radius, npoints=64)
    lam, X = _np(lam), _np(X)
    got = np.sort_complex(lam[np.abs(lam - center) < radius * 0.95])
    want = np.sort_complex(inside)
    assert got.size == want.size
    assert np.abs(got - want).max() < 1e-8
    for mu, x in zip(lam, X.T):
        if abs(mu - center) < radius * 0.95:
            r = np.linalg.norm(Tfun(mu) @ x)
            assert r < 1e-7


# ------------------------------------------------------------------
# tests/test_round5.py
# ------------------------------------------------------------------


class TestChebBlocked:

    def test_blocked_converges_matches_exact(self):
        side = 60
        A = laplacian_2d(side, side, dtype=np.float64)
        exact = laplacian_2d_eigs(side, side, k=8)
        res = ks_cheb_smallest(A, nev=8, tol=1e-8, ncv=24, degree=60,
                               block=4, seed=3)
        assert res["nconv"] >= 8
        got = np.sort(res["lam"][:8])
        assert np.abs(got - exact).max() < 1e-10
        assert np.max(res["resid"][:8]) < 1e-8

    def test_blocked_ncv_must_divide(self):
        A = laplacian_2d(20, 20, dtype=np.float64)
        with pytest.raises(ValueError):
            ks_cheb_smallest(A, nev=4, tol=1e-8, ncv=22, degree=20,
                             block=4)

    def test_blocked_window_adaptation(self):
        side = 60
        A = laplacian_2d(side, side, dtype=np.float64)
        exact = laplacian_2d_eigs(side, side, k=6)
        res = ks_cheb_smallest(A, nev=6, tol=1e-8, ncv=16, degree=40,
                               block=4, seed=5, max_cycles=200)
        assert res["nconv"] >= 6
        got = np.sort(res["lam"][:6])
        assert np.abs(got - exact).max() < 1e-9


class TestChebPartial:

    def test_partial_converges_matches_exact(self):
        side = 80
        A = laplacian_2d(side, side, dtype=np.float64)
        exact = laplacian_2d_eigs(side, side, k=10)
        res = ks_cheb_smallest(A, nev=10, tol=1e-8, ncv=32, degree=80,
                               reorth="partial", seed=7)
        assert res["nconv"] >= 10
        got = np.sort(res["lam"][:10])
        assert np.abs(got - exact).max() < 1e-10
        assert np.max(res["resid"][:10]) < 1e-8

    def test_partial_column_count_comparable_to_full(self):
        side = 80
        A = laplacian_2d(side, side, dtype=np.float64)
        cols = {}
        for reo in ("full", "partial"):
            res = ks_cheb_smallest(A, nev=10, tol=1e-8, ncv=32, degree=80,
                                   reorth=reo, seed=7)
            assert res["nconv"] >= 10
            cols[reo] = res["stats"]["cols"]
        assert cols["partial"] <= 1.5 * cols["full"]


@pytest.mark.slow
class TestChebSeedSweep:

    def test_three_seeds_converge(self):
        side = 150
        A = laplacian_2d(side, side, dtype=np.float64)
        exact = laplacian_2d_eigs(side, side, k=12)
        for seed in (0, 11, 202):
            res = ks_cheb_smallest(A, nev=12, tol=1e-8, ncv=32,
                                   degree=100, reorth="partial",
                                   seed=seed, max_cycles=300)
            assert res["nconv"] >= 12, f"seed {seed}: {res['nconv']}"
            got = np.sort(res["lam"][:12])
            assert np.abs(got - exact).max() < 1e-9, f"seed {seed}"


class TestTridiagDevice:
    """The original hands the numpy diagonals to the device functions; so
    does the twin (the array rule)."""

    def _rand_tridiag(self, n, seed=0):
        rng = np.random.default_rng(seed)
        a = 2.0 + 0.1 * rng.standard_normal(n)
        b = -1.0 + 0.05 * rng.standard_normal(n - 1)
        return a, b

    def test_inertia_matches_eigvals(self):
        from slepc_tpu_torch.ksp.tridiag_device import tridiag_inertia

        a, b = self._rand_tridiag(3000)
        w = sla.eigh_tridiagonal(a, b, eigvals_only=True)
        for sigma in (0.1, 1.0, 2.0, 3.5):
            assert int(tridiag_inertia(a, b, sigma)) == int(
                np.sum(w < sigma))

    def test_solve_with_refinement(self):
        from slepc_tpu_torch.ksp.tridiag_device import tridiag_solve

        n = 4000
        a, b = self._rand_tridiag(n, seed=1)
        rng = np.random.default_rng(2)
        rhs = rng.standard_normal(n)
        for sigma in (0.37, 1.9, 3.2):
            x = _np(tridiag_solve(a, b, sigma, rhs))
            T = np.diag(a - sigma) + np.diag(b, 1) + np.diag(b, -1)
            assert (np.linalg.norm(T @ x - rhs)
                    / np.linalg.norm(rhs)) < 5e-13

    def test_directsolver_routes_tridiag_device(self):
        from slepc_tpu_torch.ksp.direct import DirectSolver
        from slepc_tpu_torch.mat.linop import DIAOperator

        n = 2000
        a, b = self._rand_tridiag(n, seed=3)
        lo = np.zeros(n)
        hi = np.zeros(n)
        hi[: n - 1] = b
        lo[1:] = b
        A = DIAOperator((-1, 0, 1), np.stack([lo, a, hi]))
        ds = DirectSolver(A)
        assert ds.backend == "tridiag_device"
        neg, zero, pos = ds.inertia()
        w = sla.eigh_tridiagonal(a, b, eigvals_only=True)
        assert neg == int(np.sum(w < 0))
        rhs = np.random.default_rng(4).standard_normal(n)
        x = _np(ds.solve(rhs))
        T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
        assert np.linalg.norm(T @ x - rhs) / np.linalg.norm(rhs) < 1e-12

    def test_slicing_through_device_backend(self):
        from slepc_tpu_torch.mat.linop import DIAOperator

        n = 4000
        a = np.full(n, 2.0)
        b = np.full(n - 1, -1.0)
        lo = np.zeros(n)
        hi = np.zeros(n)
        hi[: n - 1] = b
        lo[1:] = b
        A = DIAOperator((-1, 0, 1), np.stack([lo, a, hi]))
        ks = np.arange(1, n + 1)
        exact = 2 - 2 * np.cos(ks * np.pi / (n + 1))
        intl = (0.002, 0.01)
        expect = np.sort(exact[(exact > intl[0]) & (exact < intl[1])])
        eps = st.EPS(A, problem_type="hep", nev=len(expect), tol=1e-9)
        eps.set_interval(*intl)
        eps.solve()
        assert eps.nconv == len(expect)
        got = np.sort(eps.eigenvalues[: eps.nconv].real)
        assert np.abs(got - expect).max() < 1e-8


class TestBlockTridiagDevice:

    def test_inertia_and_solve_vs_dense(self):
        from slepc_tpu_torch.ksp.tridiag_device import (btridiag_inertia,
                                                        btridiag_of_operator,
                                                        btridiag_solve)

        side = 30
        A = laplacian_2d(side, side, dtype=np.float64)
        btd = btridiag_of_operator(A)
        assert btd is not None
        Ab, Bb = btd
        As = A.to_scipy().toarray()
        w = np.linalg.eigvalsh(As)
        for sigma in (0.05, 2.0, 7.0):
            assert int(btridiag_inertia(Ab, Bb, sigma)) == int(
                np.sum(w < sigma))
        rng = np.random.default_rng(0)
        rhs = rng.standard_normal(side * side)
        x = _np(btridiag_solve(Ab, Bb, 0.013, rhs))
        r = np.linalg.norm((As - 0.013 * np.eye(side * side)) @ x - rhs)
        assert r / np.linalg.norm(rhs) < 1e-11

    def test_2d_slicing_via_device_backend(self):
        from slepc_tpu_torch.ksp.direct import DirectSolver

        nx, ny = 40, 41  # anisotropic: generically simple spectrum
        A = laplacian_2d(nx, ny, dtype=np.float64)
        assert DirectSolver(A).backend == "btridiag_device"
        lx = 2 - 2 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
        ly = 2 - 2 * np.cos(np.arange(1, ny + 1) * np.pi / (ny + 1))
        exact = np.sort((lx[:, None] + ly[None, :]).ravel())
        intl = (0.04, 0.12)
        expect = np.sort(exact[(exact > intl[0]) & (exact < intl[1])])
        eps = st.EPS(A, problem_type="hep", nev=len(expect), tol=1e-9)
        eps.set_interval(*intl)
        eps.solve()
        assert eps.nconv == len(expect)
        got = np.sort(eps.eigenvalues[: eps.nconv].real)
        assert np.abs(got - expect).max() < 1e-8


class TestBDCDeflationScaling:

    def test_large_rho_under_threshold(self):
        from slepc_tpu_torch.ds.bdc import dpr1_eig

        rng = np.random.default_rng(0)
        n = 40
        eps = np.finfo(float).eps
        for rho in (1.0, 1e6, 1e12):
            d = np.sort(rng.standard_normal(n))
            z = rng.standard_normal(n)
            z /= np.linalg.norm(z)
            dspread = max(d[-1] - d[0], abs(d[-1]), abs(d[0]), 1.0)
            tol = 8 * eps * max(dspread, rho)
            z[5:10] = 0.05 * tol / rho  # just under the threshold
            w, Q = dpr1_eig(d.copy(), z.copy(), rho)
            A = np.diag(d) + rho * np.outer(z, z)
            rec = (np.linalg.norm(Q @ np.diag(w) @ Q.T - A)
                   / np.linalg.norm(A))
            assert rec < 5e-14, f"rho={rho}: {rec:.2e}"
            assert np.linalg.norm(Q.T @ Q - np.eye(n)) < 1e-13


class TestExpansionCounter:
    def test_gd_counts_expansions(self):
        from slepc_tpu_torch.mat.linop import DIAOperator
        from slepc_tpu_torch.st.st import STPrecond

        n = 1200
        d = np.linspace(10, 30, n).astype(np.float64)
        d[:3] = [1.0, 2.0, 3.0]
        lo = np.zeros(n)
        hi = np.zeros(n)
        hi[:-1] = -1.0
        lo[1:] = -1.0
        A = DIAOperator((-1, 0, 1), np.stack([lo, d, hi]))
        for fused in (True, False):
            eps = st.EPS(A, problem_type="hep", which=Which.SMALLEST_REAL,
                         nev=3, ncv=24, max_it=60, tol=1e-6, solver="gd")
            eps.set_st(STPrecond([A]))
            eps.gd_fused = fused
            eps.solve()
            assert eps.nconv >= 3
            assert eps.expansions > 0


class TestDSRotateKernel:
    """The behavioural half of the original class: rot_mode "ds" is the
    native-precision rotation on K4 in the port, the same as "exact" (a
    kept divergence), so both cycles run the same arithmetic."""

    def test_cycle_rot_mode_ds_matches_exact(self):
        from slepc_tpu_torch.eps.ks_jit import ks_hep_cycle

        side = 24
        A = laplacian_2d(side, side, dtype=np.float64)
        ncv = 10
        rng = np.random.default_rng(5)
        v0 = rng.standard_normal(side * side)
        outs = []
        for mode in ("exact", "ds"):
            V = torch.zeros((ncv + 1, side * side), dtype=torch.float64)
            V[0] = torch.from_numpy(v0 / np.linalg.norm(v0))
            H = np.zeros((ncv + 1, ncv))
            gen = torch.Generator().manual_seed(0)
            outs.append(ks_hep_cycle(A, V, H, 0, 1e-8, gen, ncv=ncv,
                                     which="smallest", rot_mode=mode))
        out_e, out_d = outs
        assert np.abs(_np(out_e[4]) - _np(out_d[4])).max() < 1e-11
        assert np.abs(_np(out_e[0]) - _np(out_d[0])).max() < 1e-11

    def test_cheb_driver_certifies_with_ds_rotation(self, monkeypatch):
        import slepc_tpu_torch.eps.ks_jit as ks_jit

        calls = []
        orig = ks_jit.rotate
        monkeypatch.setattr(ks_jit, "rotate", lambda *a, **k: (
            calls.append(1), orig(*a, **k))[1])
        side = 60
        A = laplacian_2d(side, side, dtype=np.float64)
        exact = laplacian_2d_eigs(side, side, k=8)
        res = ks_cheb_smallest(A, nev=8, tol=1e-8, ncv=24, degree=60,
                               rot_mode="ds", seed=3)
        assert len(calls) >= 1  # the rotation (K4 on a card) really ran
        assert res["nconv"] >= 8
        assert np.abs(np.sort(res["lam"][:8]) - exact).max() < 1e-10
        assert np.max(res["resid"][:8]) < 1e-8


# ------------------------------------------------------------------
# tests/test_native_ldl.py
# ------------------------------------------------------------------


@pytest.fixture
def native_ldl():
    from slepc_tpu_torch.native import ldl

    if not ldl.ldl_available():
        pytest.skip("native LDL toolchain unavailable")
    return ldl.LDLFactorization


def test_ldl_spd_solve_and_inertia(native_ldl):
    A = st.laplacian_2d(30, 28).to_scipy()
    n = A.shape[0]
    F = native_ldl(A)
    assert F.inertia() == (0, 0, n)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)
    x = F.solve(b)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-12
    B = rng.standard_normal((n, 4))
    X = F.solve(B)
    assert np.linalg.norm(A @ X - B) / np.linalg.norm(B) < 1e-12


def test_ldl_indefinite_inertia(native_ldl):
    A = st.laplacian_2d(25, 24).to_scipy()
    n = A.shape[0]
    exact = laplacian_2d_eigs(25, 24)
    for sigma in (0.5, 1.7, 4.03, 6.5):
        S = (A - sigma * sp.eye(n)).tocsr()
        F = native_ldl(S)
        neg, zero, pos = F.inertia()
        assert neg == int(np.sum(exact < sigma)), f"sigma={sigma}"
        rng = np.random.default_rng(1)
        b = rng.standard_normal(n)
        x = F.solve(b)
        assert np.linalg.norm(S @ x - b) / np.linalg.norm(b) < 1e-9


def test_ldl_random_symmetric(native_ldl):
    rng = np.random.default_rng(2)
    n = 300
    A = sp.random(n, n, density=0.02, random_state=rng)
    A = (A + A.T) * 0.5 + sp.diags(np.full(n, 0.5))
    A = sp.csr_matrix(A)
    w = np.linalg.eigvalsh(A.toarray())
    F = native_ldl(A)
    neg, zero, pos = F.inertia()
    assert neg == int(np.sum(w < 0))
    assert pos == int(np.sum(w > 0))
    b = rng.standard_normal(n)
    x = F.solve(b)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-8


def test_slicing_uses_native_ldl(native_ldl):
    A = st.laplacian_2d(12, 11)
    exact = laplacian_2d_eigs(12, 11)
    a, b = 0.4, 0.9
    inside = np.sort(exact[(exact > a) & (exact < b)])
    eps = st.EPS(A, problem_type="hep")
    eps.set_interval(a, b)
    eps.solve()
    assert eps.nconv == len(inside)
    np.testing.assert_allclose(np.sort(eps.eigenvalues.real), inside,
                               rtol=1e-7)


# ------------------------------------------------------------------
# tests/test_bv_pallas.py
# ------------------------------------------------------------------


def test_laplacian_3d_device_matches_host():
    from slepc_tpu_torch.mat.generators import laplacian_3d_device

    nx, ny, nz = 7, 6, 5
    A = laplacian_3d(nx, ny, nz, dtype=np.float64)
    op = laplacian_3d_device(nx, ny, nz, dtype=np.float64)
    x = np.random.default_rng(0).standard_normal(nx * ny * nz)
    y1 = A.to_scipy() @ x
    y2 = _np(op.mult(x))  # flat vectors: mult, where the original pads
    assert np.abs(y1 - y2).max() / np.abs(y1).max() < 1e-13
    ev = np.sort(np.linalg.eigvalsh(A.to_scipy().toarray()))[:10]
    assert np.abs(ev - laplacian_3d_eigs(nx, ny, nz, k=10)).max() < 1e-12
