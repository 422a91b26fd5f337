"""The MFN module of slepc_tpu_torch (``mfn/mfn.py``) against slepc_tpu's,
on the CPU.

Each reference case has a twin here, both packages fed the same numpy
inputs (the port's MFN built from the reference's by
``interop.mfn_from_slepc_tpu``): tests/test_modules.py:65 (exp action),
:76 (the Eiermann-Ernst restart at ncv 8), :89 (sqrt action) and
tests/test_reference_golden.py:162 (the published norm of
exp(0.3 A) ones on the 25 x 25 Laplacian, and the half-step property).
Besides: ``expokit`` against the reference, a CSR operator, the
``-mfn_*`` options, and the reference fault the port repairs:
``expokit`` with a negative time scale (the reference returns NaN with
CONVERGED_TOL; the port steps by |T| and matches scipy) and with a complex
one (the reference raises on a complex comparison).

Tolerances: the port walks the reference's steps (the same restarts,
``its`` equal), so results agree to 1e-10 relative; each is held to the
reference test's own bound against scipy.
"""

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop
from slepc_tpu_torch.mfn import MFNConvergedReason


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """Drop the reference's jit caches when the module starts and ends."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _rel(a, b):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.linalg.norm(a - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _both(jmfn, b):
    """Solve the reference's MFN and its port twin on the same b."""
    tmfn = interop.mfn_from_slepc_tpu(jmfn, device="cpu")
    yj = np.asarray(jmfn.solve(b))
    yt = tmfn.solve(b)
    assert isinstance(yt, torch.Tensor) and yt.device.type == "cpu"
    assert tmfn.its == jmfn.its and tmfn.reason == jmfn.reason
    assert _rel(yt, yj) < 1e-10
    return yt.numpy(), tmfn


@pytest.mark.parametrize("solver", ["krylov", "expokit"])
def test_mfn_expm_action(solver):
    """tests/test_modules.py:65."""
    rng = np.random.default_rng(5)
    n = 100
    Ad = rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    y, _ = _both(jst.MFN(jst.DenseOperator(Ad), jst.FNExp(), ncv=30,
                         solver=solver), b)
    np.testing.assert_allclose(y, sla.expm(Ad) @ b, rtol=1e-7, atol=1e-9)


def test_mfn_expm_action_restarted():
    """tests/test_modules.py:76: small ncv so the Eiermann-Ernst restart
    engages."""
    rng = np.random.default_rng(6)
    n = 80
    Ad = rng.standard_normal((n, n)) / np.sqrt(n) - 0.5 * np.eye(n)
    b = rng.standard_normal(n)
    y, mfn = _both(jst.MFN(jst.DenseOperator(Ad), jst.FNExp(), ncv=8), b)
    assert mfn.its > 1
    np.testing.assert_allclose(y, sla.expm(Ad) @ b, rtol=1e-6, atol=1e-8)


def test_mfn_sqrt_action():
    """tests/test_modules.py:89."""
    rng = np.random.default_rng(7)
    n = 60
    Ad = rng.standard_normal((n, n))
    Ad = Ad @ Ad.T / n + 2 * np.eye(n)
    b = rng.standard_normal(n)
    y, _ = _both(jst.MFN(jst.DenseOperator(Ad), jst.FNSqrt(), ncv=40), b)
    np.testing.assert_allclose(y, np.real(sla.sqrtm(Ad) @ b), rtol=1e-6)


def test_mfn_exp_reference_test2_digits():
    """tests/test_reference_golden.py:162 (src/mfn/tests/test2.c):
    ||exp(0.3 A) ones|| = 26.7835 on the 25 x 25 Laplacian (DIA), and
    exp(0.15 A) twice gives the same vector."""
    nn = 25
    A = jst.laplacian_2d(nn, nn, dtype=np.float64)
    v = np.ones(nn * nn)
    out = {}
    for scale in (0.3, 0.15):
        f = jst.FNExp()
        f.set_scale(scale, 1.0)
        out[scale] = _both(jst.MFN(A, f, ncv=30, tol=1e-10), v)
    y = out[0.3][0]
    assert f"{np.linalg.norm(y):.4f}" == "26.7835"
    half = out[0.15][1]
    y2 = half.solve(half.solve(v)).numpy()
    assert np.linalg.norm(y - y2) / np.linalg.norm(y) < 1e-8


def test_mfn_csr_operator_matches_the_reference():
    """A CSR operator (the port's K6 path on a card): exp(-0.5 T) b for a
    random sparse symmetric T, krylov at ncv 12 (restarted)."""
    rng = np.random.default_rng(2)
    n = 300
    T = sp.random(n, n, density=0.02, random_state=3, format="csr")
    T = (T + T.T + sp.diags(np.linspace(1, 3, n))).tocsr()
    b = rng.standard_normal(n)
    f = jst.FNExp()
    f.set_scale(-0.5)
    y, mfn = _both(jst.MFN(jst.from_scipy(T), f, ncv=12), b)
    assert mfn.its > 1 and type(mfn.A).__name__ == "AIJOperator"
    np.testing.assert_allclose(y, sla.expm(-0.5 * T.toarray()) @ b,
                               rtol=1e-7, atol=1e-9)


def test_mfn_options_match_the_reference():
    """-mfn_ncv / -mfn_tol / -mfn_max_it / -mfn_type set the same
    attributes in both packages."""
    cli = "-mfn_ncv 12 -mfn_tol 1e-9 -mfn_max_it 7 -mfn_type expokit"
    got = []
    for pkg, kw in ((jst, {}), (tst, {"device": "cpu"})):
        pkg.set_global_options(cli)
        try:
            m = pkg.MFN(pkg.laplacian_1d(10, **kw))
            got.append((m.ncv, m.tol, m.max_it, m.solver))
        finally:
            pkg.set_global_options(pkg.Options())
    assert got[0] == got[1] == (12, 1e-9, 7, "expokit")


def test_expokit_negative_scale_diverges_from_the_reference():
    """The heat equation exp(-0.1 L) b on laplacian_1d(200), b = ones, by
    expokit: the reference steps by T = -0.1 itself (slepc_tpu/mfn/mfn.py:
    104), runs exp(+0.1 L) and returns NaN with CONVERGED_TOL; the port
    steps by |T| in the direction T/|T| and matches scipy to 1e-14 (krylov
    gives the same in both packages)."""
    L = jst.laplacian_1d(200)
    b = np.ones(200)
    ref = sla.expm(-0.1 * np.asarray(L.to_dense())) @ b
    f = jst.FNExp()
    f.set_scale(-0.1)
    jm = jst.MFN(L, f, solver="expokit")
    tm = interop.mfn_from_slepc_tpu(jm, device="cpu")
    with np.errstate(all="ignore"):
        yj = np.asarray(jm.solve(b))
    assert np.isnan(yj).any() and jm.reason == MFNConvergedReason.CONVERGED_TOL
    yt = tm.solve(b)
    assert tm.reason == MFNConvergedReason.CONVERGED_TOL
    assert _rel(yt, ref) < 1e-14
    jk = jst.MFN(L, f, solver="krylov")
    yk, _ = _both(jk, b)
    assert _rel(yk, ref) < 1e-14


def test_expokit_takes_a_complex_scale():
    """exp((-0.1 + 0.2i) L) b: the port's expokit steps along the complex
    direction (the reference raises comparing complex step sizes) and
    agrees with scipy and with the port's krylov."""
    L = tst.laplacian_1d(200, device="cpu")
    b = np.ones(200)
    alpha = -0.1 + 0.2j
    ref = sla.expm(alpha * L.to_dense().numpy()) @ b
    f = tst.FNExp()
    f.set_scale(alpha)
    for solver in ("expokit", "krylov"):
        m = tst.MFN(L, f, solver=solver)
        y = m.solve(b)
        assert y.is_complex() and m.reason == MFNConvergedReason.CONVERGED_TOL
        assert _rel(y, ref) < 1e-13, solver
    jf = jst.FNExp()
    jf.set_scale(alpha)
    with pytest.raises(TypeError):
        jst.MFN(jst.laplacian_1d(200), jf, solver="expokit").solve(b)
