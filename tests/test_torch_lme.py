"""The LME module of slepc_tpu_torch (``lme/lme.py``) against slepc_tpu's,
on the CPU.

Each reference case has a twin here, both packages fed the same numpy
inputs (the port's LME built from the reference's by
``interop.lme_from_slepc_tpu``): tests/test_modules.py:182 (low-rank
Lyapunov), :198 (dense Sylvester), :209 (generalized Lyapunov through a
direct KSP on E), :227 (Krylov Sylvester on CSR tridiagonals),
tests/test_round2.py:197 (Krylov Sylvester at 1,000 / 800 rows against
the dense residual, and matrix-free at 100,000 rows) and :227 (Krylov
Stein at 2,000 rows).  Besides: the factored ``compute_residual`` against
the dense formula, and the reference fault the port repairs: a complex
Lyapunov equation, where the reference symmetrizes the projected solution
with 0.5 (Y + Y^T) (Re Y) and its residual stalls at ~6e-4, while the
port's 0.5 (Y + Y^H) reaches 1e-14.

Tolerances: the port walks the reference's steps (``its`` equal), so the
solutions X = Z Z^H (or L R^H) agree to 1e-10 relative; each residual is
held to the reference test's own bound.
"""

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu.lme.lme import LME as JLME
from slepc_tpu_torch import interop


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """Drop the reference's jit caches when the module starts and ends
    (tests/test_modules.py:227's CSR operators have this module's
    shapes)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    return np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b))


def _both(jlme, *rhs):
    """Solve the reference's LME and its port twin; the port walks the
    same Krylov builds (the generalized Lyapunov equation reports its inner
    solve's builds, where the reference leaves 0)."""
    tlme = interop.lme_from_slepc_tpu(jlme, device="cpu")
    out_j = jlme.solve(*rhs)
    out_t = tlme.solve(*rhs)
    if jlme.problem_type.value == "gen_lyapunov":
        assert jlme.its == 0 and tlme.its >= 1
    else:
        assert tlme.its == jlme.its
    return out_j, out_t, tlme


def _stable(n=60):
    return -np.eye(n) * 2 + np.diag(np.ones(n - 1), 1) * 0.5 \
        + np.diag(np.ones(n - 1), -1) * 0.4


def test_lme_lyapunov_lowrank():
    """tests/test_modules.py:182."""
    rng = np.random.default_rng(10)
    n = 60
    Ad = _stable(n)
    C1 = rng.standard_normal((n, 2))
    Zj, Zt, lme = _both(JLME(jst.DenseOperator(Ad), ncv=30, tol=1e-9), C1)
    # the rank kept may differ by a direction at the 1e-14 cut
    assert isinstance(Zt, torch.Tensor) and Zt.shape[0] == n
    assert abs(Zt.shape[1] - Zj.shape[1]) <= 2
    Xt = _np(Zt @ Zt.T)
    assert _rel(Xt, Zj @ Zj.T) < 1e-10
    assert lme.compute_residual(Zt, C1) < 1e-6
    np.testing.assert_allclose(Xt, sla.solve_lyapunov(Ad, -C1 @ C1.T),
                               atol=1e-6)


def test_lyapunov_factors_are_the_krylov_form_of_solve():
    """``lyapunov_factors``: one (V, L) a column of C1, V an orthonormal
    row basis, Z = V^T L the factor ``solve`` stacks, so Z's left singular
    vectors are V^T times L's (what lyapii reads, without Z on the host)."""
    rng = np.random.default_rng(10)
    n = 60
    A = tst.DenseOperator(_stable(n), device="cpu")
    C1 = rng.standard_normal((n, 2))
    lme = tst.LME(A, ncv=30, tol=1e-9)
    pairs = lme.lyapunov_factors(C1)
    Z = _np(lme.solve(C1))
    assert len(pairs) == 2
    Zf = np.concatenate([_np(V).T @ L for V, L in pairs], axis=1)
    assert _rel(Zf, Z) < 1e-14
    V, L = pairs[0]
    V = _np(V)
    np.testing.assert_allclose(V @ V.T, np.eye(V.shape[0]), atol=1e-13)
    U = np.linalg.svd(V.T @ L, full_matrices=False)[0][:, :2]
    Uf = V.T @ np.linalg.svd(L, full_matrices=False)[0][:, :2]
    np.testing.assert_allclose(np.abs(np.sum(U * Uf, axis=0)), 1.0,
                               atol=1e-12)


def test_factored_residual_matches_the_dense_formula():
    """compute_residual never forms X: [A Z, Z, C] J [A Z, Z, C]^H through
    one thin QR; it equals ||A X + X A^H + C C^H|| / ||C C^H|| of the dense
    formula (the reference's) at n = 60: to 1e-12 relative for a Z far
    from the solution, to 1e-12 absolute for the solution itself (both
    residuals are rounding there)."""
    rng = np.random.default_rng(10)
    n = 60
    Ad = _stable(n)
    C1 = rng.standard_normal((n, 2))
    jl = JLME(jst.DenseOperator(Ad), ncv=30, tol=1e-9)
    tl = interop.lme_from_slepc_tpu(jl, device="cpu")
    Zr = rng.standard_normal((n, 5))
    rj, rt = jl.compute_residual(Zr, C1), tl.compute_residual(Zr, C1)
    assert rj > 1 and abs(rt - rj) <= 1e-12 * rj
    Z = tl.solve(C1)
    assert abs(tl.compute_residual(Z, C1)
               - jl.compute_residual(_np(Z), C1)) <= 1e-12
    Cc = C1 + 1j * rng.standard_normal((n, 2))
    Zc = Zr + 1j * rng.standard_normal((n, 5))
    Xc = Zc @ Zc.conj().T
    R = Ad @ Xc + Xc @ Ad.T + Cc @ Cc.conj().T
    want = np.linalg.norm(R) / np.linalg.norm(Cc @ Cc.conj().T)
    assert abs(tl.compute_residual(Zc, Cc) - want) <= 1e-12 * want


def test_complex_lyapunov_diverges_from_the_reference():
    """tests/test_modules.py:182's case made complex: A + 0.3i
    diag(linspace(-1, 1, 60)), complex C.  The reference's Re(Y) factor
    leaves a relative residual near 6e-4 at tol 1e-9; the port's
    Hermitian symmetrization solves it to 1e-12."""
    rng = np.random.default_rng(10)
    n = 60
    Ad = _stable(n) + 0.3j * np.diag(np.linspace(-1, 1, n))
    C1 = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    Zj, Zt, lme = _both(JLME(jst.DenseOperator(Ad), ncv=30, tol=1e-9), C1)
    rj = JLME(jst.DenseOperator(Ad)).compute_residual(Zj, C1)
    rt = lme.compute_residual(Zt, C1)
    assert 1e-4 < rj < 1e-2
    assert rt <= 1e-12
    Xt = _np(Zt @ Zt.mH)
    np.testing.assert_allclose(Xt, sla.solve_continuous_lyapunov(
        Ad, -C1 @ C1.conj().T), atol=1e-10)


def test_lme_sylvester_dense():
    """tests/test_modules.py:198 (the dense kernel below 600 rows)."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((20, 20)) - 3 * np.eye(20)
    B = rng.standard_normal((15, 15)) + 3 * np.eye(15)
    C = rng.standard_normal((20, 15))
    Xj, Xt, _ = _both(JLME(jst.DenseOperator(A), B=jst.DenseOperator(B),
                           problem_type="sylvester"), C)
    assert isinstance(Xt, torch.Tensor)
    assert _rel(Xt, Xj) < 1e-12
    np.testing.assert_allclose(A @ _np(Xt) + _np(Xt) @ B + C,
                               np.zeros_like(C), atol=1e-9)


def test_lme_gen_lyapunov():
    """tests/test_modules.py:209: A X E^T + E X A^T + C C^T = 0 through
    F = E^{-1} A (a direct KSP on E)."""
    rng = np.random.default_rng(0)
    n = 50
    Ad = -2 * np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    Ed = np.eye(n) + 0.1 * rng.standard_normal((n, n)) / np.sqrt(n)
    C1 = rng.standard_normal((n, 2))
    Zj, Zt, _ = _both(JLME(jst.DenseOperator(Ad), B=jst.DenseOperator(Ed),
                           problem_type="gen_lyapunov", ncv=40, tol=1e-10),
                      C1)
    X = _np(Zt @ Zt.T)
    assert _rel(X, Zj @ Zj.T) < 1e-10
    R = Ad @ X @ Ed.T + Ed @ X @ Ad.T + C1 @ C1.T
    assert np.linalg.norm(R) / np.linalg.norm(C1 @ C1.T) < 1e-8


def test_lme_sylvester_krylov():
    """tests/test_modules.py:227: two-sided Krylov Sylvester on CSR
    tridiagonals (700 and 650 rows; the adjoint through mult_h)."""
    rng = np.random.default_rng(0)
    n2, m2 = 700, 650
    A2 = sp.diags([-np.ones(n2 - 1), -3 * np.ones(n2), -np.ones(n2 - 1)],
                  [-1, 0, 1]).tocsr()
    B2 = sp.diags([np.ones(m2 - 1), 8 * np.ones(m2), np.ones(m2 - 1)],
                  [-1, 0, 1]).tocsr()
    c1 = rng.standard_normal((n2, 1))
    c2 = rng.standard_normal((m2, 1))
    (Lj, Rj), (L, R), lme = _both(JLME(jst.from_scipy(A2),
                                       B=jst.from_scipy(B2),
                                       problem_type="sylvester", ncv=40),
                                  c1, c2)
    assert type(lme.A).__name__ == "AIJOperator"
    X2 = _np(L @ R.T)
    assert _rel(X2, Lj @ Rj.T) < 1e-10
    Rres = A2 @ X2 + X2 @ B2.toarray() + c1 @ c2.T
    assert np.linalg.norm(Rres) / np.linalg.norm(c1 @ c2.T) < 1e-10


def test_lme_sylvester_krylov_large():
    """tests/test_round2.py:197: the Krylov route at 1,000 / 800 rows
    (DIA sums with the identity) against the dense residual, then
    matrix-free at 100,000 rows with the projected residual certified."""
    rng = np.random.default_rng(0)
    n, m = 1000, 800

    def ops(pkg, k, s):
        kw = {} if pkg is jst else {"device": "cpu"}
        dt = np.float64 if pkg is jst else torch.float64
        return pkg.laplacian_1d(k, **kw) + s * pkg.IdentityOperator(k, dt,
                                                                    **kw)

    c1 = rng.standard_normal(n)
    c2 = rng.standard_normal(m)
    jl = JLME(ops(jst, n, 2.0), B=ops(jst, m, 1.5), problem_type="sylvester",
              ncv=20, tol=1e-10)
    tl = tst.LME(ops(tst, n, 2.0), B=ops(tst, m, 1.5),
                 problem_type="sylvester", ncv=20, tol=1e-10)
    Lj, Rj = jl.solve(c1, c2)
    L, R = tl.solve(c1, c2)
    assert tl.its == jl.its
    X = _np(L @ R.mH)
    assert _rel(X, Lj @ Rj.conj().T) < 1e-10
    Ad = tl.A.to_dense().numpy()
    Bd = tl.B.to_dense().numpy()
    res = np.linalg.norm(Ad @ X + X @ Bd + np.outer(c1, c2))
    assert res / (np.linalg.norm(c1) * np.linalg.norm(c2)) < 1e-9

    n2 = 100000
    tl2 = tst.LME(ops(tst, n2, 2.0), B=ops(tst, n2, 1.5),
                  problem_type="sylvester", ncv=30, tol=1e-9)
    L2, R2 = tl2.solve(rng.standard_normal(n2), rng.standard_normal(n2))
    assert tl2.errest < 1e-9
    assert L2.shape == (n2, 30) and R2.shape == (n2, 30)


def test_lme_stein_krylov():
    """tests/test_round2.py:227: A X A^H - X + c c^H = 0 at 2,000 rows
    (DIA), the Krylov route."""
    rng = np.random.default_rng(1)
    n = 2000
    c = rng.standard_normal(n)
    Zj, Z, lme = _both(JLME(0.2 * jst.laplacian_1d(n), problem_type="stein",
                            ncv=24, tol=1e-10), c)
    assert lme.errest < 1e-10
    assert _rel(Z @ Z.T, Zj @ Zj.T) < 1e-10
    AZ = _np(torch.stack([lme.A.mult(z) for z in Z.T.contiguous()]).T)
    Zn = _np(Z)
    Rm = AZ @ AZ.T - Zn @ Zn.T + np.outer(c, c)
    assert np.linalg.norm(Rm) / np.linalg.norm(np.outer(c, c)) < 1e-9
