"""The FN module of slepc_tpu_torch (``fn/fn.py``, the port's own copy of
slepc_tpu's host functions) against slepc_tpu's, on the CPU.

Each reference case has a twin here, both packages fed the same numpy
matrices: tests/test_classes.py:254 (scalar and matrix exp, sqrt, log,
inverse sqrt, phi, rational), :512 (every FNExp method on a non-normal
matrix), :538 (every FNSqrt iteration), :552 (``FN("exp")`` dispatch).
Besides: FNCombine's four operations, derivatives, the scale convention
beta f(alpha x), and ``interop.fn_from_slepc_tpu``.

Tolerances: the port runs the same numpy / scipy code on the same inputs,
so the port and the reference agree to 1e-13 relative (1e-12 for the
iterative square roots); each is held to the reference test's own bound
against scipy.
"""

import jax
import numpy as np
import pytest
import scipy.linalg as sla

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """Drop the reference's jit caches when the module starts and ends
    (they keep operators of earlier modules alive and can raise on a new
    operator of the same shape)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(
        np.linalg.norm(np.asarray(b)), 1e-300)


def _spd(n=8, seed=13):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / 3
    return A, A @ A.T + 2 * np.eye(n)


def test_fn_scalar_and_matrix_match_the_reference():
    """tests/test_classes.py:254: exp (scipy and own Pade, scaled), sqrt
    (Schur and Denman-Beavers), log, inverse sqrt, each against the
    reference's value and scipy's."""
    A, Aspd = _spd()
    fj, ft = jst.FNExp(), tst.FNExp()
    assert abs(ft.eval(0.3) - np.exp(0.3)) < 1e-14
    assert _rel(ft.eval_mat(A), fj.eval_mat(A)) < 1e-13
    np.testing.assert_allclose(ft.eval_mat(A), sla.expm(A), atol=1e-12)
    for f in (fj, ft):
        f.set_method(1)  # own Pade
    assert _rel(ft.eval_mat(A), fj.eval_mat(A)) < 1e-13
    for f in (fj, ft):
        f.set_scale(0.5, 2.0)  # beta*f(alpha*x): 2*exp(0.5x)
    np.testing.assert_allclose(ft.eval_mat(A), 2 * sla.expm(0.5 * A),
                               atol=1e-10)
    assert _rel(ft.eval_mat(A), fj.eval_mat(A)) < 1e-13
    for name, meth, ref in (("FNSqrt", 0, None), ("FNSqrt", 1, None),
                            ("FNLog", 0, sla.logm(Aspd)),
                            ("FNInvSqrt", 0, None), ("FNInvSqrt", 1, None)):
        fj, ft = getattr(jst, name)(), getattr(tst, name)()
        fj.set_method(meth)
        ft.set_method(meth)
        Fj, Ft = fj.eval_mat(Aspd), ft.eval_mat(Aspd)
        assert _rel(Ft, Fj) < 1e-12, (name, meth)
        if name == "FNSqrt":
            np.testing.assert_allclose(Ft @ Ft, Aspd, atol=1e-9)
        elif name == "FNInvSqrt":
            np.testing.assert_allclose(Ft @ Ft @ Aspd, np.eye(8), atol=1e-9)
        else:
            np.testing.assert_allclose(Ft, ref, atol=1e-9)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_fn_phi_and_rational_match_the_reference(k):
    """phi_k (scalar Taylor / recurrence, matrix by the augmented
    exponential) and a rational p/q, values and derivatives."""
    A, _ = _spd(6, seed=4)
    x = np.array([1e-5, 0.3, -1.2, 2.0 + 0.5j])
    fj, ft = jst.FNPhi(k), tst.FNPhi(k)
    np.testing.assert_allclose(ft.eval(x), fj.eval(x), rtol=1e-14)
    np.testing.assert_allclose(ft.eval_deriv(x), fj.eval_deriv(x),
                               rtol=1e-12)
    assert _rel(ft.eval_mat(A), fj.eval_mat(A)) < 1e-13
    num, den = [1.0, -2.0, 0.5][: k + 1], [1.0, 3.0]
    fj, ft = jst.FNRational(num, den), tst.FNRational(num, den)
    np.testing.assert_allclose(ft.eval(x), fj.eval(x), rtol=1e-14)
    np.testing.assert_allclose(ft.eval_deriv(x), fj.eval_deriv(x),
                               rtol=1e-14)
    assert _rel(ft.eval_mat(A), fj.eval_mat(A)) < 1e-13


@pytest.mark.parametrize("op", ["add", "multiply", "divide", "compose"])
def test_fn_combine_matches_the_reference(op):
    A, Aspd = _spd(6, seed=5)
    out = []
    for pkg in (jst, tst):
        f1, f2 = pkg.FNExp(), pkg.FNSqrt()
        f2.set_scale(1.0, 0.5)
        f = pkg.FNCombine(op, f1, f2)
        out.append((f.eval(0.7), f.eval_deriv(0.7), f.eval_mat(Aspd / 10)))
    for got, want in zip(out[1], out[0]):
        assert _rel(got, want) < 1e-13


def test_fn_exp_method_parity():
    """tests/test_classes.py:512: every FNExp method (scipy, own Pade,
    Hermitian eigendecomposition, subdiagonal Pade in partial-fraction and
    product form) on a non-normal matrix: against scipy expm at the
    reference test's bounds, and against the reference's own value."""
    rng = np.random.default_rng(0)
    n = 24
    A = np.diag(-np.linspace(0, 3, n)) \
        + np.triu(rng.standard_normal((n, n)), 1) * 4
    ref = sla.expm(A)
    for meth, tol in ((0, 1e-13), (1, 1e-13), (3, 1e-10), (4, 1e-12)):
        fj, ft = jst.FNExp(), tst.FNExp()
        fj.set_method(meth)
        ft.set_method(meth)
        Ft = ft.eval_mat(A)
        assert _rel(Ft, ref) < tol, meth
        assert _rel(Ft, fj.eval_mat(A)) < 1e-13, meth
    Ah = A + A.T
    fj, ft = jst.FNExp(), tst.FNExp()
    fj.set_method(2)
    ft.set_method(2)
    assert _rel(ft.eval_mat(Ah), sla.expm(Ah)) < 1e-12
    assert _rel(ft.eval_mat(Ah), fj.eval_mat(Ah)) < 1e-13


def test_fn_sqrt_method_parity():
    """tests/test_classes.py:538: every FNSqrt iteration (Schur,
    Denman-Beavers pair and product forms, Newton-Schulz, Sadeghi) gives
    F with F^2 = A, and the reference's F."""
    rng = np.random.default_rng(1)
    M = rng.standard_normal((20, 20))
    A = M @ M.T + 20 * np.eye(20)
    for meth in (0, 1, 2, 3, 4):
        fj, ft = jst.FNSqrt(), tst.FNSqrt()
        fj.set_method(meth)
        ft.set_method(meth)
        F = ft.eval_mat(A)
        assert _rel(F @ F, A) < 1e-11, meth
        assert _rel(F, fj.eval_mat(A)) < 1e-12, meth


def test_fn_string_dispatch():
    """tests/test_classes.py:552: FN('exp') constructs the registered
    subclass (slepc4py FNSetType role), in both packages."""
    for pkg in (jst, tst):
        assert isinstance(pkg.FN("exp"), pkg.FNExp)
        assert pkg.FN("phi", k=2).k == 2
        assert isinstance(pkg.FNExp(), pkg.FNExp)
        assert isinstance(pkg.fn_from_name("rational", [1.0, 0.0]),
                          pkg.FNRational)
    assert tst.FN("exp").__class__.__module__ == "slepc_tpu_torch.fn.fn"


def test_fn_from_slepc_tpu_carries_type_scales_and_parts():
    A, Aspd = _spd(6, seed=7)
    cases = [jst.FNExp(), jst.FNPhi(2), jst.FNRational([1.0, 2.0], [1.0, 0.5]),
             jst.FNCombine("compose", jst.FNLog(), jst.FNExp())]
    cases[0].set_scale(-0.3, 2.0)
    cases[0].set_method(4)
    for jf in cases:
        tf = interop.fn_from_slepc_tpu(jf)
        assert type(tf).__name__ == type(jf).__name__
        assert (tf.alpha, tf.beta, tf.method) == (jf.alpha, jf.beta,
                                                  jf.method)
        assert _rel(tf.eval_mat(Aspd / 10), jf.eval_mat(Aspd / 10)) < 1e-13
