"""The NEP module of slepc_tpu_torch (``nep/nep.py``) against slepc_tpu's,
on the CPU.

Both packages solve the same numpy problems (the port's NEP built from the
reference's by ``interop.nep_from_slepc_tpu`` in split form; a callback
problem is built in each package from the same arrays): the 40-row delay
problem of tests/test_modules.py:137 by ``slp``, ``rii`` and ``narnoldi``
(target 0.1) and ``interpol``; ``ciss`` with ``set_two_sided`` and
``apply_resolvent`` (tests/test_modules_advanced.py:115); Effenberger's
deflation on a double eigenvalue (:242); ``refine``; the callback form
with and without a Jacobian; src/nep/tests/test10.c's published digits
(tests/test_reference_golden.py:130, 128-row DIA).  Each is held to the
reference: the same nconv, the same its (both start from
``default_rng(0)``), values within 1e-9, residuals within the reference
test's bound.  ``test_narnoldi_runs_off_the_region`` holds the
reference-side fault of ``DSNEP.solve_slp`` (ROADMAP.md, queue 3) beside
the port's outcome.  The NLEIGS cases are in tests/test_torch_nep_nleigs.py.
"""

import jax
import numpy as np
import pytest
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """Drop the reference's jit caches when the module starts and ends, and
    compile its ops with XLA's optimizations off while it runs (the
    reference compiles an op for every shape its subspaces take)."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)
    jax.clear_caches()


def _delay_arrays(n=40, tau=1.0):
    """tests/test_modules.py:137: T(lam) = -lam I + A0 + exp(-tau lam) A1."""
    h = np.pi / (n + 1)
    A0 = (np.diag(np.full(n, -2.0)) + np.diag(np.ones(n - 1), 1)
          + np.diag(np.ones(n - 1), -1)) / (h * h)
    xi = np.arange(1, n + 1) * h
    return -np.eye(n), A0, np.diag(4.1 - xi * (1 - np.exp(xi - np.pi)))


def _delay_fns(pkg, tau=1.0):
    fns = [pkg.FNRational([1.0, 0.0]), pkg.FNRational([1.0]), pkg.FNExp()]
    fns[2].set_scale(-tau)
    return fns


def _delay_nep(n=40, **kw):
    """The reference's split-form delay NEP and the port's copy of it."""
    jnep = jst.NEP(**kw)
    jnep.set_split_operators([jst.DenseOperator(M) for M in _delay_arrays(n)],
                             _delay_fns(jst))
    return jnep


def _both(jnep):
    tnep = interop.nep_from_slepc_tpu(jnep, device="cpu")
    jnep.solve()
    tnep.solve()
    return jnep, tnep


def _true_residual(mats, fns, lam, x):
    T = sum(complex(f.eval(lam)) * M for M, f in zip(mats, fns))
    x = np.asarray(x)
    return np.linalg.norm(T @ x) / np.linalg.norm(x)


def _same(jnep, tnep, k=None, its=True):
    """Same nconv (and its), the first k values within 1e-9."""
    assert tnep.nconv == jnep.nconv
    if its:
        assert tnep.its == jnep.its
    k = jnep.nconv if k is None else k
    np.testing.assert_allclose(np.asarray(tnep.eigenvalues[:k], complex),
                               np.asarray(jnep.eigenvalues[:k], complex),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("solver", ["slp", "rii", "narnoldi"])
def test_newton_solvers_match_the_reference(solver):
    """tests/test_modules.py:137 in both packages: the same pair, found in
    the same number of steps, residual below the reference test's 1e-8.
    RII's step count is not held: its first step is x - T(sigma)^{-1}
    T(lam) x at lam = sigma, zero in exact arithmetic, so the iteration
    starts from rounding noise and its count follows the rounding
    (ROADMAP.md, queue 3)."""
    jnep, tnep = _both(_delay_nep(nev=1, solver=solver, target=0.1))
    _same(jnep, tnep, its=solver != "rii")
    assert tnep.nconv >= 1
    lam, x = tnep.get_eigenpair(0)
    assert isinstance(x, torch.Tensor) and x.shape == (40,)
    assert _true_residual(_delay_arrays(), _delay_fns(tst), complex(lam),
                          x.numpy()) < 1e-8
    assert tnep.compute_error(0) == pytest.approx(
        jnep.compute_error(0), rel=0.5, abs=1e-12)


def test_interpol_matches_the_reference():
    """tests/test_modules.py:150: the Chebyshev fit into the port's PEP
    (linear), two values."""
    jnep, tnep = _both(_delay_nep(nev=2, solver="interpol", target=0.1))
    _same(jnep, tnep)
    assert tnep.nconv >= 1
    lam, x = tnep.get_eigenpair(0)
    assert _true_residual(_delay_arrays(), _delay_fns(tst), complex(lam),
                          x.numpy()) < 1e-6


def test_ciss_two_sided_and_resolvent_match_the_reference():
    """tests/test_modules_advanced.py:115: ciss in the ellipse with left
    vectors, and the resolvent near the first pole, in both packages."""
    jnep = _delay_nep(nev=2, solver="ciss", target=-1.0, tol=1e-10)
    jnep.set_rg(jst.RGEllipse(center=-1.0, radius=1.5, vscale=0.5))
    jnep.set_two_sided()
    jnep, tnep = _both(jnep)
    _same(jnep, tnep)
    assert tnep.nconv >= 2
    mats, fns = _delay_arrays(), _delay_fns(tst)
    for i in range(tnep.nconv):
        lam, x = tnep.get_eigenpair(i)
        assert _true_residual(mats, fns, complex(lam), x.numpy()) < 1e-8
    lam0, x0 = tnep.get_eigenpair(0)
    y0 = tnep.get_left_eigenvector(0).numpy()
    T = sum(complex(f.eval(lam0)) * M for M, f in zip(mats, fns))
    assert np.linalg.norm(y0.conj() @ T) / np.linalg.norm(y0) < 1e-8
    yj = np.asarray(jnep.get_left_eigenvector(0))
    assert 1 - abs(np.vdot(yj, y0)) / (np.linalg.norm(yj)
                                       * np.linalg.norm(y0)) < 1e-8
    v = np.random.default_rng(0).standard_normal(40)
    Rv = tnep.apply_resolvent(complex(lam0) + 1e-4, v).numpy()
    x0 = x0.numpy()
    c = np.abs(np.vdot(x0, Rv)) / (np.linalg.norm(Rv) * np.linalg.norm(x0))
    assert c > 0.99
    Rj = np.asarray(jnep.apply_resolvent(complex(lam0) + 1e-4, v))
    np.testing.assert_allclose(Rv, Rj, rtol=0, atol=1e-8 * np.abs(Rj).max())


def test_effenberger_deflation_finds_a_double_eigenvalue():
    """tests/test_modules_advanced.py:242: SLP with Effenberger deflation
    finds both vectors of a double eigenvalue, as the reference does."""
    n = 20
    rng = np.random.default_rng(0)
    D = np.diag(np.concatenate([[2.0, 2.0], 4.0 + np.arange(n - 2.0)]))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    jnep = jst.NEP(nev=2, solver="slp", target=1.8, tol=1e-10, max_it=60)
    jnep.set_split_operators([jst.DenseOperator(Q @ D @ Q.T),
                              jst.DenseOperator(np.eye(n))],
                             [jst.FNRational([1.0]),
                              jst.FNRational([-1.0, 0.0])])
    jnep, tnep = _both(jnep)
    _same(jnep, tnep)
    assert tnep.nconv >= 2
    np.testing.assert_allclose(sorted(tnep.eigenvalues[:2].real), [2.0, 2.0],
                               atol=1e-8)
    X = tnep.get_eigenvectors()[:, :2].numpy()
    assert X.shape == (n, 2)
    assert np.linalg.svd(X, compute_uv=False)[1] > 1e-3


def test_refine_matches_the_reference():
    """NEPSetRefine's simple scheme: both packages refine the same
    perturbed pairs by the bordered Newton solve to the same pairs."""
    jnep, tnep = _both(_delay_nep(nev=1, solver="slp", target=0.1))
    for nep in (jnep, tnep):
        nep.eigenvalues = nep.eigenvalues.astype(complex) * (1 + 1e-6)
        nep.refine(steps=3)
    _same(jnep, tnep)
    assert tnep.errests[0] < 1e-10
    assert tnep.errests[0] == pytest.approx(jnep.errests[0], rel=0.5,
                                            abs=1e-12)


@pytest.mark.parametrize("jac", [True, False], ids=["jacobian", "difference"])
def test_callback_form_matches_the_reference(jac):
    """set_function (with and without a Jacobian: the reference's central
    difference) by SLP at 40 rows, each package's callbacks building its
    own operators from the same arrays; nep_from_slepc_tpu refuses to carry
    a callback problem."""
    mats = _delay_arrays()

    def callbacks(pkg, **kw):
        fns = _delay_fns(pkg)

        def T(lam):
            return pkg.DenseOperator(sum(complex(f.eval(lam)) * M
                                         for M, f in zip(mats, fns)), **kw)

        def Tp(lam):
            return pkg.DenseOperator(sum(complex(f.eval_deriv(lam)) * M
                                         for M, f in zip(mats, fns)), **kw)

        return T, (Tp if jac else None)

    jnep = jst.NEP(nev=1, solver="slp", target=0.1)
    jnep.set_function(*callbacks(jst))
    tnep = tst.NEP(nev=1, solver="slp", target=0.1)
    tnep.set_function(*callbacks(tst, device="cpu"))
    jnep.solve()
    tnep.solve()
    _same(jnep, tnep)
    assert tnep.nconv >= 1
    lam, x = tnep.get_eigenpair(0)
    assert _true_residual(mats, _delay_fns(tst), complex(lam),
                          x.numpy()) < 1e-8
    with pytest.raises(ValueError, match="callback-form NEP"):
        interop.nep_from_slepc_tpu(jnep, device="cpu")


def test_reference_test10_digits():
    """tests/test_reference_golden.py:130: src/nep/tests/test10.c's value
    0.80889 (128-row DIA, tau 0.001, a = 20) by SLP at target 0.55, in
    both packages."""
    n, tau, a = 128, 0.001, 20.0
    h = np.pi / (n + 1)
    up = np.zeros(n)
    up[: n - 1] = 1.0 / (h * h)
    lo = np.zeros(n)
    lo[1:] = 1.0 / (h * h)
    xi = (np.arange(n) + 1) * h
    b = -4.1 + xi * (1.0 - np.exp(xi - np.pi))
    f3 = jst.FNExp()
    f3.set_scale(-tau, 1.0)
    jnep = jst.NEP(nev=1, solver="slp", target=0.55, tol=1e-9)
    jnep.set_split_operators(
        [jst.DIAOperator((0,), np.ones((1, n))),
         jst.DIAOperator((-1, 0, 1),
                         np.stack([lo, np.full(n, -2.0 / (h * h) + a), up])),
         jst.DIAOperator((0,), b[None, :])],
        [jst.FNRational([-1.0, 0.0]), jst.FNRational([1.0]), f3])
    jnep, tnep = _both(jnep)
    assert all(type(m).__name__ == "DIAOperator" for m in tnep.split_A)
    _same(jnep, tnep)
    lam = tnep.eigenvalues[0]
    assert f"{lam.real:.5f}" == "0.80889", lam
    assert abs(lam.imag) < 1e-6


def test_narnoldi_runs_off_the_region():
    """ROADMAP.md queue 3, a reference-side fault: DSNEP.solve_slp's Newton
    step has no guard, so narnoldi on the delay problem at target -1
    returns -5.4898534 at 40 rows (outside RGEllipse(-1, 1.5, 0.5)) and at
    200 rows lets lambda run off until exp(-lambda) overflows, where the
    dense eig raises ValueError.  The port copies solve_slp as it is and
    does the same."""
    n = 200
    h = np.pi / (n + 1)
    up = np.zeros(n)
    up[: n - 1] = 1.0 / (h * h)
    lo = np.zeros(n)
    lo[1:] = 1.0 / (h * h)
    xi = np.arange(1, n + 1) * h
    jnep = jst.NEP(nev=1, solver="narnoldi", target=-1.0, tol=1e-8)
    jnep.set_split_operators(
        [jst.DIAOperator((0,), -np.ones((1, n))),
         jst.DIAOperator((-1, 0, 1), np.stack([lo, np.full(n, -2 / (h * h)),
                                               up])),
         jst.DIAOperator((0,), (4.1 - xi * (1 - np.exp(xi - np.pi)))[None])],
        _delay_fns(jst))
    tnep = interop.nep_from_slepc_tpu(jnep, device="cpu")
    for nep in (jnep, tnep):
        with np.errstate(over="ignore", invalid="ignore"), \
                pytest.raises(ValueError, match="infs or NaNs"):
            nep.solve()
        assert nep.its == 1
    jnep, tnep = _both(_delay_nep(nev=1, solver="narnoldi", target=-1.0,
                                  tol=1e-8))
    _same(jnep, tnep)
    rg = tst.RGEllipse(center=-1.0, radius=1.5, vscale=0.5)
    assert abs(tnep.eigenvalues[0] + 5.4898534) < 1e-6
    assert rg.check_inside(tnep.eigenvalues[0]) < 0


def test_options_and_exports():
    """-nep_* options reach the port's NEP (tests/test_round2.py:329), the
    package exports NEP and DSNEP under the reference's names, and a split
    form with more matrices than functions is refused."""
    try:
        tst.set_global_options("-nep_nev 2 -nep_type rii -nep_tol 1e-7 "
                               "-nep_max_it 30 -nep_two_sided "
                               "-nep_nleigs_full_basis")
        nep = tst.NEP()
        assert (nep.nev, nep.solver, nep.tol, nep.max_it) == (2, "rii", 1e-7,
                                                              30)
        assert nep.two_sided and nep.nleigs_full_basis
    finally:
        tst.set_global_options({})
    assert tst.NEP().nev == 1
    for name in ("NEP", "DSNEP"):
        assert name in tst.__all__ and hasattr(tst, name)
    assert tst.DSNEP is tst.ds.DSNEP
    with pytest.raises(ValueError, match="3 matrices and 2 functions"):
        tst.NEP().set_split_operators(
            [tst.DenseOperator(M, device="cpu") for M in _delay_arrays(4)],
            _delay_fns(tst)[:2])
