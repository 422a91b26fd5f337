"""The Chebyshev amplifier and the whole EPS slice of slepc_tpu_torch against
slepc_tpu.

* ChebAmplifyOperator apply: the same operator, window and vector through
  both packages, relative 1e-12.
* The Chebyshev-amplified EPS (-eps_cheb_degree 60) on laplacian_2d(60, 60),
  f64, nev=8, ncv=24 (the tests/test_round5.py:407-433 case): both packages
  agree with the closed-form spectrum and with each other to 1e-10, and the
  port's true residuals are within 1e-8.
* A plain-path EPS solve (laplacian_2d(18, 17), nev=4, largest; the
  tests/test_eps_krylovschur.py:41-46 case): eigenvalues agree to 1e-10.

Each JAX reference runs once per module, in a fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slepc_tpu as jst
from slepc_tpu.st.cheb import ChebAmplifyOperator as JCheb
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop
from slepc_tpu_torch.st.cheb import ChebAmplifyOperator, gershgorin_upper

CHEB_OPTS = "-eps_cheb_degree 60"


def _cheb_eps(pkg):
    A = pkg.laplacian_2d(60, 60, **({"device": "cpu"} if pkg is tst else {}))
    eps = pkg.EPS(A, problem_type="hep", which="smallest_real", nev=8, ncv=24,
                  tol=1e-8, options=pkg.Options.from_cli(CHEB_OPTS))
    eps.solve()
    return eps


@pytest.fixture(scope="module")
def jax_cheb():
    eps = _cheb_eps(jst)
    return np.sort(np.asarray(eps.eigenvalues[:eps.nconv]).real)


@pytest.fixture(scope="module")
def jax_plain():
    eps = jst.EPS(jst.laplacian_2d(18, 17), problem_type="hep",
                  which="largest_real", nev=4)
    eps.solve()
    return np.sort(np.asarray(eps.eigenvalues[:4]).real)


def test_amplifier_apply_matches_reference():
    A = jst.laplacian_2d(30, 28)
    top = interop.dia_from_slepc_tpu(A, device="cpu")
    lo, hi, deg = 0.05, gershgorin_upper(top), 60
    assert hi == 8.0
    x = np.random.default_rng(4).standard_normal(A.shape[0])
    yj = np.asarray(JCheb(A, lo, hi, deg).mult(jnp.asarray(x)))
    yt = ChebAmplifyOperator(top, lo, hi, deg).mult(torch.from_numpy(x)).numpy()
    assert np.abs(yt - yj).max() / np.abs(yj).max() < 1e-12


def test_cheb_eps_slice_matches_reference_and_closed_form(jax_cheb):
    exact = tst.laplacian_2d_eigs(60, 60, k=8)
    eps = _cheb_eps(tst)
    assert eps.nconv >= 8 and len(jax_cheb) >= 8
    lam = np.sort(eps.eigenvalues[:8])
    assert np.abs(lam - exact).max() < 1e-10
    assert np.abs(jax_cheb[:8] - exact).max() < 1e-10
    assert np.abs(lam - jax_cheb[:8]).max() < 1e-10
    assert max(eps.compute_error(i) for i in range(8)) < 1e-8
    assert eps.cheb_stats["certs"] >= 1


def test_plain_eps_matches_reference(jax_plain):
    eps = tst.EPS(tst.laplacian_2d(18, 17, device="cpu"), problem_type="hep",
                  which="largest_real", nev=4)
    eps.solve()
    assert eps.nconv >= 4
    lam = np.sort(eps.eigenvalues[:4])
    assert np.abs(lam - jax_plain).max() < 1e-10
    exact = np.sort(tst.laplacian_2d_eigs(18, 17))[::-1][:4]
    assert np.abs(lam[::-1] - exact).max() < 1e-10
    lam0, x0 = eps.get_eigenpair(0)
    assert x0.shape == (18 * 17,) and eps.compute_error(0) < 1e-8


# GHIEP (no B: the identity metric, signature +1 throughout) and the
# two-sided variant (a Hermitian problem: the general loop, the left
# vectors a copy of the right ones) raised NotImplementedError until item
# 11d was ported; each now solves and is held against the reference (the
# same nconv and its, the values to 1e-10).  The ids are the ones the
# raising cases had.
@pytest.mark.parametrize("kw", [
    {"problem_type": "ghiep"},
    {"problem_type": "hep", "which": "largest_real", "cli": "-eps_two_sided"},
], ids=["kw0-item 11", "kw1-item 11"])
def test_ghiep_and_two_sided_paths_solve_as_the_reference(kw):
    kw = dict(kw)
    cli = kw.pop("cli", "")
    out = []
    for pkg in (jst, tst):
        A = pkg.laplacian_1d(20) if pkg is jst else \
            pkg.laplacian_1d(20, device="cpu")
        eps = pkg.EPS(A, nev=2, options=pkg.Options.from_cli(cli), **kw)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv >= 2 and te.its == je.its
    np.testing.assert_allclose(np.real(te.eigenvalues[:2]),
                               np.real(je.eigenvalues[:2]), rtol=0, atol=1e-10)
    exact = np.sort(tst.laplacian_1d_eigs(20))[::-1][:2]
    np.testing.assert_allclose(np.real(te.eigenvalues[:2]), exact, rtol=0,
                               atol=1e-10)
    if te.two_sided:
        for i in range(2):
            y = te.get_left_eigenvector(i)
            assert te.compute_error(i) < 1e-8
            assert torch.equal(y, te._eigenvectors[i])


@pytest.mark.parametrize("block", [1, 4])
def test_a_window_that_amplified_nothing_raises(block):
    # degree 450 on a small grid: the first window, clamped against
    # lambda_1 = 0, puts lo at 0.017, below lambda_1 = 0.2995, so nothing
    # is amplified and bulk rows get locked; the next window, clamped
    # against their Rayleigh quotient, amplifies lambda_1 past the range
    # bound.  The solve raises, naming the degree and the window (the
    # reference returns a short count, or nconv 0 at b = 4; the
    # laplacian_3d(30, 32, 34) case of ROADMAP.md shows the same)
    from slepc_tpu_torch.eps.cheb_accel import ks_cheb_smallest

    A = tst.laplacian_3d(8, 9, 10, device="cpu")
    with pytest.raises(tst.EPSError, match=r"degree 450 on the window "
                       r"\[[0-9.]+, 12\]") as err:
        ks_cheb_smallest(A, nev=3, tol=1e-8, ncv=12, degree=450,
                         keep_den=3, block=block)
    assert "amplified nothing" in str(err.value)
