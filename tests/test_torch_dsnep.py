"""DSNEP of slepc_tpu_torch (``ds/types.py``, a numpy copy) against
slepc_tpu's, on the CPU: the batched Beyn quadrature on
tests/test_round4.py:434's projected quadratic, and successive linear
problems on a projected delay problem, bit for bit."""

import numpy as np
import pytest

import slepc_tpu.ds.types as jds
import slepc_tpu_torch as tst


def _quadratic(k=6, seed=11):
    rng = np.random.default_rng(seed)
    A0, A1, A2 = (rng.standard_normal((k, k)) for _ in range(3))
    return (lambda lam: A0 + lam * A1 + lam * lam * A2,
            lambda lam: A1 + 2 * lam * A2, (A0, A1, A2))


def test_solve_contour_matches_the_reference():
    """tests/test_round4.py:434: the eigenvalues inside the circle, equal to
    the companion linearization's, and the same output as the
    reference's."""
    Tfun, _, (A0, A1, A2) = _quadratic()
    k = A0.shape[0]
    Z = np.zeros((2 * k, 2 * k), dtype=complex)
    Z[:k, k:] = np.eye(k)
    Z[k:, :k] = -np.linalg.solve(A2, A0)
    Z[k:, k:] = -np.linalg.solve(A2, A1)
    lam_all = np.linalg.eigvals(Z)
    center, radius = 0.0, 0.8
    lt, Xt = tst.DSNEP().solve_contour(Tfun, center, radius, npoints=64)
    lj, Xj = jds.DSNEP().solve_contour(Tfun, center, radius, npoints=64)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(Xt, Xj)
    inside = lam_all[np.abs(lam_all - center) < radius * 0.95]
    got = np.sort_complex(lt[np.abs(lt - center) < radius * 0.95])
    assert got.size == inside.size
    assert np.abs(got - np.sort_complex(inside)).max() < 1e-8
    for mu, x in zip(lt, Xt.T):
        if abs(mu - center) < radius * 0.95:
            assert np.linalg.norm(Tfun(mu) @ x) < 1e-7


@pytest.mark.parametrize("lam0", [0.1, -0.3 + 0.2j])
def test_solve_slp_matches_the_reference(lam0):
    """Successive linear problems from the same start: the same value and
    vector as the reference's, and a root of the projected problem."""
    Tfun, Jfun, _ = _quadratic()
    lt, xt = tst.DSNEP().solve_slp(Tfun, Jfun, lam0)
    lj, xj = jds.DSNEP().solve_slp(Tfun, Jfun, lam0)
    assert lt == lj
    np.testing.assert_array_equal(xt, xj)
    assert np.linalg.norm(Tfun(lt) @ xt) < 1e-10
    assert tst.DS.create("nep").__class__ is tst.DSNEP
