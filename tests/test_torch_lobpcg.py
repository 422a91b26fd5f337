"""LOBPCG and RQCG of slepc_tpu_torch (and GD / JD on the same problem)
against slepc_tpu's, on the CPU.

The problem of tests/test_eps_solvers.py:15 (``_sym_problem(100)``, the
1-D Laplacian): lobpcg, gd and jd under ``STPrecond`` (nev 3, ncv 30, tol
1e-7) and rqcg (nev 2, tol 1e-6), as the reference's own tests run them;
plus LOBPCG's chunk path (no preconditioner), smallest and largest.  Both
packages get the same operator and start from numpy's ``default_rng(0)``.

Held: nconv equal, eigenvalues within 1e-9 of each other (and of the
closed form at the reference tests' tolerances).  ``its`` equal for the
LOBPCG host loop, GD (the GD cycle) and JD.  Not for two paths, stated:
  * RQCG: nonlinear CG amplifies rounding (the two packages' Rayleigh
    quotients part by 1e-12 at step 100 and at the solution's level by
    step 500 on this problem), so the step counts differ by a few percent;
  * LOBPCG's chunk: near the residual floor (1e-10 relative on this
    problem) the reference's Rayleigh-Ritz with its (1/eps)^1.5 penalty
    stalls where the port, which leaves the null directions out, keeps
    converging, so the chunk counts may differ by one chunk (8 steps).
"""

import numpy as np
import pytest
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
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


def _both(make, configure=None, **kw):
    out = []
    for pkg in (jst, tst):
        A = make()
        if pkg is tst:
            A = interop.operator_from_slepc_tpu(A, device="cpu")
        eps = pkg.EPS(A, options=pkg.Options(), **kw)
        if configure is not None:
            configure(eps, pkg, A)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv
    k = te.nconv
    np.testing.assert_allclose(np.sort(te.eigenvalues[:k]),
                               np.sort(np.real(je.eigenvalues[:k])),
                               rtol=0, atol=1e-9)
    assert te._eigenvectors.shape == (k, A.shape[0])
    return je, te


def _precond(eps, pkg, A):
    eps.set_st(pkg.STPrecond([A.shifted(0.0)]))


@pytest.mark.parametrize("solver", ["lobpcg", "gd", "jd"])
def test_precond_solvers_smallest(solver):
    """tests/test_eps_solvers.py:52 on both packages."""
    n = 100
    exact = tst.laplacian_1d_eigs(n)
    je, te = _both(lambda: jst.laplacian_1d(n), _precond,
                   problem_type="hep", which="smallest_real", nev=3,
                   solver=solver, ncv=30, max_it=3000, tol=1e-7)
    assert te.nconv >= 3 and te.its == je.its
    assert te.expansions == je.expansions
    np.testing.assert_allclose(np.sort(te.eigenvalues[:3]), exact[:3],
                               rtol=1e-5)
    assert max(te.compute_error(i) for i in range(3)) < 1e-6


def test_rqcg_smallest():
    """tests/test_eps_solvers.py:67 on both packages (its: see the module
    docstring)."""
    n = 100
    exact = tst.laplacian_1d_eigs(n)
    je, te = _both(lambda: jst.laplacian_1d(n), problem_type="hep",
                   which="smallest_real", nev=2, solver="rqcg",
                   max_it=6000, tol=1e-6)
    assert te.nconv >= 2
    assert abs(te.its - je.its) <= 0.1 * je.its
    np.testing.assert_allclose(np.sort(te.eigenvalues[:2]), exact[:2],
                               rtol=1e-3)
    # the estimate is the residual deflated against the locked vectors, so
    # the true residual of a later pair may sit a little above tol
    assert max(te.compute_error(i) for i in range(2)) < 1e-5


@pytest.mark.parametrize("which", ["smallest_real", "largest_real"])
def test_lobpcg_chunk(which):
    """The chunk path (no preconditioner, DIA operator): ``lobpcg_chunk``
    steps between host reads (its: see the module docstring)."""
    n = 100
    exact = tst.laplacian_1d_eigs(n)
    want = exact[:3] if which == "smallest_real" else exact[::-1][:3]
    je, te = _both(lambda: jst.laplacian_1d(n), problem_type="hep",
                   which=which, nev=3, solver="lobpcg", max_it=3000,
                   tol=1e-7)
    assert te.nconv >= 3 and abs(te.its - je.its) <= 8
    assert te.its % 8 == 0
    np.testing.assert_allclose(np.sort(te.eigenvalues[:3]), np.sort(want),
                               rtol=1e-6)


def test_lobpcg_generalized_host_loop():
    """A generalized problem (diagonal SPD B) takes the host loop with the
    B-orthonormalization; both packages walk the same steps."""
    n = 80
    rng = np.random.default_rng(4)
    bd = 1.0 + rng.random(n)
    Ad = jst.laplacian_1d(n).to_scipy().toarray()
    out = []
    for pkg in (jst, tst):
        kw = {} if pkg is jst else {"device": "cpu"}
        eps = pkg.EPS(pkg.DenseOperator(Ad, **kw),
                      pkg.DenseOperator(np.diag(bd), **kw), problem_type="ghep",
                      which="smallest_real", nev=3, solver="lobpcg",
                      max_it=3000, tol=1e-8, options=pkg.Options())
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv >= 3 and te.its == je.its
    np.testing.assert_allclose(te.eigenvalues[:3], je.eigenvalues[:3],
                               rtol=0, atol=1e-9)
    import scipy.linalg as sla

    want = sla.eigh(Ad, np.diag(bd), eigvals_only=True)[:3]
    np.testing.assert_allclose(np.sort(te.eigenvalues[:3]), want, rtol=1e-7)


@pytest.mark.parametrize("kw,match", [
    (dict(problem_type="nhep", which="smallest_real"), "Hermitian"),
    (dict(problem_type="hep", which="largest_real"), "smallest"),
])
def test_rqcg_refuses_what_the_reference_refuses(kw, match):
    for pkg in (jst, tst):
        A = jst.laplacian_1d(20) if pkg is jst \
            else tst.laplacian_1d(20, device="cpu")
        with pytest.raises(ValueError, match=match):
            pkg.EPS(A, solver="rqcg", options=pkg.Options(), **kw).solve()


def test_lobpcg_refuses_a_non_hermitian_problem():
    with pytest.raises(ValueError, match="Hermitian"):
        tst.EPS(tst.laplacian_1d(20, device="cpu"), problem_type="nhep",
                solver="lobpcg", options=tst.Options()).solve()
