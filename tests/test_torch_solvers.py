"""The solvers power, subspace, arnoldi, lanczos and lapack of
slepc_tpu_torch against slepc_tpu's, on the CPU.

The problems of tests/test_eps_solvers.py, one parametrised test per
problem over the solvers the reference runs on it: both packages get the
same operator and start vectors, so iteration counts agree and eigenvalues
agree to 1e-9 (the light Lanczos reorthogonalizations lose orthogonality by
design, so there the trajectories may part by a few restarts and only the
eigenvalues are held).  Subspace iteration also runs with ncv = 20 on a DIA
operator, whose block apply goes through ``mult_block`` in chunks of 8.
"""

import numpy as np
import pytest
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop


def _gapped(n=120, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = 3.0 * 0.8 ** np.arange(n)
    return (Q * w) @ Q.T, np.sort(w)[::-1]


def _both(make_op, configure=None, same_its=True, **kw):
    out = []
    for pkg in (jst, tst):
        A = make_op()
        if pkg is tst:
            A = interop.operator_from_slepc_tpu(A, device="cpu")
        eps = pkg.EPS(A, options=pkg.Options(), **kw)
        if configure is not None:
            configure(eps)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv
    if same_its:
        assert te.its == je.its
    k = te.nconv
    np.testing.assert_allclose(te.eigenvalues[:k], je.eigenvalues[:k],
                               rtol=0, atol=1e-9)
    assert te._eigenvectors.shape[1] == A.shape[0]
    return je, te


@pytest.mark.parametrize("solver", ["krylovschur", "arnoldi", "lanczos",
                                    "lapack", "subspace"])
def test_hep_largest(solver):
    n = 120
    exact = tst.laplacian_1d_eigs(n)
    _, te = _both(lambda: jst.laplacian_1d(n), problem_type="hep",
                  which="largest_real", nev=4, solver=solver, ncv=30,
                  max_it=300 if solver == "subspace" else None)
    if solver != "subspace":  # subspace converges slowly on this spectrum
        assert te.nconv >= 4
        np.testing.assert_allclose(np.sort(te.eigenvalues[:4])[::-1],
                                   exact[::-1][:4], rtol=1e-6)
        assert max(te.compute_error(i) for i in range(4)) < 1e-7


@pytest.mark.parametrize("form", ["dense", "dia"])
def test_hep_subspace(form):
    if form == "dense":
        Ad, exact = _gapped()
        make, ncv, nev = (lambda: jst.DenseOperator(Ad)), 16, 3
    else:  # ncv 20 > 8: the block apply is K5 in chunks on the card
        make, ncv, nev = (lambda: jst.laplacian_2d(12, 10)), 20, 2
        exact = np.sort(tst.laplacian_2d_eigs(12, 10))[::-1]
    _, te = _both(make, problem_type="hep", which="largest_real", nev=nev,
                  solver="subspace", ncv=ncv, max_it=500)
    assert te.nconv >= nev
    np.testing.assert_allclose(np.sort(te.eigenvalues[:nev])[::-1],
                               exact[:nev], rtol=1e-6)


@pytest.mark.parametrize("case", ["largest", "inverse", "rayleigh",
                                  "wilkinson"])
def test_power(case):
    """'wilkinson' runs as the constant shift, as in the reference: the
    same iteration count."""
    if case == "largest":
        Ad, exact = _gapped(80)
        _, te = _both(lambda: jst.DenseOperator(Ad), problem_type="hep",
                      which="largest_magnitude", nev=2, solver="power",
                      max_it=5000, tol=1e-9)
        np.testing.assert_allclose(np.sort(te.eigenvalues[:2])[::-1],
                                   exact[:2], rtol=1e-6)
        return
    exact = tst.laplacian_1d_eigs(80)

    def configure(eps):
        eps.set_target(1.01)
        if case in ("rayleigh", "wilkinson"):
            eps.power_shift_type = case
    _, te = _both(lambda: jst.laplacian_1d(80), configure, problem_type="hep",
                  nev=1, solver="power", max_it=2000)
    assert te.nconv >= 1 and te.st.name == "sinvert"
    want = exact[np.argmin(np.abs(exact - 1.01))]
    np.testing.assert_allclose(te.eigenvalues[0], want, rtol=1e-7)


def test_power_chunks_read_the_host_once_per_check():
    """The constant-shift loop reads theta, the residual norm and the
    breakdown flag once per chunk: its counts in multiples of the chunk."""
    Ad, _ = _gapped(80)
    for chunk in (16, 1):
        eps = tst.EPS(tst.DenseOperator(Ad, device="cpu"), problem_type="hep",
                      nev=1, solver="power", max_it=5000, tol=1e-9,
                      options=tst.Options())
        eps.power_chunk = chunk
        eps.solve()
        assert eps.nconv == 1 and (chunk == 1 or eps.its % chunk == 0)


def test_power_nonlinear_spi():
    n = 80
    g = 0.5

    def run(pkg, A0d):
        def A_of_x(x):
            xa = np.asarray(x.cpu() if torch.is_tensor(x) else x)
            M = A0d + g * np.diag(np.abs(xa) ** 2)
            return pkg.DenseOperator(M) if pkg is jst else \
                pkg.DenseOperator(M, device="cpu")
        A0 = pkg.laplacian_1d(n) if pkg is jst else \
            pkg.laplacian_1d(n, device="cpu")
        eps = pkg.EPS(A0, problem_type="hep", nev=1)
        eps.set_tolerances(tol=1e-9, max_it=200)
        eps.set_power_nonlinear(A_of_x)
        eps.solve()
        return eps

    A0d = np.asarray(jst.laplacian_1d(n).to_dense())
    je, te = run(jst, A0d), run(tst, A0d)
    assert te.nconv == je.nconv == 1 and te.its == je.its
    np.testing.assert_allclose(te.eigenvalues[0], je.eigenvalues[0].real,
                               rtol=1e-10)
    lam, x = te.get_eigenpair(0)
    xn = x.numpy()
    r = (A0d + g * np.diag(np.abs(xn) ** 2)) @ xn - lam * xn
    assert np.linalg.norm(r) < 1e-7


@pytest.mark.parametrize("solver", ["krylovschur", "arnoldi", "lapack"])
def test_nhep(solver):
    rng = np.random.default_rng(1)
    n = 80
    Ad = rng.standard_normal((n, n)) / np.sqrt(n)
    w = np.linalg.eigvals(Ad)
    _, te = _both(lambda: jst.DenseOperator(Ad), problem_type="nhep",
                  which="largest_magnitude", nev=3, solver=solver, ncv=30)
    assert te.nconv >= 3
    for lam in te.eigenvalues[:3]:
        assert np.min(np.abs(w - lam)) < 1e-8
    # eigenvectors, complex for a conjugate pair (the reference's arnoldi
    # returns its Schur vectors here)
    for i in range(3):
        assert te.compute_error(i) < 1e-7


@pytest.mark.parametrize("mode", ["local", "selective", "periodic"])
def test_lanczos_light_reorthogonalization(mode):
    exact = tst.laplacian_1d_eigs(120)
    _, te = _both(lambda: jst.laplacian_1d(120),
                  lambda eps: eps.set_reorthogonalization(mode),
                  same_its=mode == "selective", problem_type="hep",
                  which="largest_real", nev=4, solver="lanczos", ncv=30)
    assert te.nconv >= 4
    np.testing.assert_allclose(np.sort(te.eigenvalues[:4])[::-1],
                               exact[::-1][:4], rtol=1e-6)


def test_ghep_lapack_and_arnoldi():
    rng = np.random.default_rng(5)
    n = 60
    Ad = rng.standard_normal((n, n))
    Ad = 0.5 * (Ad + Ad.T)
    Bd = rng.standard_normal((n, n)) / np.sqrt(n)
    Bd = Bd @ Bd.T + 0.1 * n * np.eye(n)
    import scipy.linalg as sla

    exact = sla.eigh(Ad, Bd, eigvals_only=True)[::-1]
    for solver in ("lapack", "arnoldi"):
        out = []
        for pkg in (jst, tst):
            kw = {} if pkg is jst else {"device": "cpu"}
            eps = pkg.EPS(pkg.DenseOperator(Ad, **kw),
                          pkg.DenseOperator(Bd, **kw), problem_type="ghep",
                          which="largest_real", nev=3, ncv=30, solver=solver)
            eps.solve()
            out.append(eps)
        je, te = out
        assert te.nconv == je.nconv >= 3 and te.its == je.its
        np.testing.assert_allclose(te.eigenvalues[:3], exact[:3], rtol=1e-8)
        assert max(te.compute_error(i) for i in range(3)) < 1e-7
