"""The two-sided Krylov-Schur of slepc_tpu_torch (``eps/ks_twosided.py``),
its dual run (``EPS._solve_left``) and the adjoint DIA route
(``DIAOperator.mult_h``) against slepc_tpu's, on the CPU.

Both packages get the same operators and the same start vectors
(``default_rng(0)``, V's then W's), so they walk one trajectory: the same
nconv and its, the values within 1e-10, the left vectors within an angle of
1e-8 of the reference's (matched by value: a conjugate pair's two members
tie in the best-first order, and rounding decides which comes first).  The
left residuals ||A^H y - conj(lambda) y|| are held at the reference test's
1e-6 (tests/test_eps_advanced.py:74-90) and well below it.

Before a candidate locks, the port confirms its right residual and the
left residuals of every pair it would lock with on the operator
(``eps.true_residual_checks`` counts the applies,
``eps.true_residual_refusals`` the iterations it refused a candidate);
every candidate of these cases passes the first time.  On a strongly
non-normal tridiagonal the coupling's M = W^H V nears singularity and the
estimates stop bounding the residuals: there the check keeps the false
pairs out, and the reference locks them (F2).  On a mildly non-normal one
the check refuses some candidates and the solve certifies on later
restarts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import slepc_tpu as jst
from slepc_tpu.mat import generators as jgen
import slepc_tpu_torch as tst
from slepc_tpu.bv.bv import biorthogonalize_column as jbiorth
from slepc_tpu.ds import types as jtypes
from slepc_tpu_torch import interop
from slepc_tpu_torch.eps.base import EPSConvergedReason
from slepc_tpu_torch.bv.bv import biorthogonalize_column as tbiorth
from slepc_tpu_torch.ds import types as ttypes


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_caches():
    """One intra-op thread for these small solves (the test workers share
    the host's cores); the reference's jit caches dropped at the end (its
    CSR operators' pytree metadata holds a scipy matrix)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def spiral_diags(n):
    """The reference's non-Hermitian deployment (bench.py:1001-1077) as
    chip_smoke.py builds it: a complex tridiagonal of n rows from
    default_rng(5), offsets (-1, 0, 1)."""
    rng = np.random.default_rng(5)
    th = np.linspace(0, 4 * np.pi, n)
    r = np.linspace(0.5, 2.0, n)
    d = (r * np.exp(1j * th)).astype(np.complex64)
    d[:8] = (np.linspace(3.0, 2.4, 8)
             * np.exp(1j * np.linspace(0.3, 5.5, 8))).astype(np.complex64)
    off = 0.05 * (rng.standard_normal(n)
                  + 1j * rng.standard_normal(n)).astype(np.complex64)
    lo = np.zeros(n, np.complex64)
    hi = np.zeros(n, np.complex64)
    hi[: n - 1] = off[: n - 1]
    lo[1:] = off[: n - 1] * 0.3
    return np.stack([lo, d, hi]).astype(np.complex128)


def _both(make, configure=None, **kw):
    """Solve with both packages; make(pkg) gives each its operator."""
    out = []
    for pkg in (jst, tst):
        eps = pkg.EPS(make(pkg), options=pkg.Options(), **kw)
        eps.set_two_sided()
        if configure is not None:
            configure(eps, pkg)
        eps.solve()
        out.append(eps)
    return out


def _left(eps, i):
    y = eps.get_left_eigenvector(i)
    return y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)


def _held(je, te, k, Ad, angle=1e-8, left_tol=1e-8, coupled=True):
    """nconv / its equal; the first k values within 1e-10, each port left
    vector within ``angle`` of the reference's for the same value, and its
    left residual below ``left_tol`` relative to |lambda|.  ``coupled``:
    the coupled variant ran, and its true-residual check refused no
    candidate (at least one right and one left apply a locked pair)."""
    assert te.nconv == je.nconv and te.nconv >= k
    assert te.its == je.its
    if coupled:
        assert te.true_residual_refusals == 0
        assert te.true_residual_checks >= 2 * te.nconv
    jl = np.asarray(je.eigenvalues[: je.nconv])
    for i in range(k):
        lam = complex(te.eigenvalues[i])
        j = int(np.argmin(np.abs(jl - lam)))
        assert abs(jl[j] - lam) <= 1e-10 * abs(lam)
        y, yj = _left(te, i), _left(je, j)
        cos = abs(np.vdot(y, yj)) / np.linalg.norm(y) / np.linalg.norm(yj)
        assert 1.0 - cos <= angle
        r = Ad.conj().T @ y - np.conj(lam) * y
        assert np.linalg.norm(r) / np.linalg.norm(y) <= left_tol * abs(lam)
        assert te.compute_error(i) <= 1e-8


def _dense_or_shell(Ad, kind):
    """Ad as each package's DenseOperator, or as a ShellOperator with its
    product and its adjoint product (the coupled variant's A^H)."""
    def make(pkg):
        if kind == "dense":
            return pkg.DenseOperator(Ad) if pkg is jst else \
                pkg.DenseOperator(Ad, device="cpu")
        if pkg is jst:
            M = jnp.asarray(Ad)
            return jst.ShellOperator(Ad.shape, Ad.dtype, lambda x: M @ x,
                                     lambda x: M.conj().T @ x)
        M = torch.from_numpy(Ad)
        return tst.ShellOperator(Ad.shape, M.dtype, lambda x: M.to(
            x.dtype) @ x, lambda x: M.to(x.dtype).mH @ x, device="cpu")
    return make


@pytest.mark.parametrize("kind", ["dense", "shell"])
def test_two_sided_dense_random_matches_reference(kind):
    """tests/test_eps_advanced.py:74-90: a dense random 60 x 60, nev 3, as
    a dense operator and as a shell with an adjoint."""
    rng = np.random.default_rng(2)
    n = 60
    Ad = rng.standard_normal((n, n)) / np.sqrt(n)
    je, te = _both(_dense_or_shell(Ad, kind), problem_type="nhep", nev=3,
                   which="largest_magnitude")
    _held(je, te, 3, Ad)
    for i in range(3):  # the reference test's own check
        lam = te.eigenvalues[i]
        y = _left(te, i)
        assert np.linalg.norm(y.conj() @ Ad - lam * y.conj()) < 1e-6


def test_two_sided_complex_dia_spiral_left_vectors():
    """The reference's complex deployment at 2^10 rows, natively complex
    DIA (the adjoint on the DIA route)."""
    d = spiral_diags(1 << 10)
    Ad = sp.diags([d[0, 1:], d[1], d[2, :-1]], [-1, 0, 1]).toarray()

    def make(pkg):
        op = jst.DIAOperator((-1, 0, 1), d)
        return op if pkg is jst else interop.operator_from_slepc_tpu(
            op, device="cpu")

    je, te = _both(make, problem_type="nhep", nev=6, ncv=32, tol=1e-8)
    _held(je, te, 6, Ad)


def test_two_sided_real_dia_by_parts():
    """A real non-symmetric tridiagonal (random off-diagonals, a ramp on
    the diagonal) as DIA: the complex bases take the real operator by
    their real and imaginary parts."""
    n = 300
    rng = np.random.default_rng(7)
    lo = 0.3 * rng.standard_normal(n)
    hi = 0.3 * rng.standard_normal(n)
    lo[0] = hi[-1] = 0.0
    dg = np.linspace(0.0, 3.0, n)
    diags = np.stack([lo, dg, hi])
    Ad = sp.diags([lo[1:], dg, hi[:-1]], [-1, 0, 1]).toarray()

    def make(pkg):
        op = jst.DIAOperator((-1, 0, 1), diags)
        return op if pkg is jst else interop.operator_from_slepc_tpu(
            op, device="cpu")

    je, te = _both(make, problem_type="nhep", nev=4, ncv=24,
                   which="largest_real")
    _held(je, te, 4, Ad)


def test_two_sided_csr_markov_stationary_vector():
    """The Markov chain of SLEPc's ex5 (CSR): the left vector of lambda = 1
    is the stationary distribution, one sign throughout.  Largest real
    part: its spectrum holds +-1 and +-0.98, whose equal magnitudes would
    leave the order to rounding."""
    P = jgen.markov(20)
    Ad = P.to_scipy().toarray()
    je, te = _both(lambda pkg: P if pkg is jst else
                   interop.operator_from_slepc_tpu(P, device="cpu"),
                   problem_type="nhep", nev=3, which="largest_real")
    _held(je, te, 3, Ad)
    i = int(np.argmin(np.abs(te.eigenvalues[:te.nconv] - 1.0)))
    assert abs(te.eigenvalues[i] - 1.0) < 1e-10
    y = _left(te, i)
    y = y / y[np.argmax(np.abs(y))]
    # a vector accurate to about tol / gap: real and positive throughout
    assert np.abs(y.imag).max() < 1e-6 and y.real.min() > 0


def test_two_sided_hermitian_copies_the_right_vectors():
    """A Hermitian problem with B = I: the left vectors are the right ones
    (the reference's copy), after the general loop (not the fast path)."""
    je, te = _both(lambda pkg: pkg.laplacian_1d(20) if pkg is jst else
                   pkg.laplacian_1d(20, device="cpu"),
                   problem_type="hep", which="largest_real", nev=2)
    assert te.nconv == je.nconv >= 2 and te.its == je.its
    np.testing.assert_allclose(np.real(te.eigenvalues[:2]),
                               np.real(je.eigenvalues[:2]), rtol=0, atol=1e-10)
    for i in range(2):
        assert torch.equal(te.get_left_eigenvector(i), te._eigenvectors[i])


def test_two_sided_dual_run_for_an_operator_without_adjoint():
    """An ST whose operator has no adjoint apply (a user STShell): the
    one-sided solve, then the left vectors from a run on the adjoint
    problem, matched to the right values (``EPS._solve_left``)."""
    rng = np.random.default_rng(4)
    n = 50
    Ad = rng.standard_normal((n, n)) / np.sqrt(n) + np.diag(np.linspace(
        0, 3, n))

    def configure(eps, pkg):
        eps.set_st(pkg.STShell([eps.A], eps.A.mult))

    je, te = _both(lambda pkg: pkg.DenseOperator(Ad) if pkg is jst else
                   pkg.DenseOperator(Ad, device="cpu"), configure,
                   problem_type="nhep", nev=3, which="largest_real")
    _held(je, te, 3, Ad, coupled=False)


def _non_normal_tridiagonal(n, lo, hi):
    return sp.diags([np.full(n - 1, lo), np.full(n, 2.0), np.full(n - 1, hi)],
                    [-1, 0, 1], format="csr")


@pytest.mark.parametrize("n, lo, hi", [(300, -1.3, -0.7), (200, -1.3, -0.7),
                                       (300, -1.2, -0.8)],
                         ids=["300_1.3_0.7", "200_1.3_0.7", "300_1.2_0.8"])
def test_two_sided_non_normal_tridiagonal_locks_no_false_pair(n, lo, hi):
    """F2: tridiag(lo, 2, hi) is real-spectral in (0.09, 3.91) but so far
    from normal that no pair is reachable at tol in double precision.
    Every pair the port returns meets tol on its true right and left
    residuals; with fewer than nev the reason is DIVERGED_ITS, never
    CONVERGED_TOL.  The reference locks false pairs on the 300-row
    (-1.3, -0.7) operator and reports CONVERGED_TOL with a residual above 1
    (|lambda| up to 9e4): held as a divergence."""
    A = _non_normal_tridiagonal(n, lo, hi)
    te = tst.EPS(tst.from_scipy(A, device="cpu"), problem_type="nhep",
                 nev=5, which="largest_real", options=tst.Options())
    te.set_two_sided()
    te.solve()
    Ad = A.toarray()
    for i in range(te.nconv):
        lam = complex(te.eigenvalues[i])
        assert te.compute_error(i) <= te.tol
        y = _left(te, i)
        r = Ad.conj().T @ y - np.conj(lam) * y
        assert np.linalg.norm(r) / np.linalg.norm(y) <= te.tol * abs(lam)
    want = EPSConvergedReason.CONVERGED_TOL if te.nconv >= 5 \
        else EPSConvergedReason.DIVERGED_ITS
    assert te.reason == want
    # candidates whose estimates passed were refused on their residuals
    assert te.true_residual_refusals > 0
    assert te.true_residual_checks > 2 * te.nconv
    if (n, lo, hi) == (300, -1.3, -0.7):
        je = jst.EPS(jst.from_scipy(A), problem_type="nhep", nev=5,
                     which="largest_real", options=jst.Options())
        je.set_two_sided()
        je.solve()
        assert je.reason.name == "CONVERGED_TOL" and je.nconv >= 5
        worst = 0.0
        for i in range(je.nconv):
            lam, x = je.get_eigenpair(i)
            x = np.asarray(x)
            worst = max(worst, np.linalg.norm(A @ x - lam * x)
                        / np.linalg.norm(x))
        assert worst > 1.0


def test_two_sided_mildly_non_normal_refuses_then_certifies():
    """tridiag(-1.1, 2, -0.9) at 200 rows, the five smallest at tol 1e-7:
    the estimates pass candidates whose true left residuals do not (the
    parent locked five pairs with left residuals up to 1.26e-7), the check
    refuses them, and later restarts certify: CONVERGED_TOL with at least
    nev pairs, each with true right and left residuals below tol."""
    n, tol = 200, 1e-7
    A = _non_normal_tridiagonal(n, -1.1, -0.9)
    te = tst.EPS(tst.from_scipy(A, device="cpu"), problem_type="nhep",
                 nev=5, which="smallest_real", options=tst.Options())
    te.set_tolerances(tol=tol)
    te.set_two_sided()
    te.solve()
    assert te.reason == EPSConvergedReason.CONVERGED_TOL and te.nconv >= 5
    assert te.true_residual_refusals > 0
    assert te.true_residual_checks > 2 * te.nconv
    Ad = A.toarray()
    for i in range(te.nconv):
        lam = complex(te.eigenvalues[i])
        assert te.compute_error(i) <= tol
        y = _left(te, i)
        r = Ad.conj().T @ y - np.conj(lam) * y
        assert np.linalg.norm(r) / np.linalg.norm(y) <= tol * abs(lam)
    # the closed form: 2 - 2 sqrt(0.99) cos(j pi / (n + 1)), j = 1, 2, ...
    exact = 2 - 2 * np.sqrt(0.99) * np.cos(np.arange(1, te.nconv + 1)
                                           * np.pi / (n + 1))
    np.testing.assert_allclose(np.sort(te.eigenvalues.real), exact,
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_dia_adjoint_matches_reference_mult_h(dtype):
    """A^H x on the adjoint's diagonals against the reference's rolls, with
    negative, zero and positive offsets (the reference's diagonals carry
    zeros where a row's partner falls outside [0, n))."""
    n = 97
    offsets = (-7, -1, 0, 2, 5)
    rng = np.random.default_rng(12)
    d = rng.standard_normal((len(offsets), n))
    x = rng.standard_normal(n)
    if dtype == np.complex128:
        d = d + 1j * rng.standard_normal(d.shape)
        x = x + 1j * rng.standard_normal(n)
    for k, o in enumerate(offsets):
        if o > 0:
            d[k, n - o:] = 0
        elif o < 0:
            d[k, :-o] = 0
    ref = np.asarray(jst.DIAOperator(offsets, d).mult_h(x))
    A = tst.DIAOperator(offsets, d, device="cpu")
    got = A.mult_h(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
    dense = A.to_scipy().toarray()
    assert np.abs(got - dense.conj().T @ x).max() <= 1e-14 * np.abs(ref).max()
    # built once: the adjoint's diagonals sit at the negated offsets
    assert A.adjoint() is A.adjoint()
    assert A.adjoint().offsets == tuple(-o for o in offsets)


def test_biorthogonalize_column_matches_reference():
    """BVBiorthogonalizeColumn against a biorthonormal prefix: the new
    pair made orthogonal to the cross basis's earlier vectors, and <w, v>
    returned, against the reference's."""
    n, j = 80, 4
    rng = np.random.default_rng(6)
    V0 = rng.standard_normal((n, j + 1)) + 1j * rng.standard_normal((n, j + 1))
    W0 = rng.standard_normal((n, j + 1)) + 1j * rng.standard_normal((n, j + 1))
    # a biorthonormal prefix: W[:, :j]^H V[:, :j] = I
    W0[:, :j] = W0[:, :j] @ np.linalg.inv(V0[:, :j].conj().T @ W0[:, :j])
    jV = jst.BV(n, j + 1, jnp.complex128, array=jnp.asarray(V0))
    jW = jst.BV(n, j + 1, jnp.complex128, array=jnp.asarray(W0))
    tV = tst.BV(n, j + 1, array=torch.from_numpy(V0.T.copy()))
    tW = tst.BV(n, j + 1, array=torch.from_numpy(W0.T.copy()))
    dj = complex(jbiorth(jV, jW, j))
    dt = complex(tbiorth(tV, tW, j))
    assert abs(dt - dj) <= 1e-12 * abs(dj)
    v, w = tV.array[j].numpy(), tW.array[j].numpy()
    np.testing.assert_allclose(v, np.asarray(jV.array[:, j]), atol=1e-12)
    np.testing.assert_allclose(w, np.asarray(jW.array[:, j]), atol=1e-12)
    assert np.abs(W0[:, :j].conj().T @ v).max() < 1e-12
    assert np.abs(V0[:, :j].conj().T @ w).max() < 1e-12


def test_dsnhepts_matches_reference():
    """DSNHEPTS: right and left eigenvectors of a projected matrix, the
    left ones matched to the right values, against the reference's."""
    rng = np.random.default_rng(8)
    A = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
    w, X, Y = ttypes.DSNHEPTS().solve(A)
    wj, Xj, Yj = jtypes.DSNHEPTS().solve(A)
    np.testing.assert_allclose(w, wj, atol=1e-12)
    for i in range(12):
        assert np.linalg.norm(A @ X[:, i] - w[i] * X[:, i]) < 1e-10
        assert np.linalg.norm(A.conj().T @ Y[:, i]
                              - np.conj(w[i]) * Y[:, i]) < 1e-10
        for M, Mj in ((X, Xj), (Y, Yj)):
            c = abs(np.vdot(M[:, i], Mj[:, i])) / np.linalg.norm(
                M[:, i]) / np.linalg.norm(Mj[:, i])
            assert 1 - c < 1e-12
