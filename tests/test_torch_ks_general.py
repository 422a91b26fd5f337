"""The general Krylov-Schur loop (eps/krylovschur.py) against slepc_tpu's,
on the CPU.

Counterparts of tests/test_eps_krylovschur.py:53 (interior target by
shift-and-invert), :98 (GHEP with a dense SPD B) and :122 (GHEP
shift-and-invert), plus the deflation space of :141, ``true_residual``,
``mpd``, a generalized sinvert on a stencil with a tridiagonal SPD B, and
the -st_* options.  Both packages get the same operators and, in the
general loop, the same start vector (``default_rng(0).standard_normal(n)``),
so they walk the same trajectory: eigenvalues within 1e-10 of each other,
the same ``its`` and ``nconv``, and within the reference tests' own
tolerances of scipy / the closed form.
"""

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop
from slepc_tpu_torch.eps.base import EPSConvergedReason


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches keep the AIJ operators this module ran
    (their pytree metadata holds a scipy matrix), and the reference raises
    when a later module of the same process runs another operator of that
    shape (tests/test_eps_krylovschur.py's Markov chain after the one of
    tests/test_torch_nhep.py): drop them when the module ends."""
    yield
    jax.clear_caches()


def _both(make_ops, configure=None, **eps_kw):
    """Solve with both packages; make_ops() gives slepc_tpu operators."""
    out = []
    for pkg in (jst, tst):
        ops = make_ops()
        if pkg is tst:
            ops = [interop.operator_from_slepc_tpu(M, device="cpu") for M in ops]
        eps = pkg.EPS(*ops, options=pkg.Options(), **eps_kw)
        if configure is not None:
            configure(eps)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv and te.its == je.its
    k = te.nconv
    np.testing.assert_allclose(te.eigenvalues[:k], je.eigenvalues[:k].real,
                               rtol=1e-10, atol=1e-10)
    assert te.reason == EPSConvergedReason.CONVERGED_TOL
    assert te._eigenvectors.shape == (k, ops[0].shape[0])
    return je, te


def test_hep_sinvert_target():
    n = 150
    exact = tst.laplacian_1d_eigs(n)
    _, te = _both(lambda: [jst.laplacian_1d(n)],
                  lambda eps: eps.set_target(1.0), problem_type="hep", nev=4)
    assert te.nconv >= 4
    want = np.sort(exact[np.argsort(np.abs(exact - 1.0))][:4])
    np.testing.assert_allclose(np.sort(te.eigenvalues[:4]), want, rtol=1e-7)
    assert te.st.name == "sinvert" and te.st.ksp.method == "direct"
    assert max(te.compute_error(i) for i in range(4)) < 1e-8
    # wanted-first: sorted by distance to the target
    d = np.abs(te.eigenvalues[:te.nconv] - 1.0)
    assert np.all(np.diff(d) >= 0)


def _dense_pair(seed, n, kind):
    rng = np.random.default_rng(seed)
    Ad = rng.standard_normal((n, n))
    Ad = 0.5 * (Ad + Ad.T)
    if kind == "spd":
        Bd = rng.standard_normal((n, n)) / np.sqrt(n)
        Bd = Bd @ Bd.T + n * np.eye(n) * 0.1
    else:
        Bd = np.eye(n) + 0.1 * np.diag(rng.random(n))
    return Ad, Bd


def test_ghep_shift():
    Ad, Bd = _dense_pair(5, 80, "spd")
    _, te = _both(lambda: [jst.DenseOperator(Ad), jst.DenseOperator(Bd)],
                  problem_type="ghep", which="largest_real", nev=4)
    assert te.nconv >= 4
    w = sla.eigh(Ad, Bd, eigvals_only=True)
    np.testing.assert_allclose(np.sort(te.eigenvalues[:4])[::-1], w[::-1][:4],
                               rtol=1e-7)
    X = te._eigenvectors[:4].numpy()  # rows, B-orthonormal
    np.testing.assert_allclose(X @ Bd @ X.T, np.eye(4), atol=1e-6)
    assert max(te.compute_error(i) for i in range(4)) < 1e-7


def test_ghep_sinvert():
    Ad, Bd = _dense_pair(6, 60, "diag")
    _, te = _both(lambda: [jst.DenseOperator(Ad), jst.DenseOperator(Bd)],
                  lambda eps: eps.set_target(0.5), problem_type="ghep", nev=3)
    assert te.nconv >= 3
    w = sla.eigh(Ad, Bd, eigvals_only=True)
    want = np.sort(w[np.argsort(np.abs(w - 0.5))][:3])
    np.testing.assert_allclose(np.sort(te.eigenvalues[:3]), want, rtol=1e-7)


def test_ghep_sinvert_on_a_stencil_with_a_sparse_mass_matrix():
    """Host LDL^T / LU factorization of A - sigma B (CSR), B-metric basis,
    several restarts with locking (ncv small)."""
    nx, ny = 14, 13
    n = nx * ny
    Bs = sp.diags([np.full(n - 1, 1 / 6), np.full(n, 2 / 3),
                   np.full(n - 1, 1 / 6)], [-1, 0, 1]).tocsr()
    As = sp.csr_matrix(np.asarray(jst.laplacian_2d(nx, ny).to_dense()))
    je, te = _both(lambda: [jst.laplacian_2d(nx, ny), jst.from_scipy(Bs)],
                   lambda eps: eps.set_target(2.2), problem_type="ghep",
                   nev=6, ncv=12, tol=1e-10)
    assert te.nconv >= 6 and te.its > 1
    w = sla.eigh(As.toarray(), Bs.toarray(), eigvals_only=True)
    want = np.sort(w[np.argsort(np.abs(w - 2.2))][:6])
    np.testing.assert_allclose(np.sort(te.eigenvalues[:6]), want, rtol=1e-9)
    assert max(te.compute_error(i) for i in range(6)) < 1e-8


def test_deflation_space_and_true_residual_and_mpd():
    n = 80
    j = np.arange(1, n + 1)
    v_top = np.sin(np.pi * n * j / (n + 1))
    v_top /= np.linalg.norm(v_top)
    exact = tst.laplacian_1d_eigs(n)

    def configure(eps):
        eps.set_deflation_space(v_top)
        eps.set_true_residual(True)

    _, te = _both(lambda: [jst.laplacian_1d(n)], configure,
                  problem_type="hep", which="largest_real", nev=2, mpd=10)
    # the 2nd and 3rd largest, not the deflated largest
    np.testing.assert_allclose(np.sort(te.eigenvalues[:2])[::-1],
                               exact[::-1][1:3], rtol=1e-6)
    assert te.mpd == 10


def test_initial_space_monitor_and_stopping():
    n = 60
    v0 = np.random.default_rng(7).standard_normal(n)
    calls = []

    def configure(eps):
        eps.set_initial_space(v0)
        eps.set_target(0.3)
        if isinstance(eps, tst.EPS):
            eps.set_monitor(lambda s, its, k, e, r: calls.append((its, k)))

    _both(lambda: [jst.laplacian_1d(n)], configure, problem_type="hep", nev=2)
    assert calls and calls[-1][1] >= 2
    # a user stopping test ends the run after one cycle
    te = tst.EPS(tst.laplacian_1d(n, device="cpu"), problem_type="hep",
                 which="largest_real", nev=20, ncv=24)
    te.set_deflation_space(v0)  # forces the general loop
    te.stopping = lambda eps, its, k, nev: True
    te.solve()
    assert te.its == 1 and te.reason == EPSConvergedReason.DIVERGED_ITS


@pytest.mark.parametrize("cli,name,method", [
    ("-st_type sinvert -st_shift 1.0", "sinvert", "direct"),
    ("-st_type sinvert -st_shift 1.0 -st_ksp_type minres", "sinvert", "minres"),
    ("-st_type cayley -st_shift 1.0", "cayley", "direct"),
    ("-eps_target 1.0", "sinvert", "direct"),
])
def test_st_options(cli, name, method):
    n = 150
    exact = tst.laplacian_1d_eigs(n)
    want = np.sort(exact[np.argsort(np.abs(exact - 1.0))][:3])
    te = tst.EPS(tst.laplacian_1d(n, device="cpu"), problem_type="hep", nev=3,
                 options=tst.Options.from_cli(cli))
    te.solve()
    assert te.st.name == name and te.st.ksp.method == method
    assert te.which == tst.Which.TARGET_MAGNITUDE and te.target == 1.0
    np.testing.assert_allclose(np.sort(te.eigenvalues[:3]), want, rtol=1e-7)
    je = jst.EPS(jst.laplacian_1d(n), problem_type="hep", nev=3,
                 options=jst.Options.from_cli(cli))
    if method != "minres":  # the reference runs CG there, which breaks down
        je.solve()
        np.testing.assert_allclose(np.sort(te.eigenvalues[:3]),
                                   np.sort(je.eigenvalues[:3].real), rtol=1e-9)
    with pytest.raises(tst.EPSError, match="unknown st_type"):
        tst.EPS(tst.laplacian_1d(8, device="cpu"), problem_type="hep",
                options=tst.Options.from_cli("-st_type bogus")).solve()


def _complex_op():
    """The numpy matrix of the complex cases: a non-normal complex matrix
    with separated eigenvalues 1..20 (times 1 + 0.5i)."""
    rng = np.random.default_rng(3)
    T = np.diag(np.arange(1.0, 21.0) * (1 + 0.5j)) + 0.2 * np.triu(
        rng.standard_normal((20, 20)) + 1j * rng.standard_normal((20, 20)), 1)
    Q, _ = np.linalg.qr(rng.standard_normal((20, 20))
                        + 1j * rng.standard_normal((20, 20)))
    return Q @ T @ Q.conj().T


def _complex_hermitian_op():
    Ad = _complex_op()
    return 0.5 * (Ad + Ad.conj().T)


def _laplacian_20():
    """The real cases' numpy matrix: laplacian_1d(20), dense."""
    return jst.laplacian_1d(20).to_scipy().toarray()


def _ciss_region(eps):
    """An ellipse around five of laplacian_1d(20)'s values (0.53 .. 1.59),
    each package's own RGEllipse."""
    pkg = tst if isinstance(eps, tst.EPS) else jst
    eps.set_rg(pkg.RGEllipse(center=1.0, radius=0.6))


def _complex_bse_blocks():
    """R Hermitian (+ 2n I) and C complex symmetric, n = 10, as
    tests/test_round4.py:191-205 builds them: H = [R C; -conj(C)
    -conj(R)] is 20 x 20."""
    rng = np.random.default_rng(3)
    n = 10
    R = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    R = 0.5 * (R + R.conj().T) + 2 * n * np.eye(n)
    C = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return R, 0.5 * (C + C.T)


# each case names a setting, and each solves its setting against the
# reference (the same its and nconv, eigenvalues to 1e-9).  The real arms
# run since the non-Hermitian slice (tests/test_torch_nhep.py), the complex
# ones (a complex operator) since item 11a-ii; the solvers of items 11b /
# 11c (gd, ciss, rqcg) solve laplacian_1d(20).  The cases of item 11d
# raised NotImplementedError until it was ported and keep their ids: GHIEP
# (complex Hermitian A, no B: the projection is complex, so it re-solves as
# GNHEP in both packages), the two-sided variant (the coupled Krylov-Schur
# on a complex operator) and BSE (a complex definite MatBSE).
@pytest.mark.parametrize("make,kw,setup", [
    (_complex_op, dict(problem_type="nhep"), None),
    (_complex_hermitian_op, dict(problem_type="ghiep"), None),
    (_complex_op, dict(problem_type="nhep", which="target_magnitude",
                       target=10.3 + 5.1j, cli="-st_type shift"),
     lambda e: setattr(e, "extraction", "harmonic")),
    (_complex_op, dict(problem_type="nhep"),
     lambda e: setattr(e, "two_sided", True)),
    (_complex_op, dict(problem_type="nhep"),
     lambda e: setattr(e, "balance", "krylov")),
    (_complex_op, dict(problem_type="nhep"),
     lambda e: setattr(e, "arbitrary", lambda lam, x: -abs(lam))),
    (_complex_hermitian_op, dict(problem_type="nhep", solver="lanczos"),
     None),
    (_complex_bse_blocks, dict(problem_type="bse"), None),
    (_laplacian_20, dict(problem_type="hep", solver="gd"), None),
    (_laplacian_20, dict(problem_type="hep", solver="ciss"), _ciss_region),
    (_laplacian_20, dict(problem_type="hep", solver="rqcg",
                         which="smallest_real", max_it=3000), None),
], ids=["kw0-None-problem_type='nhep'", "kw1-None-problem_type='ghiep'",
        "kw2-<lambda>-harmonic extraction", "kw3-<lambda>-two-sided",
        "kw4-<lambda>-balancing", "kw5-<lambda>-arbitrary selection",
        "kw6-None-solver 'lanczos'", "problem_type='bse'", "solver 'gd'",
        "solver 'ciss'", "solver 'rqcg'"])
def test_each_arm_solves_as_the_reference(make, kw, setup):
    Ad = make()
    kw = dict(kw)
    cli = kw.pop("cli", "")
    out = []
    for pkg in (jst, tst):
        dev = {} if pkg is jst else {"device": "cpu"}
        if isinstance(Ad, tuple):  # the BSE blocks
            A = pkg.create_bse(*(pkg.DenseOperator(M, **dev) for M in Ad))
        else:
            A = pkg.DenseOperator(Ad, **dev)
        eps = pkg.EPS(A, options=pkg.Options.from_cli(cli),
                      **{"nev": 3, "ncv": 12, "max_it": 500, **kw})
        if setup is not None:
            setup(eps)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv and te.nconv >= 3
    # RQCG's nonlinear CG amplifies rounding: its step counts differ by
    # a few percent (tests/test_torch_lobpcg.py)
    assert te.its == je.its or (kw.get("solver") == "rqcg"
                                and abs(te.its - je.its) <= 0.1 * je.its)
    np.testing.assert_allclose(te.eigenvalues[:3], je.eigenvalues[:3],
                               rtol=0, atol=1e-9)
    if isinstance(Ad, tuple):
        R, C = Ad
        Ad = np.block([[R, C], [-C.conj(), -R.conj()]])
    w = np.linalg.eigvals(Ad)
    for lam in te.eigenvalues[:3]:
        assert np.min(np.abs(w - lam)) < 1e-8
    assert max(te.compute_error(i) for i in range(3)) < 1e-7


def test_st_filter_raises_naming_the_roadmap():
    # -st_type filter builds STFilter since the non-Hermitian slice; it
    # raises when it has no interval to filter (tests/test_torch_filter.py
    # runs it with one)
    eps = tst.EPS(tst.laplacian_1d(20, device="cpu"), problem_type="hep",
                  options=tst.Options.from_cli("-st_type filter"))
    with pytest.raises(tst.EPSError, match="needs an interval"):
        eps.solve()
    eps = tst.EPS(tst.laplacian_1d(20, device="cpu"), problem_type="hep",
                  options=tst.Options.from_cli(
                      "-st_type filter -st_filter_interval 1,2"))
    eps.setup()
    assert isinstance(eps.st, tst.STFilter) and eps.st.interval == (1.0, 2.0)
