"""The non-Hermitian Krylov-Schur arm (slepc_tpu_torch/eps/krylovschur.py)
against slepc_tpu's, on the CPU.

Counterparts of tests/test_eps_krylovschur.py:68 (Markov chain), :80 and
tests/test_eps_solvers.py:101 (random dense), tests/test_eps_advanced.py:161
(balancing), :194 and :220 (harmonic extraction on HEP and on NHEP pairs),
plus GNHEP / PGNHEP with an SPD diagonal B, arbitrary selection, regions and
the true-residual test, and the realified form of the reference's complex
tridiagonal deployment (bench.py:1001-1077) at 2^12 complex rows.  Both
packages get the same operators and start vector (``default_rng(0)``), so
they walk one trajectory: the same ``its`` and ``nconv``, eigenvalues within
1e-9 of each other, conjugate pairs whole, and every returned pair's true
residual (complex eigenvectors applied as their real and imaginary parts)
at the tolerance.
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


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches keep the AIJ operators this module ran
    (their pytree metadata holds a scipy matrix), and the reference raises
    when a later module of the same process runs another operator of that
    shape (tests/test_eps_krylovschur.py's Markov chain after the one of
    tests/test_torch_nhep.py): drop them when the module ends."""
    yield
    jax.clear_caches()


def _both(make_ops, configure=None, resid=1e-7, **eps_kw):
    out = []
    for pkg in (jst, tst):
        ops = make_ops()
        if pkg is tst:
            ops = [interop.operator_from_slepc_tpu(M, device="cpu")
                   for M in ops]
        eps = pkg.EPS(*ops, options=pkg.Options(), **eps_kw)
        if configure is not None:
            configure(eps, pkg)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv and te.its == je.its
    k = te.nconv
    np.testing.assert_allclose(te.eigenvalues[:k], je.eigenvalues[:k],
                               rtol=0, atol=1e-9)
    assert te._eigenvectors.shape == (k, ops[0].shape[0])
    lam = np.asarray(te.eigenvalues[:k])
    for i in range(k):  # conjugate pairs are returned whole
        if abs(lam[i].imag) > 1e-12:
            assert np.min(np.abs(lam - lam[i].conj())) < 1e-12
        if resid is not None:
            assert te.compute_error(i) < resid, (i, te.compute_error(i))
    return je, te


def test_markov_generator_matches_the_reference_entry_for_entry():
    for m in (15, 60):
        A = tst.markov(m, device="cpu").to_scipy()
        R = jst.mat.generators.markov(m).to_scipy()
        assert A.shape == R.shape == (m * (m + 1) // 2,) * 2
        assert (A != R).nnz == 0 and A.nnz == R.nnz


@pytest.mark.parametrize("m", [15, 100])
def test_nhep_markov(m):
    """m = 15: tests/test_eps_krylovschur.py:68; m = 100 (5,050 states):
    chip_smoke phase 11's size, which the reference certifies in 34
    restarts (of the 300 the phase allows)."""
    _, te = _both(lambda: [jst.mat.generators.markov(m)],
                  problem_type="nhep", which="largest_magnitude", nev=4,
                  max_it=300, resid=1e-6)
    assert te.nconv >= 4 and te.its <= (34 if m == 100 else 300)
    assert abs(np.max(np.abs(te.eigenvalues[:4])) - 1.0) < 1e-6
    assert isinstance(te.A, tst.AIJOperator)


@pytest.mark.parametrize("seed,n,nev,ncv", [(3, 120, 5, 40), (1, 80, 3, 30)])
def test_nhep_random_dense(seed, n, nev, ncv):
    rng = np.random.default_rng(seed)
    Ad = rng.standard_normal((n, n)) / np.sqrt(n)
    _, te = _both(lambda: [jst.DenseOperator(Ad)], problem_type="nhep",
                  which="largest_magnitude", nev=nev, ncv=ncv)
    w = np.linalg.eigvals(Ad)
    for lam in te.eigenvalues[:nev]:
        assert np.min(np.abs(w - lam)) < 1e-8
    # best-first: by magnitude
    assert np.all(np.diff(np.abs(te.eigenvalues[:te.nconv])) <= 1e-12)
    X = te.get_eigenvectors()
    assert X.shape == (n, te.nconv) and X.is_complex()


def _spiral(n):
    """The reference's complex tridiagonal deployment (bench.py:1001-1077):
    the diagonal spiral r e^{i theta}, eight detached top-magnitude outliers
    at 3.0 -> 2.4, off-diagonals 0.05 N(0,1) (complex), lo = 0.3 hi."""
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


def test_realified_complex_deployment_matches_both_references():
    import jax

    from slepc_tpu.eps.nhep_split import nhep_split_solve
    from slepc_tpu.ops.complex_split import SplitComplexDIAOperator

    n = 1 << 12
    diags = _spiral(n)
    op = tst.from_complex_dia((-1, 0, 1), diags, device="cpu")
    assert op.offsets == (-3, -2, -1, 0, 1, 2, 3) and op.shape == (2 * n,) * 2
    # the real form applies the complex matrix to interleaved parts
    Ac = sp.diags([diags[0, 1:], diags[1], diags[2, :-1]], [-1, 0, 1])
    x = np.random.default_rng(1).standard_normal(n) \
        + 1j * np.random.default_rng(2).standard_normal(n)
    z = np.empty(2 * n)
    z[0::2], z[1::2] = x.real, x.imag
    y = op.mult(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(y[0::2] + 1j * y[1::2], Ac @ x, atol=1e-14)

    _, te = _both(lambda: [jst.DIAOperator(op.offsets, op.diags.numpy())],
                  problem_type="nhep", which="largest_magnitude", nev=12,
                  ncv=64, resid=1e-8)
    assert te.nconv >= 12
    lam = te.eigenvalues[:12]
    assert np.all(np.abs(lam) > 0.75 * np.abs(diags[1]).max())
    res = nhep_split_solve(
        SplitComplexDIAOperator.from_complex_dia((-1, 0, 1), diags), nev=6,
        ncv=32, tol=1e-10, key=jax.random.PRNGKey(2), max_cycles=200)
    ref = np.asarray(res["lam"][:6])
    for v in lam:  # each value or its conjugate is the complex solve's
        assert min(np.min(np.abs(ref - v)), np.min(np.abs(ref - v.conj()))) \
            < 1e-6
    # a complex eigenvector of the real form is the complex one, interleaved
    lam0, x0 = te.get_eigenpair(0)
    xc = x0.numpy()
    assert x0.is_complex()
    r = op.mult(x0.real.contiguous()) + 1j * op.mult(x0.imag.contiguous())
    assert np.linalg.norm(r.numpy() - lam0 * xc) < 1e-8 * abs(lam0)


def test_realified_deployment_against_dense_eigenvalues():
    """At 2^10 complex rows (chip_smoke phase 10's build check): the twelve
    values are the six largest of the complex matrix and their
    conjugates."""
    diags = _spiral(1 << 10)
    eps = tst.EPS(tst.from_complex_dia((-1, 0, 1), diags, device="cpu"),
                  problem_type="nhep", nev=12, ncv=64, options=tst.Options())
    eps.solve()
    assert eps.nconv >= 12
    Ac = sp.diags([diags[0, 1:], diags[1], diags[2, :-1]], [-1, 0, 1])
    w = np.linalg.eigvals(Ac.toarray())
    top = w[np.argsort(-np.abs(w))][:6]
    want = np.sort_complex(np.concatenate([top, top.conj()]))
    np.testing.assert_allclose(np.sort_complex(eps.eigenvalues[:12]), want,
                               rtol=1e-9)


def test_gnhep_and_pgnhep_with_a_diagonal_spd_b():
    rng = np.random.default_rng(4)
    n = 60
    Ad = rng.standard_normal((n, n))
    bd = 1.0 + rng.uniform(0.0, 1.0, n)
    w = sla.eigvals(Ad, np.diag(bd))
    for pt in ("gnhep", "pgnhep"):
        _, te = _both(lambda: [jst.DenseOperator(Ad),
                               jst.DenseOperator(np.diag(bd))],
                      problem_type=pt, nev=4, ncv=30)
        assert te.nconv >= 4
        for lam in te.eigenvalues[:4]:
            assert np.min(np.abs(w - lam)) < 1e-7 * np.abs(w).max()


def test_harmonic_extraction_hep():
    n = 300
    A = sp.diags(np.arange(1.0, n + 1)).tocsr()

    def configure(eps, pkg):
        eps.set_problem_type("hep")
        eps.set_dimensions(nev=4, ncv=24)
        eps.set_target(4.8)
        eps.set_st(pkg.STShift([eps.A]))
        eps.set_which("target_magnitude")
        eps.set_extraction("harmonic")
        eps.set_tolerances(tol=1e-8, max_it=100)

    _, te = _both(lambda: [jst.from_scipy(A)], configure)
    got = te.eigenvalues.real
    np.testing.assert_allclose(got, np.round(got), atol=1e-6)
    assert {4.0, 5.0} <= set(np.round(got))
    assert not np.iscomplexobj(te.eigenvalues)


def test_harmonic_extraction_nhep_pairs():
    rng = np.random.default_rng(7)
    n = 300
    re = np.arange(1.0, n // 2 + 1)
    im = 0.4 * rng.standard_normal(n // 2)
    D = sla.block_diag(*[np.array([[a, b], [-b, a]]) for a, b in zip(re, im)])
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Ad = Q @ D @ Q.T
    ew = np.concatenate([re + 1j * im, re - 1j * im])

    def configure(eps, pkg):
        eps.set_dimensions(nev=4, ncv=24)
        eps.set_target(4.8)
        eps.set_st(pkg.STShift([eps.A]))
        eps.set_which("target_magnitude")
        eps.set_extraction("harmonic")
        eps.set_tolerances(tol=1e-8, max_it=300)

    _, te = _both(lambda: [jst.DenseOperator(Ad)], configure,
                  problem_type="nhep", resid=1e-6)
    assert te.nconv >= 4
    for lam in te.eigenvalues[:4]:
        assert np.min(np.abs(ew - lam)) < 1e-6


def test_krylov_balance():
    rng = np.random.default_rng(0)
    n = 80
    D = np.diag(10.0 ** rng.uniform(-3, 3, n))
    M0 = rng.standard_normal((n, n)) / np.sqrt(n)
    Ad = np.linalg.solve(D, M0) @ D
    w_ref = np.linalg.eigvals(M0)
    from slepc_tpu.eps.balance import krylov_balance as jbal
    from slepc_tpu_torch.eps.balance import krylov_balance as tbal

    # p = |A (z d)| sums terms 1e6 apart in size with cancellation, so the
    # two products' summation orders leave d equal to ~1e-7 only
    np.testing.assert_allclose(
        tbal(tst.DenseOperator(Ad, device="cpu")),
        jbal(jst.DenseOperator(Ad)), rtol=1e-5)
    _, te = _both(lambda: [jst.DenseOperator(Ad)],
                  lambda eps, pkg: eps.set_balance(), problem_type="nhep",
                  nev=3, ncv=40, max_it=300, resid=None)
    assert te.nconv >= 3
    for lam in te.eigenvalues[:3]:
        assert np.min(np.abs(w_ref - lam)) < 1e-7
    # the eigenvectors are those of A (the scaling undone)
    for i in range(3):
        assert te.compute_error(i) < 1e-6


def test_arbitrary_selection():
    rng = np.random.default_rng(1)
    n = 80
    Ad = rng.standard_normal((n, n)) / np.sqrt(n)

    def key(lam, x):  # a numpy column (reference) or a tensor row (port)
        return -float(abs(x[:10]).sum()) * abs(lam)

    _, te = _both(lambda: [jst.DenseOperator(Ad)],
                  lambda eps, pkg: eps.set_arbitrary_selection(key),
                  problem_type="nhep", nev=3, ncv=30)
    assert te.nconv >= 3


@pytest.mark.parametrize("region", ["interval", "ellipse"])
def test_region_filtering(region):
    rng = np.random.default_rng(1)
    n = 80
    Ad = rng.standard_normal((n, n)) / np.sqrt(n)
    if region == "interval":  # the right half plane, largest real first
        make = lambda p: p.RGInterval(0.0, np.inf, -np.inf, np.inf)
        kw = dict(which="largest_real")
    else:  # around a target, nearest first
        make = lambda p: p.RGEllipse(center=0.6, radius=0.35, vscale=1.0)
        kw = dict(which="target_magnitude", target=0.6)

    def configure(eps, pkg):
        eps.set_rg(make(pkg))
        eps.set_st(pkg.STShift([eps.A]))

    _, te = _both(lambda: [jst.DenseOperator(Ad)], configure,
                  problem_type="nhep", nev=3, ncv=30, max_it=300, **kw)
    assert te.nconv >= 3
    assert np.all(make(tst).check_inside(te.eigenvalues[:te.nconv]) >= 0)


def test_true_residual_on_the_schur_arm():
    """A divergence: the reference confirms a candidate with the Ritz
    vector of the active block alone, whose residual after the first lock
    carries the locked rows' coupling, so it stalls at nconv 2; the port
    forms the eigenvector of the whole quasi-triangular form."""
    rng = np.random.default_rng(3)
    n = 120
    Ad = rng.standard_normal((n, n)) / np.sqrt(n)
    kw = dict(problem_type="nhep", nev=5, ncv=40)
    je = jst.EPS(jst.DenseOperator(Ad), **kw)
    je.set_true_residual()
    je.solve()
    te = tst.EPS(tst.DenseOperator(Ad, device="cpu"), options=tst.Options(),
                 **kw)
    te.set_true_residual()
    te.solve()
    assert je.nconv < 5 <= te.nconv
    np.testing.assert_allclose(te.eigenvalues[:je.nconv],
                               je.eigenvalues[:je.nconv], atol=1e-9)
    w = np.linalg.eigvals(Ad)
    for i in range(te.nconv):
        assert np.min(np.abs(w - te.eigenvalues[i])) < 1e-8
        assert te.compute_error(i) < 1e-8


def test_f32_nhep_on_the_kernels_plain_versions():
    A = tst.from_complex_dia((-1, 0, 1), _spiral(1 << 10), device="cpu")
    A32 = tst.DIAOperator(A.offsets, A.diags.float())
    eps = tst.EPS(A32, problem_type="nhep", nev=12, ncv=64, tol=1e-4,
                  options=tst.Options())
    eps.solve()
    assert eps.nconv >= 12 and eps._eigenvectors.dtype == torch.complex64
    assert max(eps.compute_error(i) for i in range(12)) < 1e-3
