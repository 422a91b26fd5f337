"""STFilter (slepc_tpu_torch/st/filter.py) against slepc_tpu's, on the CPU.

The coefficient functions (Jackson- and Lanczos-damped indicator, the smooth
FILTLAN-style base) and ``filter_value`` agree to 1e-13; the seeded
spectral-bound estimate agrees to 1e-12; the filter operator's ``mult`` on
``laplacian_1d(200)`` as DIA and as CSR agrees with the reference's
filter operator to 1e-10, and its ``mult_block`` with row-by-row ``mult``;
the filtered Krylov-Schur solve of tests/test_eps_solvers.py:116 finds the
same interior eigenvalues as the reference, to 1e-8 of each other and of the
closed form.
"""

import jax
import numpy as np
import pytest
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu.st import filter as jfilter
from slepc_tpu_torch import interop
from slepc_tpu_torch.st import filter as tfilter


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches keep the AIJ operators this module ran
    (their pytree metadata holds a scipy matrix), and the reference raises
    when a later module of the same process runs another operator of that
    shape (tests/test_eps_krylovschur.py's Markov chain after the one of
    tests/test_torch_nhep.py): drop them when the module ends."""
    yield
    jax.clear_caches()


_CASES = [(40, 1.0, 1.2, 0.0, 4.0), (150, 1.0, 1.2, 0.0, 4.0),
          (80, -0.3, 0.5, -1.0, 1.0), (25, 2.5, 3.9, 0.1, 4.0)]


@pytest.mark.parametrize("degree,a,b,lmin,lmax", _CASES)
@pytest.mark.parametrize("damping", ["jackson", "lanczos", "none"])
def test_indicator_coefficients_match(degree, a, b, lmin, lmax, damping):
    np.testing.assert_allclose(
        tfilter._chebyshev_indicator_coeffs(degree, a, b, lmin, lmax, damping),
        jfilter._chebyshev_indicator_coeffs(degree, a, b, lmin, lmax, damping),
        rtol=0, atol=1e-13)


@pytest.mark.parametrize("degree,a,b,lmin,lmax", _CASES)
@pytest.mark.parametrize("trans", [None, 0.05])
def test_smooth_base_coefficients_match(degree, a, b, lmin, lmax, trans):
    np.testing.assert_allclose(
        tfilter._smooth_base_coeffs(degree, a, b, lmin, lmax, trans),
        jfilter._smooth_base_coeffs(degree, a, b, lmin, lmax, trans),
        rtol=0, atol=1e-13)


@pytest.mark.parametrize("damping", ["jackson", "lanczos", "filtlan"])
def test_filter_value_matches(damping):
    lam = np.linspace(-0.2, 4.2, 301)
    kw = dict(interval=(1.0, 1.2), degree=60, spectral_range=(0.0, 4.0),
              damping=damping)
    tv = tst.STFilter([tst.laplacian_1d(10, device="cpu")], **kw)
    jv = jst.STFilter([jst.laplacian_1d(10)], **kw)
    np.testing.assert_allclose(tv.filter_value(lam), jv.filter_value(lam),
                               rtol=0, atol=1e-13)
    # amplified inside the interval, damped far from it
    p = tv.filter_value(np.array([1.1, 0.2, 3.5]))
    assert p[0] > 0.5 and abs(p[1]) < 0.05 and abs(p[2]) < 0.05


@pytest.mark.parametrize("form", ["dia", "csr"])
def test_spectral_bounds_estimate_matches(form):
    jA = jst.laplacian_1d(200)
    if form == "csr":
        jA = jst.from_scipy(jA.to_scipy())
    tA = interop.operator_from_slepc_tpu(jA, device="cpu")
    lo, hi = tfilter.estimate_spectral_bounds(tA)
    lo_j, hi_j = jfilter.estimate_spectral_bounds(jA)
    assert abs(lo - lo_j) < 1e-12 and abs(hi - hi_j) < 1e-12
    assert lo <= 0.0 + 1e-3 and hi >= 4.0 - 1e-3


@pytest.mark.parametrize("damping", ["jackson", "filtlan"])
@pytest.mark.parametrize("form", ["dia", "csr"])
def test_filter_operator_mult_matches(form, damping):
    jA = jst.laplacian_1d(200)
    if form == "csr":
        jA = jst.from_scipy(jA.to_scipy())
    jf = jst.STFilter([jA], interval=(1.0, 1.2), degree=60,
                      damping=damping)
    tf = interop.st_from_slepc_tpu(jf, device="cpu")  # range estimated
    assert isinstance(tf, tst.STFilter) and tf.requires_rayleigh
    x = np.random.default_rng(3).standard_normal(200)
    y_j = np.asarray(jf.op().mult(np.asarray(x)))
    op = tf.op()
    y_t = op.mult(torch.from_numpy(x)).numpy()
    assert abs(tf.range[0] - jf.range[0]) < 1e-12
    np.testing.assert_allclose(y_t, y_j, rtol=0,
                               atol=1e-10 * np.abs(y_j).max())
    X = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 200)))
    Y = op.mult_block(X)
    for i in range(3):
        torch.testing.assert_close(Y[i], op.mult(X[i]), rtol=0, atol=1e-12)
    assert op.nnz == jA.nnz * 60


def _filter_solve(pkg, A, **kw):
    eps = pkg.EPS(A, problem_type="hep", which="largest_real", nev=5,
                  ncv=40, tol=1e-6, options=pkg.Options())
    eps.set_st(pkg.STFilter([A], interval=(1.0, 1.2), degree=150, **kw))
    eps.solve()
    return eps


@pytest.mark.parametrize("form", ["dia", "csr"])
def test_filter_interval_solve_matches(form):
    """DIA: against the reference's solve (the same trajectory); CSR: the
    port's CSR solve against its DIA solve (the reference's CSR apply runs
    its Pallas kernel in interpret mode, 150 calls a filtered column)."""
    n = 200
    exact = tst.laplacian_1d_eigs(n)
    jA = jst.laplacian_1d(n)
    tA = interop.operator_from_slepc_tpu(jA, device="cpu")
    rng = {"spectral_range": (0.0, 4.0)}
    te = _filter_solve(tst, tA, **rng)
    if form == "dia":
        ref = _filter_solve(jst, jA, **rng)
    else:
        ref = te
        te = _filter_solve(tst, tst.from_scipy(jA.to_scipy(), device="cpu"),
                           **rng)
    assert te.its == ref.its and te.nconv >= 3
    # every value strictly inside (the endpoint 1.0 is an eigenvalue, which
    # either run may place a rounding on either side of)
    inner = lambda lam: np.sort(lam[(lam > 1.0 + 1e-9) & (lam < 1.2)])
    got, want_ref = inner(te.eigenvalues[:te.nconv]), inner(
        np.asarray(ref.eigenvalues[:ref.nconv]).real)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=1e-8)
    want = exact[(exact > 1.0 + 1e-9) & (exact < 1.2)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    for i in range(te.nconv):
        assert te.compute_error(i) < 1e-6
        assert 1.0 - 1e-9 <= te.eigenvalues[i] <= 1.2


def test_st_type_filter_option_builds_the_filter():
    A = tst.laplacian_1d(200, device="cpu")
    opts = tst.Options.from_cli("-st_type filter -st_filter_interval 1.0,1.2 "
                                "-st_filter_degree 150")
    eps = tst.EPS(A, problem_type="hep", which="largest_real", nev=5,
                  ncv=40, tol=1e-6, options=opts)
    eps.solve()
    assert isinstance(eps.st, tst.STFilter) and eps.st.degree == 150
    assert eps.st.interval == (1.0, 1.2) and eps.nconv >= 5
    te = _filter_solve(tst, A)  # the spectral range estimated in both
    np.testing.assert_allclose(eps.eigenvalues, te.eigenvalues, atol=1e-12)
    with pytest.raises(tst.EPSError, match="needs an interval"):
        tst.EPS(A, problem_type="hep", options=tst.Options.from_cli(
            "-st_type filter")).solve()
