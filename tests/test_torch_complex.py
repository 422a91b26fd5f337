"""Complex operators through slepc_tpu_torch, against slepc_tpu on the CPU.

Both packages get the same numpy operators: the gauge-transformed
Laplacian U L U^H (U = diag(exp(i phi)), phi from default_rng(11)), which
keeps L's offsets and its spectrum; a random complex Hermitian CSR; the
reference's complex tridiagonal non-Hermitian deployment
(``bench.py:1001-1077``, the "spiral"); and real operators with a complex
shift.  Where both start from ``default_rng(0)`` (Re + i Im), they walk the
same trajectory: eigenvalues within 1e-10 of each other and the same
``its``.  Tolerances: 1e-10 on eigenvalues for runs at tol 1e-8 (f64 /
c128 rounding on ~1e3-row problems, a few hundred times eps times the
condition of the projected problem); the solver's own tol on residuals.
"""

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu.eps.nhep_split import nhep_split_solve
from slepc_tpu.mat.generators import laplacian_2d_eigs
from slepc_tpu.ops.complex_split import SplitComplexDIAOperator


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches keep the AIJ operators this module ran
    (their pytree metadata holds a scipy matrix), and the reference raises
    when a later module of the same process runs another operator of that
    shape (tests/test_eps_krylovschur.py's Markov chain after the one of
    tests/test_torch_nhep.py): drop them when the module ends."""
    yield
    jax.clear_caches()


torch = pytest.importorskip("torch")


def gauge(offsets, diags, seed=11):
    """U A U^H for U = diag(exp(2 pi i u)), u from default_rng(seed): entry
    (i, i + o) times exp(i (phi_i - phi_{i+o})); same offsets, same
    spectrum, complex Hermitian when A is symmetric."""
    d = np.asarray(diags).astype(np.complex128)
    n = d.shape[1]
    phi = 2 * np.pi * np.random.default_rng(seed).random(n)
    for k, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, n - o)
        d[k, lo:hi] *= np.exp(1j * (phi[lo:hi] - phi[lo + o:hi + o]))
    return d


def gauge_laplacian_2d(nx, ny):
    L = jst.laplacian_2d(nx, ny)
    return tuple(L.offsets), gauge(L.offsets, np.asarray(L.diags))


def spiral(n, dtype=np.complex128):
    """The reference's complex tridiagonal deployment (bench.py:1001-1077,
    as tests/test_torch_nhep.py builds it)."""
    rng = np.random.default_rng(0)
    r = np.linspace(3.0, 2.4, n)
    th = np.linspace(0.0, 40 * np.pi, n)
    d = (r * np.exp(1j * th)).astype(np.complex64)
    d[:8] = (np.linspace(3.6, 3.2, 8)
             * np.exp(1j * np.linspace(0.3, 5.5, 8))).astype(np.complex64)
    off = (0.05 * (rng.standard_normal(n)
                   + 1j * rng.standard_normal(n))).astype(np.complex64)
    lo = np.zeros(n, np.complex64)
    hi = np.zeros(n, np.complex64)
    lo[1:] = 0.3 * off[:-1]
    hi[:-1] = off[:-1]
    return np.stack([lo, d, hi]).astype(dtype)


def herm_csr(n=600, density=0.01, seed=3):
    """A random complex Hermitian sparse matrix whose pattern is no few
    dense diagonals (so the port keeps it CSR: K6c on a card)."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csr")
    Bm = sp.random(n, n, density=density, random_state=rng, format="csr")
    C = (A + 1j * Bm).tocsr()
    return (C + C.conj().T + sp.diags(np.linspace(1.0, 4.0, n))).tocsr()


def _pair(make_j, make_t, configure=None, **kw):
    """Solve with both packages; returns (reference eps, port eps)."""
    out = []
    for pkg, make in ((jst, make_j), (tst, make_t)):
        eps = pkg.EPS(*make(), options=pkg.Options(), **kw)
        if configure is not None:
            configure(pkg, eps)
        eps.solve()
        out.append(eps)
    return out


def _dia_pair(offsets, d):
    return (lambda: [jst.DIAOperator(offsets, d)],
            lambda: [tst.DIAOperator(offsets, d, device="cpu")])


def _true_residuals(te):
    return [te.compute_error(i) for i in range(te.nconv)]


@pytest.mark.parametrize("which", ["smallest_real", "largest_real"])
def test_complex_hermitian_hep_on_dia(which):
    offsets, d = gauge_laplacian_2d(20, 19)
    je, te = _pair(*_dia_pair(offsets, d), problem_type="hep", which=which,
                   nev=4)
    assert te.nconv >= 4 and te.its == je.its
    assert not np.iscomplexobj(te.eigenvalues)
    np.testing.assert_allclose(te.eigenvalues[:4], je.eigenvalues[:4].real,
                               rtol=0, atol=1e-10)
    exact = np.sort(np.asarray(laplacian_2d_eigs(20, 19)))
    want = exact[:4] if which == "smallest_real" else exact[::-1][:4]
    np.testing.assert_allclose(te.eigenvalues[:4], want, atol=1e-9)
    X = te.get_eigenvectors()
    assert X.dtype == torch.complex128 and X.shape == (380, te.nconv)
    assert max(_true_residuals(te)) < 1e-8


# one size per case: the reference's jit cache compares the static fields
# of two CSR operators of one shape with scipy's elementwise ==, and raises
@pytest.mark.parametrize("which,n", [("smallest_real", 600),
                                     ("largest_real", 640)])
def test_complex_hermitian_hep_on_csr(which, n):
    C = herm_csr(n)
    je, te = _pair(lambda: [jst.AIJOperator.from_scipy(C)],
                   lambda: [tst.from_scipy(C, device="cpu")],
                   problem_type="hep", which=which, nev=4)
    assert isinstance(te.A.fast_form(), tst.AIJOperator)  # stays CSR: K6c
    assert te.nconv >= 4 and te.its == je.its
    np.testing.assert_allclose(te.eigenvalues[:4], je.eigenvalues[:4].real,
                               rtol=0, atol=1e-10)
    w = np.linalg.eigvalsh(C.toarray())
    want = w[:4] if which == "smallest_real" else w[::-1][:4]
    np.testing.assert_allclose(te.eigenvalues[:4], want, atol=1e-9)
    assert max(_true_residuals(te)) < 1e-8


# B is stored complex (zero imaginary parts) for the reference: with a real
# B its generalized shift solves B^-1 (A x) in B's real dtype, drops the
# imaginary parts and stalls at max_it (the port applies a real factor to a
# complex vector by parts and certifies; the "real" case holds it to scipy)
@pytest.mark.parametrize("bdtype", [complex, float], ids=["complex", "real"])
def test_complex_ghep_with_a_diagonal_spd_b(bdtype):
    offsets, d = gauge_laplacian_2d(16, 15)
    n = d.shape[1]
    b = (1.0 + 0.5 * np.sin(0.1 * np.arange(n))).astype(bdtype)
    bj = b.astype(complex)
    je, te = _pair(
        lambda: [jst.DIAOperator(offsets, d), jst.DIAOperator((0,), bj[None])],
        lambda: [tst.DIAOperator(offsets, d, device="cpu"),
                 tst.DIAOperator((0,), b[None], device="cpu")],
        problem_type="ghep", which="largest_real", nev=3)
    assert te.nconv >= 3 and te.its == je.its
    np.testing.assert_allclose(te.eigenvalues[:3], je.eigenvalues[:3].real,
                               rtol=0, atol=1e-10)
    Ad = tst.DIAOperator(offsets, d, device="cpu").to_dense().numpy()
    want = sla.eigh(Ad, np.diag(b.real), eigvals_only=True)[::-1][:3]
    np.testing.assert_allclose(te.eigenvalues[:3], want, atol=1e-9)
    assert max(_true_residuals(te)) < 1e-8


@pytest.mark.parametrize("n", [1 << 10, 1 << 12])
def test_complex_nhep_spiral_matches_eps_and_split_solve(n):
    d = spiral(n)
    je, te = _pair(*_dia_pair((-1, 0, 1), d), problem_type="nhep", nev=6,
                   ncv=32)
    assert te.nconv >= 6 and te.its == je.its
    np.testing.assert_allclose(te.eigenvalues[:6], je.eigenvalues[:6],
                               rtol=0, atol=1e-10)
    res = nhep_split_solve(SplitComplexDIAOperator.from_complex_dia(
        (-1, 0, 1), d), nev=6, ncv=32, tol=1e-10)
    for lam in te.eigenvalues[:6]:
        assert np.min(np.abs(np.asarray(res["lam"]) - lam)) < 1e-8
    if n == 1 << 10:  # the whole spectrum is at hand
        A = tst.DIAOperator((-1, 0, 1), d, device="cpu").to_dense().numpy()
        w = np.linalg.eigvals(A)
        top = w[np.argsort(-np.abs(w))[:6]]
        for lam in te.eigenvalues[:6]:
            assert np.min(np.abs(top - lam)) < 1e-9
    assert te.get_eigenvectors().dtype == torch.complex128
    assert max(_true_residuals(te)) < 1e-8


def _complex_gapped(n=80, seed=0):
    """A complex Hermitian matrix with a geometric spectrum 3 * 0.8^k."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
    w = 3.0 * 0.8 ** np.arange(n)
    return (Q * w) @ Q.conj().T, np.sort(w)[::-1]


def _complex_dense(n=80, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n))
            + 1j * rng.standard_normal((n, n))) / np.sqrt(2 * n)


def _dense_pair(Ad):
    return (lambda: [jst.DenseOperator(Ad)],
            lambda: [tst.DenseOperator(Ad, device="cpu")])


def _held(je, te, k, atol=1e-9, same_its=True):
    assert te.nconv == je.nconv and te.nconv >= k
    if same_its:
        assert te.its == je.its
    np.testing.assert_allclose(te.eigenvalues[:k], je.eigenvalues[:k],
                               rtol=0, atol=atol)


def test_complex_harmonic_extraction():
    """Interior values of a complex non-normal matrix near a target (the
    real test's problem, tests/test_torch_nhep.py, with complex values)."""
    rng = np.random.default_rng(7)
    n = 300
    ew = np.arange(1.0, n + 1) + 0.3j * rng.standard_normal(n)
    T = np.diag(ew) + 0.1 * np.triu(rng.standard_normal((n, n)), 1)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
    Ad = Q @ T @ Q.conj().T

    def configure(pkg, eps):
        eps.set_dimensions(nev=4, ncv=24)
        eps.set_target(4.8)
        eps.set_st(pkg.STShift([eps.A]))
        eps.set_which("target_magnitude")
        eps.set_extraction("harmonic")
        eps.set_tolerances(tol=1e-8, max_it=300)

    je, te = _pair(*_dense_pair(Ad), configure, problem_type="nhep")
    _held(je, te, 4)
    for lam in te.eigenvalues[:4]:
        assert np.min(np.abs(ew - lam)) < 1e-6
    assert max(_true_residuals(te)[:4]) < 1e-6


def test_complex_krylov_balance():
    rng = np.random.default_rng(0)
    n = 80
    D = np.diag(10.0 ** rng.uniform(-3, 3, n))
    M0 = _complex_dense(n, 2)
    Ad = np.linalg.solve(D, M0) @ D
    from slepc_tpu.eps.balance import krylov_balance as jbal
    from slepc_tpu_torch.eps.balance import krylov_balance as tbal

    # the probes' products sum terms 1e6 apart with cancellation: the two
    # summation orders leave d equal to ~1e-7 only (as in the real case)
    np.testing.assert_allclose(tbal(tst.DenseOperator(Ad, device="cpu")),
                               jbal(jst.DenseOperator(Ad)), rtol=1e-5)
    je, te = _pair(*_dense_pair(Ad), lambda pkg, e: e.set_balance(),
                   problem_type="nhep", nev=3, ncv=40, max_it=300)
    assert te.nconv >= 3
    w = np.linalg.eigvals(M0)
    for lam in te.eigenvalues[:3]:
        assert np.min(np.abs(w - lam)) < 1e-7
    assert max(_true_residuals(te)[:3]) < 1e-6


def test_complex_arbitrary_selection():
    Ad = _complex_dense()

    def key(lam, x):  # a numpy column (reference) or a tensor row (port)
        return -float(abs(x[:10]).sum()) * abs(lam)

    je, te = _pair(*_dense_pair(Ad),
                   lambda pkg, e: e.set_arbitrary_selection(key),
                   problem_type="nhep", nev=3, ncv=30)
    _held(je, te, 3)


@pytest.mark.parametrize("region", ["interval", "ellipse"])
def test_complex_region_filtering(region):
    Ad = _complex_dense()
    if region == "interval":  # the right half plane, largest real first
        make = lambda p: p.RGInterval(0.0, np.inf, -np.inf, np.inf)
        kw = dict(which="largest_real")
    else:  # around a target, nearest first
        make = lambda p: p.RGEllipse(center=0.5, radius=0.35, vscale=1.0)
        kw = dict(which="target_magnitude", target=0.5)

    def configure(pkg, eps):
        eps.set_rg(make(pkg))
        eps.set_st(pkg.STShift([eps.A]))

    je, te = _pair(*_dense_pair(Ad), configure, problem_type="nhep", nev=3,
                   ncv=30, max_it=300, **kw)
    _held(je, te, 3)
    assert np.all(make(tst).check_inside(te.eigenvalues[:te.nconv]) >= 0)


@pytest.mark.parametrize("solver", ["arnoldi", "lanczos", "subspace",
                                    "lapack", "power"])
def test_complex_hermitian_solvers(solver):
    Ad, exact = _complex_gapped()
    nev = 1 if solver == "power" else 3
    kw = dict(which="largest_magnitude" if solver == "power"
              else "largest_real", nev=nev, solver=solver, ncv=16)
    if solver == "power":
        kw.update(max_it=5000, tol=1e-9)
    if solver == "subspace":
        kw.update(max_it=500)
    je, te = _pair(*_dense_pair(Ad), problem_type="hep", **kw)
    _held(je, te, nev)
    np.testing.assert_allclose(np.sort(np.real(te.eigenvalues[:nev]))[::-1],
                               exact[:nev], rtol=1e-8)
    assert te.get_eigenvectors().dtype == torch.complex128
    assert max(_true_residuals(te)) < 1e-7


@pytest.mark.parametrize("solver", ["arnoldi", "subspace", "lapack",
                                    "power"])
def test_complex_nhep_solvers_on_the_spiral(solver):
    n = {"arnoldi": 1 << 10, "power": 1 << 10, "subspace": 1 << 8,
         "lapack": 1 << 8}[solver]
    d = spiral(n)
    kw = dict(nev=1 if solver == "power" else 3, solver=solver, ncv=24)
    if solver in ("power", "subspace"):
        kw.update(max_it=3000)
    make = _dia_pair((-1, 0, 1), d)
    je, te = _pair(*make, problem_type="nhep", **kw)
    k = kw["nev"]
    _held(je, te, k)
    A = tst.DIAOperator((-1, 0, 1), d, device="cpu")
    assert max(_true_residuals(te)[:k]) < 1e-7
    assert te.get_eigenvectors().shape == (A.shape[0], te.nconv)


def test_complex_shift_of_a_real_operator():
    """STSinvert at target 0.5 + 0.1i on a real Laplacian: the shifted
    matrix is complex (a host LU), the transformed operator normal but not
    Hermitian, so the port runs the Schur arm in complex arithmetic and
    returns the real eigenvalues nearest the target.  The reference keeps
    the basis and H real there and drops the imaginary parts of its
    coefficients (slepc_tpu/bv/krylov.py:190), so it is held to the
    closed-form spectrum, not to the reference (ROADMAP queue 3)."""
    nx, ny = 30, 29
    exact = np.asarray(laplacian_2d_eigs(nx, ny))
    want = exact[np.argsort(np.abs(exact - (0.5 + 0.1j)))[:4]]
    for true_residual, bound in ((False, 1e-7), (True, 1e-8)):
        A = tst.laplacian_2d(nx, ny, device="cpu")
        eps = tst.EPS(A, problem_type="hep", nev=4, options=tst.Options())
        eps.set_target(0.5 + 0.1j)
        if true_residual:  # certified on ||A x - lambda x|| itself
            eps.set_true_residual()
        eps.solve()
        assert eps.nconv >= 4 and eps.st.name == "sinvert"
        assert eps.st.op().dtype == torch.complex128
        assert not np.iscomplexobj(eps.eigenvalues)
        np.testing.assert_allclose(np.sort(eps.eigenvalues[:4]),
                                   np.sort(want), atol=1e-9)
        assert max(_true_residuals(eps)[:4]) < bound
    # the reference on the same problem (a divergence, ROADMAP queue 3)
    je = jst.EPS(jst.laplacian_2d(nx, ny), problem_type="hep", nev=4,
                 options=jst.Options(), max_it=20)
    je.set_target(0.5 + 0.1j)
    with pytest.warns(Warning):  # complex coefficients cast to real
        je.solve()
    assert je.nconv == 0


@pytest.mark.parametrize("pkgs", ["port->ref", "ref->port"])
def test_complex_save_and_load_state_across_packages(tmp_path, pkgs):
    offsets, d = gauge_laplacian_2d(16, 15)
    make_j, make_t = _dia_pair(offsets, d)
    first, second = ((tst, make_t), (jst, make_j)) if pkgs == "port->ref" \
        else ((jst, make_j), (tst, make_t))
    e1 = first[0].EPS(*first[1](), problem_type="hep", which="largest_real",
                      nev=3, options=first[0].Options())
    e1.solve()
    path = str(tmp_path / "state.npz")
    e1.save_state(path)
    dd = np.load(path)
    assert np.iscomplexobj(dd["eigenvectors"])
    e2 = second[0].EPS(*second[1](), problem_type="hep",
                       which="largest_real", nev=3,
                       options=second[0].Options())
    e2.load_state(path)
    e2.solve()
    assert e2.nconv >= 3 and e2.its <= e1.its
    np.testing.assert_allclose(np.real(e2.eigenvalues[:3]),
                               np.real(e1.eigenvalues[:3]), atol=1e-9)


@pytest.mark.parametrize("what", ["block_size", "cheb_block", "sinvert"])
def test_complex_blocked_paths_solve_and_the_device_sinvert_refuses(what):
    """The three complex paths that raised before they were ported: the
    blocked cycle now certifies the closed form, ``cheb_block`` runs the
    plain cycle as the reference does (against the reference's values),
    and the device shift-and-invert still raises: the reference has none
    for a complex operator."""
    offsets, d = gauge_laplacian_2d(12, 11)
    A = tst.DIAOperator(offsets, d, device="cpu")
    eps = tst.EPS(A, problem_type="hep", which="smallest_real", nev=2,
                  options=tst.Options())
    if what == "sinvert":
        eps.set_target(0.0)
        eps.set_st(tst.STSinvertDevice([A], sigma=0.0, iters=50))
        with pytest.raises(NotImplementedError,
                           match="reference has no complex device "
                                 "shift-and-invert"):
            eps.solve()
        return
    if what == "block_size":
        eps.block_size = 2
    else:
        eps.cheb_degree, eps.cheb_block = 20, 2
        je = jst.EPS(jst.DIAOperator(offsets, d), problem_type="hep",
                     which="smallest_real", nev=2, options=jst.Options())
        je.cheb_degree, je.cheb_block = 20, 2
        je.solve()
    eps.solve()
    assert eps.nconv >= 2
    np.testing.assert_allclose(np.sort(eps.eigenvalues[:2]),
                               laplacian_2d_eigs(12, 11, k=2), rtol=0,
                               atol=1e-10)
    if what == "cheb_block":
        assert eps.its == je.its and eps.cheb_stats is None
        np.testing.assert_allclose(eps.eigenvalues[:2],
                                   np.real(je.eigenvalues[:2]), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("name", ["shift", "sinvert", "cayley"])
@pytest.mark.parametrize("operator", ["complex", "real"])
def test_complex_sts_carried_across_packages(name, operator):
    """An ST with a complex shift (on a complex or a real operator), carried
    from the reference by the parity harness, applies the same transform:
    the port's operator is complex (host LU of the complex matrix)."""
    from slepc_tpu_torch import interop
    offsets, d = gauge_laplacian_2d(12, 11)
    if operator == "real":
        d = d.real.copy()
    cls = {"shift": jst.STShift, "sinvert": jst.STSinvert,
           "cayley": jst.STCayley}[name]
    jsto = cls([jst.DIAOperator(offsets, d)], sigma=0.7 + 0.2j)
    tsto = interop.st_from_slepc_tpu(jsto, device="cpu")
    assert tsto.sigma == 0.7 + 0.2j
    op = tsto.op()
    assert op.dtype == torch.complex128
    x = np.random.default_rng(2).standard_normal(d.shape[1]) + 1j * \
        np.random.default_rng(3).standard_normal(d.shape[1])
    y = op.mult(torch.from_numpy(x)).numpy()
    yj = np.asarray(jsto.op().mult(jnp.asarray(x)))
    np.testing.assert_allclose(y, yj, rtol=0, atol=1e-12 * np.abs(yj).max())
    lam = np.array([0.1 + 0.05j, 2.5 - 0.3j])
    np.testing.assert_allclose(tsto.back_transform(lam),
                               jsto.back_transform(lam), rtol=1e-14)


@pytest.mark.parametrize("method", ["gmres", "bicgstab", "direct"])
@pytest.mark.parametrize("form", ["dia", "csr"])
def test_complex_ksp_against_the_reference(method, form):
    """A complex shifted operator (the gauge-transformed Laplacian minus
    0.3 + 0.2i) solved by the iterative KSPs on the port's tensors and by
    the host-direct complex LU, against the reference's KSP and numpy."""
    offsets, d = gauge_laplacian_2d(14, 13)
    d = d.copy()
    d[offsets.index(0)] -= 0.3 + 0.2j
    jA = jst.DIAOperator(offsets, d)
    tA = tst.DIAOperator(offsets, d, device="cpu")
    if form == "csr":
        S = tA.to_scipy()
        jA, tA = jst.AIJOperator.from_scipy(S), tst.from_scipy(S, device="cpu")
    b = np.random.default_rng(4).standard_normal(d.shape[1]) \
        + 1j * np.random.default_rng(5).standard_normal(d.shape[1])
    x = tst.KSP(tA, method=method, rtol=1e-12).solve(
        torch.from_numpy(b)).numpy()
    assert np.iscomplexobj(x)
    want = np.linalg.solve(tst.DIAOperator(offsets, d, device="cpu")
                           .to_dense().numpy(), b)
    np.testing.assert_allclose(x, want, rtol=0, atol=1e-9 * np.abs(want).max())
    xj = np.asarray(jst.KSP(jA, method=method, rtol=1e-12).solve(
        jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-9 * np.abs(want).max())
