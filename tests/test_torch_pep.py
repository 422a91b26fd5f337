"""The PEP module of slepc_tpu_torch (``pep/``, ``ds/types.py`` DSPEP)
against slepc_tpu's, on the CPU.

Run in both packages on the same numpy coefficients (the port's PEP built
from the reference's by ``interop.pep_from_slepc_tpu``): the damped
mass-spring QEP of tests/test_modules.py:121 by ``toar`` (eigenvalues
within 1e-9, ``its`` equal; ``linear`` and ``qarnoldi`` on it in
tests/test_torch_pep_linear.py), ``_opnorm_est`` on DIA, dense and CSR
operators, DSPEP, the ``-pep_*`` options, and the CSR and DIA
coefficient forms.

The reference's own solves of the other cases cost 6-25 s each on the CPU
(a compile for every shape its compact basis takes), so these cases hold
the port to the ground truth the reference test itself checks, at its
bound: tests/test_modules_advanced.py:55 (``jd``), :135 (``stoar``), :156
(the Chebyshev basis, with ComplexWarning raised as an error: the
reference casts a complex combination into a real eigenvector block),
:212 (``refine(scheme="multiple")``), :266 (the interval by inertia,
qslice), tests/test_round2.py:131 (Q-Arnoldi on CSR), :163 (diagonal
scaling), tests/test_reference_golden.py:82 (the published digits of
src/pep/tests/test1.c) and the acoustic QEP of examples/ex_pep_acoustic.py
(complex DIA, target 0.5i).  ``ciss`` (tests/test_modules_advanced.py:67)
runs through the port's NEP, beside the reference's.
"""

import warnings

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu.pep.toar import _opnorm_est as j_opnorm_est
from slepc_tpu_torch import interop
from slepc_tpu_torch.pep.toar import _opnorm_est as t_opnorm_est


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """Drop the reference's jit caches when the module starts and ends, and
    compile its ops with XLA's optimizations off while it runs: the
    reference compiles an op for every shape its bases take, and an
    unoptimized compile is several times cheaper (the results agree to
    rounding)."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)
    jax.clear_caches()


def _tridiag(n, d, o):
    return np.diag(np.full(n, d)) + np.diag(np.full(n - 1, o), 1) \
        + np.diag(np.full(n - 1, o), -1)


def _qep_problem(n=40):
    """tests/test_modules.py:107: (lambda^2 M + lambda C + K) x = 0."""
    return _tridiag(n, 2.0, -1.0), _tridiag(n, 0.4, -0.1), np.eye(n)


def _companion_eigs(K, C, M):
    n = K.shape[0]
    A = np.block([[np.zeros((n, n)), np.eye(n)], [-K, -C]])
    B = np.block([[np.eye(n), np.zeros((n, n))], [np.zeros((n, n)), M]])
    return sla.eigvals(A, B)


def _dense(*mats):
    return [tst.DenseOperator(A, device="cpu") for A in mats]


def _match(got, want, tol):
    """Each computed value within tol of some value of ``want``."""
    for g in got:
        assert np.min(np.abs(np.asarray(want) - g)) < tol, g


def _same_values(got, want, tol):
    """got and want are the same values (a bijection) within tol."""
    want = list(np.asarray(want))
    for g in np.asarray(got):
        j = int(np.argmin([abs(g - w) for w in want]))
        assert abs(g - want.pop(j)) < tol, g


def _residuals(pep, mats, k):
    out = []
    for i in range(k):
        lam, x = pep.get_eigenpair(i)
        x = x.numpy()
        r = sum(lam ** j * (A @ x) for j, A in enumerate(mats))
        out.append(np.linalg.norm(r) / np.linalg.norm(x))
    return max(out)


@pytest.fixture(scope="module")
def toar_reference():
    """The reference's toar solve of tests/test_modules.py:121's QEP at
    target -0.2 (its ``linear`` and ``qarnoldi`` twins are in
    tests/test_torch_pep_linear.py: each reference solver compiles for
    every shape its basis takes)."""
    K, C, M = _qep_problem()
    pep = jst.PEP([jst.DenseOperator(A) for A in (K, C, M)], nev=4,
                  solver="toar")
    pep.set_target(-0.2)
    pep.solve()
    return pep


def test_pep_quadratic(toar_reference):
    """tests/test_modules.py:121 by toar."""
    check_quadratic(toar_reference)


def check_quadratic(jpep):
    """The port's twin of a reference PEP solve of the damped QEP: the same
    nconv and its, the same four values (a bijection within 1e-9:
    conjugate pairs tie on the target distance), compute_error within 1e-9
    of the reference's and below 1e-7, the values in the dense spectrum."""
    K, C, M = _qep_problem()
    wref = _companion_eigs(K, C, M)
    pep = interop.pep_from_slepc_tpu(jpep, device="cpu")
    pep.solve()
    assert pep.nconv == jpep.nconv >= 4 and pep.its == jpep.its
    _same_values(pep.eigenvalues[:4], jpep.eigenvalues[:4], 1e-9)
    for i in range(4):
        assert pep.compute_error(i) < 1e-7
        assert abs(pep.compute_error(i) - jpep.compute_error(i)) < 1e-9
    _match(pep.eigenvalues[:4], wref, 1e-6)
    X = pep.get_eigenvectors()
    assert isinstance(X, torch.Tensor) and X.shape == (40, pep.nconv)


def test_pep_jd():
    """tests/test_modules_advanced.py:55, in both packages: the same nconv
    and its, and the same values up to conjugation (the conjugate pairs tie
    on the target distance, and which one the Davidson loop follows turns
    on rounding); the values within 1e-6 of the dense spectrum (the
    reference test's bound) at a backward error below 1e-7."""
    K, C, M = _qep_problem(30)
    C = 0.4 * np.eye(30)
    wref = _companion_eigs(K, C, M)
    jpep = jst.PEP([jst.DenseOperator(A) for A in (K, C, M)], nev=2,
                   solver="jd", max_it=300)
    jpep.set_target(-0.2)
    pep = interop.pep_from_slepc_tpu(jpep, device="cpu")
    jpep.solve()
    pep.solve()
    assert pep.nconv == jpep.nconv >= 2 and pep.its == jpep.its
    for g in pep.eigenvalues[: pep.nconv]:
        assert np.min(np.abs(np.concatenate(
            [jpep.eigenvalues, np.conj(jpep.eigenvalues)]) - g)) < 1e-9, g
    for i in range(2):
        assert pep.compute_error(i) < 1e-7
    _match(pep.eigenvalues[:2], wref, 1e-6)


def test_pep_stoar_overdamped():
    """tests/test_modules_advanced.py:135: STOAR through the GHIEP arm."""
    n = 60
    K = _tridiag(n, 2.0, -1.0)
    C = 10 * np.eye(n) + 0.5 * (np.eye(n, k=1) + np.eye(n, k=-1))
    M = np.eye(n)
    wref = _companion_eigs(K, C, M)
    pep = tst.PEP(_dense(K, C, M), nev=4, solver="stoar")
    pep.set_target(-0.4)
    pep.solve()
    assert pep.nconv >= 4
    for i in range(4):
        assert pep.compute_error(i) < 1e-8
    _match(pep.eigenvalues[:4], wref, 1e-8)


def test_pep_chebyshev_basis():
    """tests/test_modules_advanced.py:156: Chebyshev-basis coefficients
    converted exactly; no complex value is cast to real on the way
    (ComplexWarning raised as an error)."""
    rng = np.random.default_rng(0)
    n = 30
    B0 = rng.standard_normal((n, n))
    B0 = B0 + B0.T + 8 * np.eye(n)
    B1 = 0.2 * np.eye(n)
    B2 = np.eye(n)
    A0, A1, A2 = B0 - B2, B1, 2 * B2
    wref = _companion_eigs(A0, A1, A2)
    pep = tst.PEP(_dense(B0, B1, B2), nev=4, solver="toar",
                  basis="chebyshev")
    pep.set_target(1.5)
    with warnings.catch_warnings():
        warnings.simplefilter("error", np.exceptions.ComplexWarning)
        pep.solve()
    assert pep.nconv >= 4
    _match(pep.eigenvalues[:4], wref, 1e-8)
    assert _residuals(pep, (A0, A1, A2), 4) < 1e-8


def test_pep_refine_simple_and_multiple():
    """tests/test_modules_advanced.py:212: perturbed pairs of a complex
    target recovered by the invariant-pair ('multiple') refinement, then
    polished by the per-pair ('simple') one."""
    n = 30
    rng = np.random.default_rng(1)
    K, C, M = _tridiag(n, 2.0, -1.0), 0.3 * np.eye(n), np.eye(n)
    pep = tst.PEP(_dense(K, C, M), nev=4, solver="toar")
    pep.set_target(-0.15 + 1.0j)
    pep.solve()
    assert pep.nconv >= 4
    lam_good = pep.eigenvalues[:4].copy()
    pep.eigenvalues = pep.eigenvalues.astype(complex)
    X = pep._eigenvectors.to(torch.complex128)
    pep.eigenvalues[:4] *= (1 + 1e-5)
    X[:4] += 1e-5 * torch.from_numpy(rng.standard_normal((4, n))
                                     + 1j * rng.standard_normal((4, n)))
    pep._eigenvectors = X
    pep.refine(steps=3, scheme="multiple")
    assert _residuals(pep, (K, C, M), 4) < 1e-10
    for lam in lam_good:
        assert np.min(np.abs(pep.eigenvalues[:4] - lam)) < 1e-8 * abs(lam)
    pep.eigenvalues[:4] *= (1 + 1e-7)
    pep.refine(steps=3)
    assert _residuals(pep, (K, C, M), 4) < 1e-10


def test_pep_qslice_interval():
    """tests/test_modules_advanced.py:266: every eigenvalue of a
    hyperbolic QEP in [-0.9, -0.3], counted by the inertia of P(sigma)."""
    n = 40
    rng = np.random.default_rng(0)
    K = _tridiag(n, 2.0, -1.0)
    C = np.diag(5.0 + rng.random(n))
    M = np.eye(n)
    w = _companion_eigs(K, C, M)
    assert np.abs(w.imag).max() < 1e-10
    wr = np.sort(w.real)
    inside = wr[(wr > -0.9) & (wr < -0.3)]
    pep = tst.PEP(_dense(K, C, M), solver="stoar", tol=1e-9)
    pep.set_interval(-0.9, -0.3)
    pep.solve()
    assert pep.nconv == len(inside)
    np.testing.assert_allclose(np.sort(pep.eigenvalues), inside, rtol=1e-7)


def _damped_csr(n):
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    return T


def test_qarnoldi_true_recurrence():
    """tests/test_round2.py:131: Q-Arnoldi on CSR coefficients matches the
    dense companion eigenvalues nearest the target."""
    n = 150
    T = _damped_csr(n)
    M = sp.eye(n, format="csr")
    C = sp.csr_matrix(0.1 * T + 0.3 * sp.eye(n))
    K = sp.csr_matrix(2.0 * T)
    lam_all = _companion_eigs(K.toarray(), C.toarray(), M.toarray())
    target = -0.15 + 0j
    close = lam_all[np.argsort(np.abs(lam_all - target))][:4]
    pep = tst.PEP([tst.from_scipy(A, device="cpu") for A in (K, C, M)],
                  nev=4, solver="qarnoldi", tol=1e-9)
    pep.set_target(complex(target))
    pep.solve()
    assert pep.nconv >= 4
    assert type(pep.mats[0]).__name__ == "AIJOperator"
    _match(pep.eigenvalues[:4], close, 1e-8)
    assert _residuals(pep, (K, C, M), 1) < 1e-7


def test_pep_diagonal_scaling_backward_error():
    """tests/test_round2.py:163: PEP_SCALE_DIAGONAL balancing improves the
    backward error on a badly row/column-scaled QEP by orders of
    magnitude; the balanced solve keeps the coefficients on the device."""
    rng = np.random.default_rng(0)
    n = 120
    T = _damped_csr(n)
    D = sp.diags(10.0 ** rng.uniform(-4, 4, n))
    K = sp.csr_matrix(D @ (2.0 * T) @ D)
    C = sp.csr_matrix(D @ (0.1 * T + 0.3 * sp.eye(n)) @ D)
    M = sp.csr_matrix(D @ D)

    def backres(pep):
        out = []
        for i in range(min(pep.nconv, 3)):
            lam, x = pep.get_eigenpair(i)
            x = x.numpy()
            r = K @ x + lam * (C @ x) + lam ** 2 * (M @ x)
            den = (abs(K).sum(1).max() + abs(lam) * abs(C).sum(1).max()
                   + abs(lam) ** 2 * abs(M).sum(1).max())
            out.append(np.linalg.norm(r) / den)
        return max(out)

    res = {}
    for scale in ("none", "diagonal"):
        pep = tst.PEP([tst.from_scipy(A, device="cpu") for A in (K, C, M)],
                      nev=4, solver="toar", tol=1e-9, scale=scale)
        pep.set_target(-0.15 + 0j)
        pep.solve()
        assert pep.nconv >= 3 and pep.scale == scale
        res[scale] = backres(pep)
    assert res["diagonal"] < 0.1 * res["none"]


def test_pep_reference_test1_digits():
    """tests/test_reference_golden.py:82 (src/pep/tests/test1.c, N = 110):
    -1.16404+-1.65363i, -0.51784+-1.31039i to all 5 printed decimals, by
    ``linear`` with largest magnitude (CSR K, C and a diagonal M)."""
    n, m = 10, 11
    N = n * m
    K = sp.lil_matrix((N, N))
    C = sp.lil_matrix((N, N))
    for II in range(N):
        i, j = II // n, II % n
        if i > 0:
            K[II, II - n] = -1.0
        if i < m - 1:
            K[II, II + n] = -1.0
        if j > 0:
            K[II, II - 1] = -1.0
            C[II, II - 1] = -1.0
        if j < n - 1:
            K[II, II + 1] = -1.0
            C[II, II + 1] = -1.0
        K[II, II] = 4.0
        C[II, II] = 2.0
    M = tst.DiagonalOperator(np.arange(1, N + 1).astype(np.float64),
                             device="cpu")
    pep = tst.PEP([tst.from_scipy(K.tocsr(), device="cpu"),
                   tst.from_scipy(C.tocsr(), device="cpu"), M],
                  nev=4, ncv=40, which="largest_magnitude", tol=1e-9,
                  solver="linear")
    pep.solve()
    assert pep.nconv >= 4
    got = pep.eigenvalues[:4]
    got = got[np.lexsort((np.sign(got.imag), np.round(-got.real, 6)))]
    want = np.asarray([-1.16404 + 1.65363j, -1.16404 - 1.65363j,
                       -0.51784 + 1.31039j, -0.51784 - 1.31039j])
    want = want[np.lexsort((np.sign(want.imag), np.round(-want.real, 6)))]
    for g, w in zip(got, want):
        assert f"{g.real:.5f}" == f"{w.real:.5f}", (g, w)
        assert f"{abs(g.imag):.5f}" == f"{abs(w.imag):.5f}", (g, w)


def test_pep_acoustic_complex_target():
    """examples/ex_pep_acoustic.py at n = 200 (the example's 600 makes the
    dense companion pencil of the check a minute's work on one thread):
    complex DIA coefficients,
    TOAR at target 0.5i (K2c / K3c / K4c on a card); the values near the
    target against the dense companion pencil, the residuals."""
    n = 200
    h = 1.0 / n
    main = np.full(n, 2.0 / h)
    main[-1] = 1.0 / h
    up, lo = np.zeros(n), np.zeros(n)
    up[: n - 1] = -1.0 / h
    lo[1:] = -1.0 / h
    cvec = np.zeros(n, complex)
    cvec[-1] = 2j * np.pi
    mvec = np.full(n, 4.0 * np.pi ** 2 * h, complex)
    mvec[-1] = 2.0 * np.pi ** 2 * h
    mats = [tst.DIAOperator((-1, 0, 1), np.stack([lo, main, up]).astype(
        complex), device="cpu"), tst.DIAOperator((0,), cvec[None], device="cpu"),
        tst.DIAOperator((0,), mvec[None], device="cpu")]
    pep = tst.PEP(mats, nev=4, ncv=40, solver="toar",
                  which="target_magnitude", target=0.5j, tol=1e-9)
    pep.solve()
    assert pep.nconv >= 4
    dense = [m.to_dense().numpy() for m in mats]
    wref = _companion_eigs(*dense)
    near = wref[np.argsort(np.abs(wref - 0.5j))][:4]
    _match(near, pep.eigenvalues[: pep.nconv], 1e-9)
    for i in range(4):
        assert pep.compute_error(i) < 1e-9
    assert _residuals(pep, dense, 4) < 1e-7


def test_bad_settings_raise_value_error():
    """An unknown extraction kind or FNCombine operation raises ValueError
    (the reference asserts, which -O removes)."""
    K, C, M = _qep_problem(10)
    with pytest.raises(ValueError, match="extraction 'best-of'"):
        tst.PEP(_dense(K, C, M)).set_extraction("best-of")
    with pytest.raises(ValueError, match="FNCombine operation 'subtract'"):
        tst.FNCombine("subtract", tst.FNExp(), tst.FNExp())


def test_pep_ciss():
    """tests/test_modules_advanced.py:67: PEP's contour solver runs the
    port's NEP ciss on T(z) = P(z) (monomial FNRational functions), beside
    the reference's: the same nconv, values within 1e-9, and each pair a
    root of the dense companion pencil."""
    n = 30
    K = _tridiag(n, 2.0, -1.0)
    C, M = np.eye(n) * 0.4, np.eye(n)
    jpep = jst.PEP([jst.DenseOperator(A) for A in (K, C, M)], nev=2,
                   solver="ciss")
    jpep.set_target(-0.2)
    jpep.set_rg(jst.RGEllipse(center=-0.2, radius=0.4))
    tpep = interop.pep_from_slepc_tpu(jpep, device="cpu")
    jpep.solve()
    tpep.solve()
    assert tpep.nconv == jpep.nconv >= 2
    k = tpep.nconv
    np.testing.assert_allclose(np.asarray(tpep.eigenvalues[:k], complex),
                               np.asarray(jpep.eigenvalues[:k], complex),
                               rtol=0, atol=1e-9)
    wref = _companion_eigs(K, C, M)
    for i in range(2):
        assert tpep.compute_error(i) < 1e-7
        assert np.min(np.abs(wref - tpep.eigenvalues[i])) < 1e-6
    assert tpep.get_eigenvectors().shape == (n, k)


@pytest.mark.parametrize("form", ["dia", "dense", "csr"])
def test_opnorm_est_matches_the_reference(form):
    """toar's backward-error scale: the inf-norm on the device for DIA and
    dense operators, the values' Frobenius norm for CSR, as the
    reference's (one scalar read)."""
    jA = jst.laplacian_2d(9, 8)
    if form == "dense":
        jA = jst.DenseOperator(np.asarray(jA.to_dense()) + np.eye(72, k=3))
    elif form == "csr":
        jA = jst.from_scipy(jA.to_scipy() * 3.0)
    tA = interop.operator_from_slepc_tpu(jA, device="cpu")
    assert type(tA).__name__ == type(jA).__name__
    assert t_opnorm_est(tA) == pytest.approx(j_opnorm_est(jA), rel=1e-14)


def test_dspep_matches_the_reference():
    rng = np.random.default_rng(4)
    k = 6
    coeffs = [rng.standard_normal((k, k)) for _ in range(3)]
    lj, Xj = jst.DSPEP().solve(coeffs)
    lt, Xt = tst.DSPEP().solve(coeffs)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(Xt, Xj)
    assert tst.DS.create("pep").__class__ is tst.DSPEP
    for i in np.flatnonzero(np.isfinite(lt)):
        r = sum(lt[i] ** j * (coeffs[j] @ Xt[:, i]) for j in range(3))
        assert np.linalg.norm(r) < 1e-8 * max(1.0, abs(lt[i]) ** 2)


def test_pep_options_match_the_reference():
    cli = ("-pep_nev 3 -pep_ncv 17 -pep_max_it 9 -pep_tol 1e-7 "
           "-pep_type qarnoldi -pep_basis chebyshev -pep_scale scalar "
           "-pep_target 0.25")
    got = []
    for pkg, kw in ((jst, {}), (tst, {"device": "cpu"})):
        pkg.set_global_options(cli)
        try:
            A = pkg.laplacian_1d(10, **kw)
            p = pkg.PEP([A, A, A])
            got.append((p.nev, p.ncv, p.max_it, p.tol, p.solver, p.basis,
                        p.scale, p.target, p.which.value))
        finally:
            pkg.set_global_options(pkg.Options())
    assert got[0] == got[1]
    assert got[1][4] == "qarnoldi" and got[1][8] == "target_magnitude"


def test_operator_explicit_forms():
    """``LinearOperator.explicit``: the host matrix of DIA, CSR, dense,
    diagonal and identity operators and of scaled or summed ones; None for
    a shell and for any algebra over one (P(sigma)'s routing question)."""
    A = tst.laplacian_1d(12, device="cpu")
    Ad = A.to_dense().numpy()
    d = np.arange(1.0, 13.0)
    shell = tst.ShellOperator((12, 12), torch.float64, A.mult, A.mult,
                              device="cpu")
    forms = {
        "dia": (A, Ad),
        "csr": (tst.from_scipy(sp.csr_matrix(Ad), device="cpu"), Ad),
        "dense": (tst.DenseOperator(Ad, device="cpu"), Ad),
        "diagonal": (tst.DiagonalOperator(d, device="cpu"), np.diag(d)),
        "identity": (tst.IdentityOperator(12, device="cpu"), np.eye(12)),
        "scaled": (A * 2.5, 2.5 * Ad),
        "sum": (A - tst.DiagonalOperator(d, device="cpu") * 0.5j,
                Ad - 0.5j * np.diag(d)),
    }
    for name, (op, want) in forms.items():
        M = op.explicit()
        M = M.toarray() if sp.issparse(M) else M
        np.testing.assert_array_equal(M, want, err_msg=name)
    assert shell.explicit() is None
    assert (A + shell).explicit() is None and (shell * 2.0).explicit() is None


def test_pep_stoar_shell_coefficient():
    """A shell coefficient sends STOAR's pencil sinvert to BiCGStab on the
    shell pencil (as P(sigma) of the other solvers), where an explicit one
    is factorized: the same values, both certified."""
    n = 60
    K = _tridiag(n, 2.0, -1.0)
    C = 10 * np.eye(n) + 0.5 * (np.eye(n, k=1) + np.eye(n, k=-1))
    Kt = torch.from_numpy(K)
    shell = tst.ShellOperator((n, n), torch.float64, lambda x: Kt @ x,
                              lambda x: Kt @ x, device="cpu")
    vals = []
    for Kop in (_dense(K)[0], shell):
        pep = tst.PEP([Kop] + _dense(C, np.eye(n)), nev=4, solver="stoar")
        pep.set_target(-0.4)
        pep.solve()
        assert pep.nconv >= 4
        for i in range(4):
            assert pep.compute_error(i) < 1e-8
        vals.append(pep.eigenvalues[:4])
    _same_values(vals[1], vals[0], 1e-9)
