"""The EPS solver ``lyapii`` of slepc_tpu_torch (``eps/lyapii.py``, over the
port's LME) against slepc_tpu's, on the CPU.

tests/test_eps_advanced.py:91's case (the rightmost eigenvalue of a
stable 50 x 50 matrix with an isolated critical mode) runs in both
packages on the same matrix, as a dense and as a CSR operator; a complex
operator raises the reference's ValueError in both.

Tolerances: the port walks the reference's iterations (``its`` equal; the
Lyapunov solves agree to rounding), so the eigenvalue agrees to 1e-9 and
the eigenvector up to sign to 1e-8; both within 1e-6 of numpy's rightmost
eigenvalue (the reference test's bound).
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """Drop the reference's jit caches when the module starts and ends."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _stable_matrix():
    """tests/test_eps_advanced.py:91-103's matrix and its rightmost
    eigenvalue."""
    rng = np.random.default_rng(3)
    n = 50
    d = -np.concatenate([[0.4], 2.0 + rng.random(n - 1) * 3])
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    Ad = Q @ np.diag(d) @ Q.T + 0.05 * rng.standard_normal((n, n)) / np.sqrt(n)
    w = np.linalg.eigvals(Ad)
    return Ad, w[np.argmax(w.real)]


@pytest.mark.parametrize("form", ["dense", "csr"])
def test_lyapii_rightmost(form):
    Ad, rightmost = _stable_matrix()
    out = []
    for pkg in (jst, tst):
        kw = {} if pkg is jst else {"device": "cpu"}
        A = pkg.DenseOperator(Ad, **kw) if form == "dense" else \
            pkg.from_scipy(sp.csr_matrix(Ad), **kw)
        eps = pkg.EPS(A, problem_type="nhep", solver="lyapii", nev=1,
                      tol=1e-8, max_it=80)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv >= 1 and te.its == je.its
    got = te.eigenvalues[0]
    assert abs(got - je.eigenvalues[0]) < 1e-9
    assert abs(got.real - rightmost.real) < 1e-6
    assert abs(abs(np.imag(got)) - abs(rightmost.imag)) < 1e-6
    lam, x = te.get_eigenpair(0)
    assert isinstance(x, torch.Tensor) and x.shape == (50,)
    xj = np.asarray(je.get_eigenvectors())[:, 0]
    assert 1 - abs(np.vdot(xj, x.numpy())) < 1e-8
    assert te.compute_error(0) < 1e-7


def test_lyapii_refuses_a_complex_operator_as_the_reference():
    Ad, _ = _stable_matrix()
    for pkg, kw in ((jst, {}), (tst, {"device": "cpu"})):
        eps = pkg.EPS(pkg.DenseOperator(Ad * (1 + 0.1j), **kw),
                      problem_type="nhep", solver="lyapii", nev=1)
        with pytest.raises(ValueError, match="real operators"):
            eps.solve()
