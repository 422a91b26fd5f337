"""GD and JD of slepc_tpu_torch (``eps/davidson.py``, the GD cycle of
``eps/gd_jit.py``) against slepc_tpu's, on the CPU.

The reference's own cases, on both packages with the same operators and
the same numpy start vectors (``default_rng(0)``):
  * tests/test_round3.py:71-92: GD on a variable-diagonal tridiagonal CSR
    matrix, through the GD cycle and through the host loop, at 480 rows
    rather than 500: the reference's GD cycle keeps the CSR operators it
    ran in its jit cache, and a second CSR operator of the same shape in
    one process makes it raise (comparing their scipy metadata; dropping
    the caches does not help), so this module keeps clear of that test's
    shape, which may run after it on the same worker;
  * tests/test_round2.py:102-114: GD with two corrections a step on
    laplacian_2d(24, 23);
  * tests/test_eps_advanced.py:289-305: GD with harmonic extraction toward
    the target 4.8 of diag(1..100);
plus the GD cycle at the largest end, on a shell operator (no diagonal to
read: the identity preconditioner) and with the options
``-eps_gd_blocksize`` / ``-eps_jd_fix``.

Held: nconv equal, eigenvalues within 1e-9 of each other, and ``its`` and
``expansions`` equal.  JD toward an interior target is in
tests/test_torch_jd.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
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
    assert te.its == je.its and te.expansions == je.expansions
    k = te.nconv
    np.testing.assert_allclose(np.sort(te.eigenvalues[:k]),
                               np.sort(np.real(je.eigenvalues[:k])),
                               rtol=0, atol=1e-9)
    assert te._eigenvectors.shape == (k, A.shape[0])
    return je, te


def _tridiag_csr(n=480):
    d = np.linspace(1, 50, n)
    return sp.diags([d, -np.ones(n - 1), -np.ones(n - 1)], [0, -1, 1],
                    format="csr")


@pytest.mark.parametrize("fused", [True, False])
def test_gd_cycle_and_host_loop(fused):
    A = _tridiag_csr()
    exact = np.sort(np.linalg.eigvalsh(A.toarray()))[:3]

    def configure(eps, pkg, op):
        eps.set_st(pkg.STPrecond([op]))
        eps.gd_fused = fused

    je, te = _both(lambda: jst.from_scipy(A), configure, problem_type="hep",
                   which="smallest_real", nev=3, solver="gd", ncv=20,
                   max_it=2000, tol=1e-8)
    assert te.nconv >= 3
    np.testing.assert_allclose(np.sort(te.eigenvalues[:3]), exact, rtol=1e-7)
    assert max(te.compute_error(i) for i in range(3)) < 1e-8
    # the cycle runs ncv - j0 expansions a cycle, the host loop one a step
    assert (te.expansions > te.its) == fused


def test_gd_cycle_largest_on_a_shell_operator():
    """The GD cycle at the largest end; a shell operator has no diagonal to
    read, so its preconditioner is the identity, as in the reference."""
    A = _tridiag_csr(300)
    exact = np.sort(np.linalg.eigvalsh(A.toarray()))[::-1][:3]
    out = []
    for pkg in (jst, tst):
        if pkg is jst:
            import jax.numpy as jnp

            Aj = jnp.asarray(A.toarray())
            op = pkg.ShellOperator(A.shape, np.float64, lambda x: Aj @ x)
        else:
            At = torch.from_numpy(A.toarray())
            op = pkg.ShellOperator(A.shape, torch.float64, lambda x: At @ x,
                                   device="cpu")
        eps = pkg.EPS(op, problem_type="hep", which="largest_real", nev=3,
                      solver="gd", ncv=16, max_it=3000, tol=1e-9,
                      options=pkg.Options())
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv >= 3
    assert te.its == je.its and te.expansions == je.expansions
    np.testing.assert_allclose(te.eigenvalues[:3], je.eigenvalues[:3],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(te.eigenvalues[:3], exact, rtol=1e-9)


def test_gd_two_corrections_a_step():
    """tests/test_round2.py:102, with ``-eps_gd_blocksize 2`` on the port."""
    exact = tst.laplacian_2d_eigs(24, 23, k=3)
    out = []
    for pkg in (jst, tst):
        A = jst.laplacian_2d(24, 23)
        if pkg is tst:
            A = interop.operator_from_slepc_tpu(A, device="cpu")
            opts = tst.Options.from_cli("-eps_gd_blocksize 2")
        else:
            opts = jst.Options()
        eps = pkg.EPS(A, problem_type="hep", solver="gd",
                      which="smallest_real", nev=3, ncv=24, tol=1e-8,
                      max_it=400, options=opts)
        if pkg is jst:
            eps.davidson_bs = 2
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.davidson_bs == 2
    assert te.nconv == je.nconv >= 3
    assert te.its == je.its and te.expansions == je.expansions
    np.testing.assert_allclose(np.sort(te.eigenvalues[:3]),
                               np.sort(je.eigenvalues[:3]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.sort(te.eigenvalues[:3]), exact, rtol=1e-6)


def test_gd_harmonic_target():
    """tests/test_eps_advanced.py:289: harmonic extraction, target 4.8."""
    Ad = np.diag(np.arange(1.0, 101.0))

    def configure(eps, pkg, A):
        eps.set_target(4.8)
        eps.set_st(pkg.STPrecond([A], sigma=4.8))
        eps.set_which("target_magnitude")
        eps.set_extraction("harmonic")

    je, te = _both(lambda: jst.DenseOperator(Ad), configure,
                   problem_type="hep", solver="gd", nev=4, ncv=20,
                   max_it=600, tol=1e-9)
    assert te.nconv >= 4
    got = set(np.round(te.eigenvalues[:4]).astype(int))
    assert {4, 5} <= got
    for lam in te.eigenvalues[:4]:
        assert abs(lam - round(lam)) < 1e-7


def test_davidson_options_and_attributes():
    eps = tst.EPS(tst.laplacian_1d(20, device="cpu"), problem_type="hep",
                  solver="jd", options=tst.Options.from_cli(
                      "-eps_jd_blocksize 3 -eps_jd_fix 0.05"))
    assert eps.davidson_bs == 3 and eps.jd_fix == 0.05
    assert (eps.gd_fused, eps.davidson_plusk, eps.jd_inner_maxit) == \
        (True, 1, 24)
    assert (eps.expansions, eps.matvecs) == (0, 0)
