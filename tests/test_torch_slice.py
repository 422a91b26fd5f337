"""Spectrum slicing (eps/ks_slice.py) against slepc_tpu's, on the CPU.

Both packages compute all eigenvalues of the same operator in the same
interval.  Checked: the count equals the closed-form census of the
interval, the values agree with the closed form (1e-9) and between the
packages (1e-9), every true residual is below 1e-8, and the number of
``Slice_Factorization`` events equals ``eps.slice_factorizations`` and the
reference's count (one factorization per distinct shift, shared by the
inertia certificate and the solves).  Routes: scanned tridiagonal LDL^T
(laplacian_1d), block-tridiagonal LDL^T (laplacian_2d with n divisible by
its bandwidth), host native LDL^T + LU (a CSR matrix, a GHEP with a
diagonal B on a grid the block route does not take).
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
from slepc_tpu_torch.eps.ks_slice import _ShiftFactorCache
from slepc_tpu_torch.sys.events import get_event


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches keep the AIJ operators this module ran
    (their pytree metadata holds a scipy matrix), and the reference raises
    when a later module of the same process runs another operator of that
    shape (tests/test_eps_krylovschur.py's Markov chain after the one of
    tests/test_torch_nhep.py): drop them when the module ends."""
    yield
    jax.clear_caches()


def _slice_both(make_ops, interval, problem_type="hep", npart=1):
    out = []
    for pkg in (jst, tst):
        ops = make_ops()
        if pkg is tst:
            ops = [interop.operator_from_slepc_tpu(M, device="cpu") for M in ops]
            tst.log_begin()
        eps = pkg.EPS(*ops, problem_type=problem_type, options=pkg.Options())
        eps.set_interval(*interval)
        if npart > 1:
            eps.set_partitions(npart)
        eps.solve()
        out.append(eps)
    events = get_event("Slice_Factorization")
    tst.log_reset()
    je, te = out
    assert te.nconv == je.nconv
    np.testing.assert_allclose(te.eigenvalues, je.eigenvalues, rtol=1e-9)
    assert te.slice_factorizations == events["count"]
    assert te.reason == EPSConvergedReason.CONVERGED_TOL
    assert te._eigenvectors.shape == (te.nconv, ops[0].shape[0])
    assert max(te.compute_error(i) for i in range(te.nconv)) < 1e-8
    return je, te


def _inside(exact, interval):
    return exact[(exact > interval[0]) & (exact < interval[1])]


@pytest.mark.parametrize("npart", [1, 3])
def test_slice_tridiagonal(npart):
    n, interval = 400, (0.5, 0.9)
    je, te = _slice_both(lambda: [jst.laplacian_1d(n)], interval, npart=npart)
    want = _inside(tst.laplacian_1d_eigs(n), interval)
    assert te.nconv == len(want)
    np.testing.assert_allclose(te.eigenvalues, want, rtol=1e-9)
    assert te.slice_factorizations == je.slice_factorizations
    assert te.slice_backends == ("tridiag_device",)


def test_slice_block_tridiagonal():
    nx, ny, interval = 12, 9, (1.0, 2.0)
    je, te = _slice_both(lambda: [jst.laplacian_2d(nx, ny)], interval)
    want = _inside(tst.laplacian_2d_eigs(nx, ny), interval)
    assert te.nconv == len(want) >= 10
    np.testing.assert_allclose(te.eigenvalues, want, rtol=1e-9)
    assert te.slice_factorizations == je.slice_factorizations
    assert te.slice_backends == ("btridiag_device",)
    cache = _ShiftFactorCache(te)
    assert cache.ksp(1.5)._direct.backend == "btridiag_device"
    assert cache.ksp(1.5) is cache.ksp(1.5) and cache.factorizations == 1


def test_slice_host_ldl_generalized():
    nx, ny, interval = 10, 7, (0.8, 1.7)
    n = nx * ny
    bd = 1.0 + 0.3 * np.cos(np.arange(n) * 0.2)
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    As = sp.csr_matrix(np.asarray(jst.laplacian_2d(nx, ny).to_dense()))
    As = As[perm][:, perm].tocsr()
    je, te = _slice_both(
        lambda: [jst.from_scipy(As), jst.DIAOperator((0,), bd[None, :])],
        interval, problem_type="ghep")
    w = sla.eigh(As.toarray(), np.diag(bd), eigvals_only=True)
    want = _inside(w, interval)
    assert te.nconv == len(want) > 5
    np.testing.assert_allclose(te.eigenvalues, want, rtol=1e-9)
    cache = _ShiftFactorCache(te)
    assert cache.ksp(1.0)._direct.backend in ("ldl", "splu")
    assert cache.inertia(1.0) == int(np.sum(w < 1.0))


def test_empty_interval():
    te = tst.EPS(tst.laplacian_1d(50, device="cpu"), problem_type="hep")
    te.set_interval(4.5, 5.0)
    te.solve()
    assert te.nconv == 0 and te._eigenvectors.shape == (0, 50)
    assert te.reason == EPSConvergedReason.CONVERGED_TOL
    assert te.slice_factorizations == 2
    assert te.slice_backends == ("tridiag_device",)
