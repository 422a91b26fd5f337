"""The Krylov-Schur restart of PEP's ``toar`` and ``qarnoldi`` in
slepc_tpu_torch, held against slepc_tpu's on a problem where they
diverge: bench.py:1169-1185's damped quadratic on a 30 x 30 grid
(K = laplacian_2d(30, 30), C = diag(0.1 + 0.05 sin(10^-2 i)), M = I),
nev 3 at sigma = 0 (largest magnitude), tol 1e-6.

The reference keeps only the diagonal blocks of the rotated Hessenberg
when it restarts after a lock, dropping the locked columns' coupling.
Q-Arnoldi rebuilds its bottom blocks through H, so there its recurrence
grows without bound and the reference raises on a non-finite H; TOAR's
pairs locked in a later restart come back with a backward error above
tol.  The port keeps the whole rotated relation: every pair it returns,
those locked after the first restart included, has compute_error <= tol.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import slepc_tpu as jst
from slepc_tpu_torch import interop

TOL = 1e-6


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


def _damped_quadratic(solver, **kw):
    side = 30
    n = side * side
    c = 0.1 + 0.05 * np.sin(1e-2 * np.arange(n))
    mats = [jst.laplacian_2d(side, side), jst.DIAOperator((0,), c[None]),
            jst.DIAOperator((0,), np.ones((1, n)))]
    return jst.PEP(mats, nev=3, solver=solver, which="largest_magnitude",
                   tol=TOL, **kw)


def _port_certifies_later_locks(solver):
    """The port's pairs all reach compute_error <= tol, and some of them
    locked after the first restart (more than a one-cycle run locks)."""
    first = interop.pep_from_slepc_tpu(_damped_quadratic(solver, max_it=1),
                                       device="cpu")
    first.solve()
    pep = interop.pep_from_slepc_tpu(_damped_quadratic(solver), device="cpu")
    pep.solve()
    assert pep.its >= 2 and pep.nconv >= 3
    assert pep.nconv > first.nconv
    errs = [pep.compute_error(i) for i in range(pep.nconv)]
    assert max(errs) <= TOL, errs
    return pep


def test_qarnoldi_restart_keeps_the_locked_coupling():
    pep = _port_certifies_later_locks("qarnoldi")
    jpep = _damped_quadratic("qarnoldi")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(ValueError, match="infs or NaNs"):
            jpep.solve()  # the recorded divergence: the reference's H overflows
    assert np.isfinite(pep.eigenvalues).all()


def test_toar_restart_keeps_the_locked_coupling():
    pep = _port_certifies_later_locks("toar")
    jpep = _damped_quadratic("toar")
    jpep.solve()
    assert jpep.nconv == pep.nconv and jpep.its == pep.its
    # the same values; the reference's later locks fail its own tol
    for g in pep.eigenvalues:
        assert np.min(np.abs(jpep.eigenvalues - g)) < 1e-8, g
    jerrs = [jpep.compute_error(i) for i in range(jpep.nconv)]
    assert max(jerrs) > 10 * TOL, jerrs
