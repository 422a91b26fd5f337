"""PEP's symmetric solvers of slepc_tpu_torch against slepc_tpu's, on the
CPU: ``stoar`` (tests/test_modules_advanced.py:135, the overdamped QEP at
target -0.4) and the interval by inertia, qslice (:266, every eigenvalue
of a hyperbolic QEP in [-0.9, -0.3]), each run in both packages on the
same numpy coefficients (the port's PEP built from the reference's by
``interop.pep_from_slepc_tpu``).  tests/test_torch_pep.py holds the same
cases to the dense companion spectrum.

Tolerances: both packages walk the same steps (``nconv`` and ``its``
equal), so the values agree to 1e-9 and the backward errors to 1e-9.
"""

import jax
import numpy as np
import pytest
import torch

import slepc_tpu as jst
from slepc_tpu_torch import interop
from test_torch_pep import _same_values, _tridiag


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


def _both(jpep):
    pep = interop.pep_from_slepc_tpu(jpep, device="cpu")
    jpep.solve()
    pep.solve()
    assert pep.nconv == jpep.nconv and pep.its == jpep.its
    return pep


def test_pep_stoar_matches_the_reference():
    n = 60
    K = _tridiag(n, 2.0, -1.0)
    C = 10 * np.eye(n) + 0.5 * (np.eye(n, k=1) + np.eye(n, k=-1))
    jpep = jst.PEP([jst.DenseOperator(A) for A in (K, C, np.eye(n))],
                   nev=4, solver="stoar")
    jpep.set_target(-0.4)
    pep = _both(jpep)
    assert pep.nconv >= 4
    _same_values(pep.eigenvalues[: pep.nconv], jpep.eigenvalues[: jpep.nconv],
                 1e-9)
    for i in range(4):
        assert abs(pep.compute_error(i) - jpep.compute_error(i)) < 1e-9


def test_pep_qslice_matches_the_reference():
    n = 40
    rng = np.random.default_rng(0)
    K = _tridiag(n, 2.0, -1.0)
    C = np.diag(5.0 + rng.random(n))
    jpep = jst.PEP([jst.DenseOperator(A) for A in (K, C, np.eye(n))],
                   solver="stoar", tol=1e-9)
    jpep.set_interval(-0.9, -0.3)
    pep = _both(jpep)
    assert pep.nconv > 0
    np.testing.assert_allclose(np.sort(pep.eigenvalues.real),
                               np.sort(np.asarray(jpep.eigenvalues).real),
                               rtol=0, atol=1e-9)
    assert np.abs(pep.eigenvalues.imag).max(initial=0) < 1e-9
    for i in range(pep.nconv):
        lam, x = pep.get_eigenpair(i)
        assert pep.compute_error(i) < 1e-8
