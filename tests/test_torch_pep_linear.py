"""PEP's ``linear`` and ``qarnoldi`` solvers of slepc_tpu_torch against
slepc_tpu's, on the CPU: tests/test_modules.py:121's damped mass-spring
QEP at target -0.2 in both packages (the port's PEP built from the
reference's by ``interop.pep_from_slepc_tpu``).  A file of their own
beside tests/test_torch_pep.py (toar and the other cases): the
reference's solvers compile for every shape their bases take, several
seconds each on the CPU.

Tolerances as tests/test_torch_pep.py's ``check_quadratic``: the same
nconv and its, the values a bijection within 1e-9, compute_error within
1e-9 of the reference's.
"""

import jax
import pytest
import torch

import slepc_tpu as jst
from test_torch_pep import _qep_problem, check_quadratic


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


@pytest.mark.parametrize("solver", ["linear", "qarnoldi"])
def test_pep_quadratic(solver):
    """tests/test_modules.py:121 by linear (the companion pencil through
    EPS GNHEP, shift-and-invert on P(sigma)) and by qarnoldi."""
    K, C, M = _qep_problem()
    pep = jst.PEP([jst.DenseOperator(A) for A in (K, C, M)], nev=4,
                  solver=solver)
    pep.set_target(-0.2)
    pep.solve()
    check_quadratic(pep)
