"""JD of slepc_tpu_torch toward an interior target against slepc_tpu's, on
the CPU: tests/test_round2.py:86-100, laplacian_1d(200), target 1.0, the
projected inner GMRES with the fix rule and the 0.5^j inner tolerance.

Held: nconv equal and eigenvalues within 1e-9 of each other and within the
reference test's 1e-7 of the closed form.  Not ``its``: the inner GMRES
amplifies rounding (the two packages' residual estimates part by 1e-15 at
the first outer step and by 1e-2 after 40), so the outer counts may differ
by a few steps.  (JD on the reference's cross-solver problem, where the
counts agree, is in tests/test_torch_lobpcg.py.)
"""

import numpy as np
import pytest
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


def test_jd_interior_target():
    exact = tst.laplacian_1d_eigs(200)
    out = []
    for pkg in (jst, tst):
        A = jst.laplacian_1d(200)
        if pkg is tst:
            A = interop.operator_from_slepc_tpu(A, device="cpu")
        eps = pkg.EPS(A, problem_type="hep", solver="jd", nev=2, ncv=24,
                      tol=1e-8, max_it=300, options=pkg.Options())
        eps.set_target(1.0)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv >= 2 and abs(te.its - je.its) <= 5
    np.testing.assert_allclose(np.sort(te.eigenvalues[:2]),
                               np.sort(je.eigenvalues[:2]), rtol=0, atol=1e-9)
    want = np.sort(exact[np.argsort(np.abs(exact - 1.0))[:2]])
    np.testing.assert_allclose(np.sort(te.eigenvalues[:2]), want, rtol=1e-7)
    assert te.matvecs > te.its  # the inner GMRES's products count
