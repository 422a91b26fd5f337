"""The inertia of a complex Hermitian matrix (``ksp/direct.py``) and the
spectrum slicing that counts with it (``eps/ks_slice.py``), on the CPU.

``tridiag_inertia`` runs the Sturm recurrence on Re(d) and |e|^2, and
``banded_ldlt_inertia`` an LDL^H on a band of A's dtype with real pivots
and the conjugate in the update.  The reference squares e, compares a
complex pivot with 0 and writes A into a real band
(``slepc_tpu/ksp/direct.py:261-277, :296``), so it counts the inertia of
Re(A): on the gauge-transformed laplacian_2d(12, 9) over (1.0, 2.0) its
slicing returns 7 of the 10 values and reports CONVERGED_TOL (held here
as a recorded divergence, ROADMAP queue 3, F1), and on laplacian_1d(300)
over (0.5, 0.9) it returns all 25 but reports DIVERGED_ITS after running
to max_it (40 s, so not rerun here).  The port is held to the closed
forms.
"""

import numpy as np
import pytest
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu_torch.ksp.direct import (DirectSolver, banded_ldlt_inertia,
                                        tridiag_inertia)


def gauge(offsets, diags, seed=11):
    """U A U^H for U = diag(exp(2 pi i u)), u from default_rng(seed), as
    tests/test_torch_complex.py builds it: same offsets and spectrum,
    complex Hermitian when A is symmetric."""
    d = np.asarray(diags).astype(np.complex128)
    n = d.shape[1]
    phi = 2 * np.pi * np.random.default_rng(seed).random(n)
    for k, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, n - o)
        d[k, lo:hi] *= np.exp(1j * (phi[lo:hi] - phi[lo + o:hi + o]))
    return d


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    "2d-12x9": (lambda: jst.laplacian_2d(12, 9), (1.0, 2.0),
                lambda: tst.laplacian_2d_eigs(12, 9), 7,
                "CONVERGED_TOL"),
    "1d-300": (lambda: jst.laplacian_1d(300), (0.5, 0.9),
               lambda: tst.laplacian_1d_eigs(300), None, None),
}


def _gauged(make):
    L = make()
    return tuple(L.offsets), gauge(tuple(L.offsets), np.asarray(L.diags))


@pytest.mark.parametrize("case", list(CASES))
def test_complex_slicing_returns_every_value(case):
    make, (a, b), eigs, ref_nconv, ref_reason = CASES[case]
    offsets, d = _gauged(make)
    exact = np.sort(np.asarray(eigs()))
    want = exact[(exact > a) & (exact < b)]
    eps = tst.EPS(tst.DIAOperator(offsets, d, device="cpu"),
                  problem_type="hep", options=tst.Options())
    eps.set_interval(a, b)
    eps.solve()
    assert eps.nconv == len(want)
    assert eps.reason.name == "CONVERGED_TOL"
    np.testing.assert_allclose(np.sort(np.real(eps.eigenvalues[:eps.nconv])),
                               want, rtol=0, atol=1e-10)
    if ref_nconv is None:
        return
    # the reference on the same problem (a divergence, ROADMAP queue 3)
    je = jst.EPS(jst.DIAOperator(offsets, d), problem_type="hep",
                 options=jst.Options())
    je.set_interval(a, b)
    with pytest.warns(Warning):  # the complex band cast to real
        je.solve()
    assert je.nconv == ref_nconv and je.reason.name == ref_reason


@pytest.mark.parametrize("case", list(CASES))
def test_complex_inertia_matches_an_eigvalsh_count(case):
    """Each route's count at shifts across the spectrum against the count
    of numpy.linalg.eigvalsh below the shift: the tridiagonal recurrence
    (1-D) or the banded LDL^H (2-D) through DirectSolver.inertia, and
    both host routes directly on the same matrix."""
    make, _, _, _, _ = CASES[case]
    offsets, d = _gauged(make)
    A = tst.DIAOperator(offsets, d, device="cpu")
    S = A.to_scipy()
    Ad = S.toarray()
    w = np.linalg.eigvalsh(Ad)
    n = Ad.shape[0]
    for sigma in np.linspace(w[0] - 0.1, w[-1] + 0.1, 9) + 1e-3:
        shifted = tst.DIAOperator(offsets, d - np.where(
            np.array(offsets)[:, None] == 0, sigma, 0.0), device="cpu")
        neg = int(np.sum(w < sigma))
        assert DirectSolver(shifted).inertia() == (neg, 0, n - neg)
        Ss = S - sigma * np.eye(n)
        bw = max(abs(o) for o in offsets)
        assert banded_ldlt_inertia(Ss, bw) == (neg, 0, n - neg)
        if bw == 1:
            dd = np.diag(Ss)
            assert tridiag_inertia(dd, np.diag(Ss, 1)) == (neg, 0, n - neg)
