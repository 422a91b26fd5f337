"""The BSE solver of slepc_tpu_torch (``eps/bse.py``, ``mat/structured.py``)
and the block divide-and-conquer (``ds/bdc.py``) against slepc_tpu's, on
the CPU.

The three variants of tests/test_round4.py:207-227 at n = 16 (H is 32 x
32), in both packages from the same numpy blocks: the values within 1e-9
of each other and of the dense eig of H, and each returned eigenvector's
residual ||H z - lambda z|| / |lambda| at most 1e-8.  The block D&C cases
of tests/test_round4.py:382-428 run in both packages on the same blocks.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp
import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu.ds import bdc as jbdc
from slepc_tpu_torch.ds import bdc as tbdc
from slepc_tpu_torch.ds.types import DSHEP


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bse_pair(n, seed, complex_=False):
    """tests/test_round4.py:191-205: R Hermitian (+ 2n I), C symmetric."""
    rng = np.random.default_rng(seed)
    if complex_:
        Rm = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        Rm = 0.5 * (Rm + Rm.conj().T) + 2 * n * np.eye(n)
        Cm = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        Cm = 0.5 * (Cm + Cm.T)
    else:
        Rm = rng.standard_normal((n, n))
        Rm = 0.5 * (Rm + Rm.T) + 2 * n * np.eye(n)
        Cm = rng.standard_normal((n, n))
        Cm = 0.5 * (Cm + Cm.T)
    Hd = np.block([[Rm, Cm], [-Cm.conj(), -Rm.conj()]])
    return Rm, Cm, Hd


@pytest.mark.parametrize("variant,complex_", [("auto", False),
                                              ("projected", False),
                                              ("auto", True)])
def test_bse_variants_match_reference_and_dense(variant, complex_):
    n = 16
    Rm, Cm, Hd = _bse_pair(n, 3, complex_)
    lam_pos = np.sort(sla.eig(Hd)[0].real)
    lam_pos = lam_pos[lam_pos > 0][:4]
    out = []
    for pkg in (jst, tst):
        if pkg is jst:
            H = jst.create_bse(jst.DenseOperator(jnp.asarray(Rm)),
                               jst.DenseOperator(jnp.asarray(Cm)))
        else:
            H = tst.create_bse(tst.DenseOperator(Rm, device="cpu"),
                               tst.DenseOperator(Cm, device="cpu"))
        eps = pkg.EPS(H, problem_type="bse", nev=4, ncv=14, tol=1e-9)
        eps.set_type("bse")
        eps.bse_variant = variant
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv >= 4 and te.nconv == je.nconv and te.its == je.its
    lam = np.sort(np.real(te.eigenvalues[:4]))
    np.testing.assert_allclose(lam, lam_pos, rtol=1e-9, atol=0)
    np.testing.assert_allclose(lam, np.sort(np.real(je.eigenvalues[:4])),
                               rtol=1e-9, atol=0)
    Z = te.get_eigenvectors().numpy()
    for i in range(4):
        z, l = Z[:, i], te.eigenvalues[i]
        assert np.linalg.norm(Hd @ z - l * z) / np.linalg.norm(z) \
            <= 1e-8 * abs(l)


def test_bse_dispatch_from_krylovschur_and_the_structured_operator():
    """problem_type="bse" through the default solver reaches the BSE
    solver; MatBSE and create_tile apply as their dense matrices, forward
    and adjoint."""
    n = 8
    Rm, Cm, Hd = _bse_pair(n, 4, True)
    R = tst.DenseOperator(Rm, device="cpu")
    C = tst.DenseOperator(Cm, device="cpu")
    H = tst.create_bse(R, C)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n)
    xt = torch.from_numpy(x)
    assert np.abs(H.mult(xt).numpy() - Hd @ x).max() < 1e-12 * np.abs(Hd).max()
    assert np.abs(H.mult_h(xt).numpy() - Hd.conj().T @ x).max() < \
        1e-12 * np.abs(Hd).max()
    G = tst.create_tile(2.0, R, None, None, -1j, C, 0.5, R)
    Gd = np.block([[2.0 * Rm, np.zeros((n, n))], [-1j * Cm, 0.5 * Rm]])
    assert np.abs(G.mult(xt).numpy() - Gd @ x).max() < 1e-12 * np.abs(Gd).max()
    assert np.abs(G.mult_h(xt).numpy() - Gd.conj().T @ x).max() < \
        1e-12 * np.abs(Gd).max()
    Gj = jst.create_tile(2.0, jst.DenseOperator(jnp.asarray(Rm)), None, None,
                         -1j, jst.DenseOperator(jnp.asarray(Cm)), 0.5,
                         jst.DenseOperator(jnp.asarray(Rm)))
    assert np.abs(G.mult(xt).numpy() - np.asarray(Gj.mult(jnp.asarray(x)))
                  ).max() < 1e-12 * np.abs(Gd).max()
    eps = tst.EPS(H, problem_type="bse", nev=2, tol=1e-9)
    eps.solve()
    lam_pos = np.sort(sla.eig(Hd)[0].real)
    np.testing.assert_allclose(np.sort(eps.eigenvalues[:2]),
                               lam_pos[lam_pos > 0][:2], rtol=1e-9)
    # the top of the spectrum, asked for explicitly: the M-metric solve on
    # H itself (no factorization)
    eps = tst.EPS(H, problem_type="bse", nev=2, tol=1e-9,
                  which="largest_real")
    eps.solve()
    np.testing.assert_allclose(eps.eigenvalues[:2], lam_pos[::-1][:2],
                               rtol=1e-9)
    with pytest.raises(ValueError, match="MatBSE"):
        tst.EPS(R, problem_type="bse", nev=2).solve()


@pytest.mark.parametrize("nb,bs", [(4, 9), (7, 12), (3, 40)])
def test_bdc_eig_exact_matches_reference(nb, bs):
    """tests/test_round4.py:382-397."""
    rng = np.random.default_rng(nb * 100 + bs)
    Ds = [0.5 * (D + D.T) for D in
          (rng.standard_normal((bs, bs)) for _ in range(nb))]
    Es = [0.4 * rng.standard_normal((bs, bs)) for _ in range(nb - 1)]
    M = tbdc.block_tridiag_dense(Ds, Es)
    np.testing.assert_array_equal(M, jbdc.block_tridiag_dense(Ds, Es))
    w, Q = tbdc.bdc_eig(Ds, Es, tau=0.0, dense_cutoff=10)
    wj, Qj = jbdc.bdc_eig(Ds, Es, tau=0.0, dense_cutoff=10)
    np.testing.assert_array_equal(w, wj)
    np.testing.assert_array_equal(Q, Qj)
    we = np.linalg.eigvalsh(M)
    n = M.shape[0]
    assert np.abs(w - we).max() < 1e-10 * max(1.0, np.abs(we).max())
    assert np.abs(Q.T @ Q - np.eye(n)).max() < 1e-12
    assert np.abs(Q @ np.diag(w) @ Q.T - M).max() < 1e-10


def test_bdc_eig_tau_bounds_error():
    """tests/test_round4.py:400-416: approximate mode, the eigenvalue error
    bounded by about tau ||M|| a merge level."""
    rng = np.random.default_rng(77)
    nb, bs = 6, 16
    Ds = [0.5 * (D + D.T) + np.diag(np.linspace(1, 2, bs))
          for D in (0.1 * rng.standard_normal((bs, bs)) for _ in range(nb))]
    Es = [0.01 * rng.standard_normal((bs, bs)) for _ in range(nb - 1)]
    M = tbdc.block_tridiag_dense(Ds, Es)
    we = np.linalg.eigvalsh(M)
    for tau in (1e-3, 1e-6):
        w, Q = tbdc.bdc_eig(Ds, Es, tau=tau, dense_cutoff=8)
        np.testing.assert_array_equal(
            w, jbdc.bdc_eig(Ds, Es, tau=tau, dense_cutoff=8)[0])
        assert np.abs(w - we).max() < 10 * tau * np.abs(M).max()
        assert np.abs(Q.T @ Q - np.eye(M.shape[0])).max() < 1e-10


def test_dshep_solve_block_tridiag_routes():
    """tests/test_round4.py:419-428: the eigh route and the D&C route."""
    rng = np.random.default_rng(3)
    Ds = [0.5 * (D + D.T) for D in
          (rng.standard_normal((8, 8)) for _ in range(5))]
    Es = [0.3 * rng.standard_normal((8, 8)) for _ in range(4)]
    ds = DSHEP()
    w_dense, _ = ds.solve_block_tridiag(Ds, Es)
    w_bdc, Q = ds.solve_block_tridiag(Ds, Es, force=True)
    assert np.abs(w_dense - w_bdc).max() < 1e-10
    M = tbdc.block_tridiag_dense(Ds, Es)
    assert np.abs(Q @ np.diag(w_bdc) @ Q.T - M).max() < 1e-10
    wj, _ = jst.DSHEP().solve_block_tridiag(Ds, Es, force=True)
    np.testing.assert_array_equal(w_bdc, wj)
    w1, Q1 = tbdc.dpr1_eig(np.linspace(0, 1, 6), np.ones(6) / 6 ** 0.5, 0.5)
    w1j, Q1j = jbdc.dpr1_eig(np.linspace(0, 1, 6), np.ones(6) / 6 ** 0.5, 0.5)
    np.testing.assert_array_equal(w1, w1j)
