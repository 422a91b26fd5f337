"""The blocked Krylov-Schur cycle on a complex Hermitian operator and the
complex block DIA SpMM K5c's plain version, against slepc_tpu and the closed
form, on the CPU.

The operator is the gauge-transformed Laplacian U L U^H (U = diag(e^{i
phi}), phi from default_rng(11); ``tests/test_torch_complex.py``), which
keeps L's offsets and spectrum, so ``laplacian_2d_eigs`` is its closed form.
  * ``cheb_block > 1`` on a complex operator: the reference's fast path
    skips the Chebyshev-amplified path for a complex dtype and runs the plain
    cycle; the port does the same, so both give the same values and the
    same ``its``.
  * ``block_size > 1``: the port's blocked cycle certifies the closed-form
    values (c128 to 1e-10 at tol 1e-8, c64 to 1e-4 at tol 1e-5).  The
    reference's complex blocked cycle diverges on this operator (values
    near -1e122, ROADMAP queue 3): the case records that divergence
    instead of comparing with it.
  * The projected matrix the blocked cycle harvests is V^H A V of its basis
    (Hermitian), to 1e-12.
  * K5c's plain version equals b applies of K2c's plain version to 1e-15
    relative.
"""

import jax
import numpy as np
import pytest
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu.mat.generators import laplacian_2d_eigs
from slepc_tpu_torch.eps import ks_jit
from slepc_tpu_torch.ops import dia


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small solves (the test workers share
    the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches raise when a process runs two CSR
    operators of one shape: drop them around this module."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def gauge(offsets, diags, seed=11):
    """U A U^H for U = diag(exp(2 pi i u)), u from default_rng(seed)."""
    d = np.asarray(diags).astype(np.complex128)
    n = d.shape[1]
    phi = 2 * np.pi * np.random.default_rng(seed).random(n)
    for k, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, n - o)
        d[k, lo:hi] *= np.exp(1j * (phi[lo:hi] - phi[lo + o:hi + o]))
    return d


def gauge_laplacian_2d(nx, ny):
    L = jst.laplacian_2d(nx, ny)
    return tuple(L.offsets), gauge(L.offsets, np.asarray(L.diags))


def _eps(pkg, A, **kw):
    eps = pkg.EPS(A, problem_type="hep", which="smallest_real", nev=3,
                  options=pkg.Options())
    for k, v in kw.items():
        setattr(eps, k, v)
    eps.solve()
    return eps


def test_cheb_block_on_a_complex_operator_runs_the_plain_cycle():
    offsets, d = gauge_laplacian_2d(12, 11)
    je = _eps(jst, jst.DIAOperator(offsets, d), cheb_degree=20, cheb_block=2)
    te = _eps(tst, tst.DIAOperator(offsets, d, device="cpu"), cheb_degree=20,
              cheb_block=2)
    plain = _eps(tst, tst.DIAOperator(offsets, d, device="cpu"))
    assert te.nconv == je.nconv >= 3 and te.its == je.its == plain.its
    assert te.cheb_stats is None  # the Chebyshev-amplified path did not run
    np.testing.assert_allclose(te.eigenvalues[:3], np.real(je.eigenvalues[:3]),
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(te.eigenvalues, plain.eigenvalues)


@pytest.mark.parametrize("dtype,tol,atol", [
    (torch.complex128, 1e-8, 1e-10), (torch.complex64, 1e-5, 1e-4)])
@pytest.mark.parametrize("b", [2, 4])
def test_complex_blocked_cycle_certifies_the_closed_form(b, dtype, tol, atol):
    offsets, d = gauge_laplacian_2d(12, 11)
    A = tst.DIAOperator(offsets, torch.from_numpy(d).to(dtype), device="cpu")
    te = _eps(tst, A, block_size=b, tol=tol)
    assert te.nconv >= 3
    exact = laplacian_2d_eigs(12, 11, k=3)
    np.testing.assert_allclose(np.sort(te.eigenvalues[:3]), exact, rtol=0,
                               atol=atol)
    for i in range(3):
        assert te.compute_error(i) <= 10 * tol


def test_reference_complex_blocked_cycle_diverges():
    """A recorded divergence: the reference's complex blocked cycle
    (slepc_tpu/eps/ks_jit.py:811-1030) returns values far outside the
    spectrum [0, 8] of this operator, where the port certifies the closed
    form (the case above)."""
    offsets, d = gauge_laplacian_2d(12, 11)
    je = _eps(jst, jst.DIAOperator(offsets, d), block_size=2)
    lam = np.real(np.asarray(je.eigenvalues[: je.nconv]))
    assert lam.size == 0 or np.abs(lam).max() > 1e3


@pytest.mark.parametrize("b", [2, 3])
def test_blocked_projection_is_the_hermitian_rayleigh_quotient(b):
    """H after one blocked extension holds <V[k], A V[j]>: the projected
    matrix of the complex basis, Hermitian."""
    offsets, d = gauge_laplacian_2d(9, 8)
    A = tst.DIAOperator(offsets, d, device="cpu")
    ncv, n = 4 * b, A.shape[0]
    V = torch.zeros((ncv + b, n), dtype=torch.complex128)
    V[:b] = torch.from_numpy(ks_jit._init_rows(n, b, np.complex128))
    H = np.zeros((ncv + b, ncv), np.complex128)
    gen = torch.Generator().manual_seed(3)
    eps_mach = float(torch.finfo(torch.float64).eps)
    for p in range(ncv // b):
        ks_jit._block_step(A.mult_block, V, H, p, b, gen, eps_mach)
    Vn = V.numpy()
    G = Vn.conj() @ Vn.T
    assert np.abs(G - np.eye(ncv + b)).max() < 1e-12
    AV = A.mult_block(V[:ncv]).numpy()
    R = Vn.conj() @ AV.T  # R[k, j] = <V[k], A V[j]>
    assert np.abs(R - H).max() < 1e-12
    assert np.abs(H[:ncv] - H[:ncv].conj().T).max() < 1e-12


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("b", [1, 4, 9])
def test_complex_block_spmm_plain_matches_row_applies(dtype, b):
    offsets, d = gauge_laplacian_2d(12, 11)
    n = d.shape[1]
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.standard_normal((b, n))
                         + 1j * rng.standard_normal((b, n))).to(dtype)
    D = torch.from_numpy(d).to(dtype)
    Y = dia.dia_spmm(offsets, D, X)  # a CPU tensor: the plain version
    ref = torch.stack([dia.dia_spmv_ref(offsets, D, X[m]) for m in range(b)])
    tol = 1e-15 if dtype == torch.complex128 else 1e-7
    assert float((Y - ref).abs().max() / ref.abs().max()) <= tol
    A = tst.DIAOperator(offsets, D, device="cpu")
    assert torch.equal(A.mult_block(X), Y)
    plan = dia.plan_spmm(offsets, n, min(b, dia.SPMM_MAX_B), dtype)
    elem = 16 if dtype == torch.complex128 else 8
    assert plan.smem == min(b, dia.SPMM_MAX_B) * dia.spmm_width(
        plan.tile, plan.halo, elem) * elem <= dia.SPMM_SMEM_CAP
