"""ksp/tridiag_device.py of the port against slepc_tpu's, on the CPU.

The same seeded numpy tridiagonal / block-tridiagonal matrices go through
both packages.  Tolerance 1e-10 throughout (relative to the largest entry
of the result): both run the same prefix recurrences, the port by doubling
rounds and the reference by ``associative_scan``, which associate the
products in another order; the refinement step brings the solves to 1e-12.
Inertia counts must agree exactly, with each other and with the count of
eigenvalues below the shift.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slepc_tpu.ksp.tridiag_device as jtd
from slepc_tpu.mat.generators import laplacian_1d as j_lap1d
from slepc_tpu.mat.generators import laplacian_2d as j_lap2d
import slepc_tpu_torch.ksp.tridiag_device as ttd
from slepc_tpu_torch import interop

TOL = 1e-10


def _tridiag(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 3.0, rng.standard_normal(n - 1)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("n,sigma", [(50, 0.0), (257, 0.7), (1000, 2.9)])
def test_pivots_and_inertia(n, sigma):
    a, b = _tridiag(n, n)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    dj = np.asarray(jtd.tridiag_pivots(jnp.asarray(a), jnp.asarray(b), sigma))
    dt = ttd.tridiag_pivots(at, bt, sigma).numpy()
    # the pivots of an indefinite matrix span many orders: compare each
    # against its own size
    assert np.abs(dt - dj).max() <= TOL * np.abs(dj).max()
    assert np.median(np.abs(dt - dj) / np.abs(dj)) <= TOL
    T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    below = int(np.sum(np.linalg.eigvalsh(T) < sigma))
    assert int(ttd.tridiag_inertia(at, bt, sigma)) == below
    assert int(jtd.tridiag_inertia(jnp.asarray(a), jnp.asarray(b), sigma)) == below


@pytest.mark.parametrize("n,sigma,k", [(64, 0.0, 1), (300, 0.4, 3)])
def test_tridiag_solve(n, sigma, k):
    a, b = _tridiag(n, 7 * n)
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal(n) if k == 1 else rng.standard_normal((n, k))
    xj = np.asarray(jtd.tridiag_solve(jnp.asarray(a), jnp.asarray(b), sigma,
                                      jnp.asarray(rhs)))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    xt = ttd.tridiag_solve(at, bt, sigma, torch.from_numpy(rhs)).numpy()
    T = np.diag(a - sigma) + np.diag(b, 1) + np.diag(b, -1)
    assert _rel(xt, xj) <= TOL
    assert _rel(xt, np.linalg.solve(T, rhs)) <= TOL
    # factor once, solve many: the cached pivots give the same solve
    piv = ttd.tridiag_pivots(at, bt, sigma)
    xp = ttd.tridiag_solve(at, bt, sigma, torch.from_numpy(rhs), pivots=piv)
    assert np.array_equal(xp.numpy(), xt)


def _blocks(m, bw, seed):
    rng = np.random.default_rng(seed)
    Ab = rng.standard_normal((m, bw, bw))
    Ab = 0.5 * (Ab + Ab.transpose(0, 2, 1)) + 2 * bw * np.eye(bw)
    return Ab, rng.standard_normal((m - 1, bw, bw))


def _block_dense(Ab, Bb):
    m, bw, _ = Ab.shape
    T = np.zeros((m * bw, m * bw))
    for i in range(m):
        T[i * bw:(i + 1) * bw, i * bw:(i + 1) * bw] = Ab[i]
        if i + 1 < m:
            T[(i + 1) * bw:(i + 2) * bw, i * bw:(i + 1) * bw] = Bb[i]
            T[i * bw:(i + 1) * bw, (i + 1) * bw:(i + 2) * bw] = Bb[i].T
    return T


@pytest.mark.parametrize("m,bw,sigma", [(6, 4, 0.0), (9, 5, 9.5)])
def test_block_tridiag_pivots_inertia_solve(m, bw, sigma):
    Ab, Bb = _blocks(m, bw, m * bw)
    At, Bt = torch.from_numpy(Ab), torch.from_numpy(Bb)
    Dj = np.asarray(jtd.btridiag_pivots(jnp.asarray(Ab), jnp.asarray(Bb), sigma))
    Dt = ttd.btridiag_pivots(At, Bt, sigma).numpy()
    assert _rel(Dt, Dj) <= TOL
    T = _block_dense(Ab, Bb)
    below = int(np.sum(np.linalg.eigvalsh(T) < sigma))
    assert int(ttd.btridiag_inertia(At, Bt, sigma)) == below
    assert int(jtd.btridiag_inertia(jnp.asarray(Ab), jnp.asarray(Bb), sigma)) == below
    rhs = np.random.default_rng(2).standard_normal(m * bw)
    xj = np.asarray(jtd.btridiag_solve(jnp.asarray(Ab), jnp.asarray(Bb), sigma,
                                       jnp.asarray(rhs)))
    xt = ttd.btridiag_solve(At, Bt, sigma, torch.from_numpy(rhs)).numpy()
    assert _rel(xt, xj) <= TOL
    assert _rel(xt, np.linalg.solve(T - sigma * np.eye(m * bw), rhs)) <= TOL


def test_operator_extraction_matches_the_reference():
    j1, j2 = j_lap1d(40), j_lap2d(6, 7)
    t1 = interop.dia_from_slepc_tpu(j1, device="cpu")
    t2 = interop.dia_from_slepc_tpu(j2, device="cpu")
    aj, bj = jtd.tridiag_of_operator(j1)
    at, bt = ttd.tridiag_of_operator(t1)
    assert np.array_equal(at.numpy(), np.asarray(aj))
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    assert ttd.tridiag_of_operator(t2) is None
    assert jtd.tridiag_of_operator(j2) is None
    Aj, Bj = jtd.btridiag_of_operator(j2)
    At, Bt = ttd.btridiag_of_operator(t2)
    assert np.array_equal(At, Aj) and np.array_equal(Bt, Bj)
    assert ttd.btridiag_of_operator(t1) is None


def test_tridiag_ldl_device_facade():
    a, b = _tridiag(120, 3)
    fac = ttd.TridiagLDLDevice(torch.from_numpy(a), torch.from_numpy(b))
    jfac = jtd.TridiagLDLDevice(a, b)
    for sigma in (0.0, 2.5):
        assert fac.shift(sigma).inertia() == jfac.shift(sigma).inertia()
    rhs = np.random.default_rng(4).standard_normal(120)
    xt = fac.shift(0.3).solve(torch.from_numpy(rhs)).numpy()
    assert _rel(xt, np.asarray(jfac.shift(0.3).solve(rhs))) <= TOL
