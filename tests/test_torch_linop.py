"""The port's operator family (slepc_tpu_torch/mat/linop.py) against
slepc_tpu's.

The same numpy matrices and vectors go into each operator class of both
packages -- dense, identity, DIA, AIJ (rectangular), shell, diagonal and
the algebra (scaled, sum, difference, negation, product, adjoint, shifted)
-- and ``mult`` / ``mult_h`` are compared, relative 1e-13 (f64; a handful
of products summed in different orders).  Dense materialization and the
norm estimates (including the randomized one, which draws the same numpy
vector in both packages) agree to 1e-12.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import slepc_tpu as jst
from slepc_tpu.mat import linop as jl
from slepc_tpu.mat.generators import random_sparse as j_random_sparse
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop
from slepc_tpu_torch.mat import linop as tl

N = 24


def _mats():
    rng = np.random.default_rng(10)
    return rng.standard_normal((N, N)), rng.standard_normal(N)


def _dia_pair():
    base = jst.laplacian_2d(6, 4)  # N = 24 rows, offsets (-6, -1, 0, 1, 6)
    d = np.random.default_rng(11).standard_normal(np.asarray(base.diags).shape)
    # slepc_tpu's DIA rolls x circularly: entries past the ends must be zero
    d *= np.asarray(base.diags) != 0
    jop = jl.DIAOperator(base.offsets, d)
    return jop, interop.dia_from_slepc_tpu(jop, device="cpu")


def _pairs(kind):
    M, d = _mats()
    jd, td = jl.DenseOperator(M), tl.DenseOperator(M, device="cpu")
    jdia, tdia = _dia_pair()
    if kind == "dense":
        return jd, td
    if kind == "identity":
        return jl.IdentityOperator(N), tl.IdentityOperator(N, device="cpu")
    if kind == "dia":
        return jdia, tdia
    if kind == "aij_rect":
        a = j_random_sparse(N, 17, density=0.3, seed=1)
        return a, tst.random_sparse(N, 17, density=0.3, seed=1, device="cpu")
    if kind == "shell":
        Mj, Mt = jnp.asarray(M), torch.from_numpy(M)
        return (jl.ShellOperator((N, N), np.float64, lambda x: Mj @ x,
                                 lambda x: Mj.T @ x),
                tl.ShellOperator((N, N), torch.float64, lambda x: Mt @ x,
                                 lambda x: Mt.T @ x, device="cpu"))
    if kind == "diagonal":
        return jl.DiagonalOperator(d), tl.DiagonalOperator(d, device="cpu")
    if kind == "scaled":
        return 2.5 * jd, 2.5 * td
    if kind == "sum":
        return jd + jdia, td + tdia
    if kind == "difference":
        return jd - jdia, td - tdia
    if kind == "negated":
        return -jdia, -tdia
    if kind == "product":
        return jd @ jdia, td @ tdia
    if kind == "adjoint":
        return jdia.H, tdia.H
    if kind == "shifted":
        return jdia.shifted(0.7), tdia.shifted(0.7)
    if kind == "shifted_by_b":
        return (jdia.shifted(0.7, jl.DiagonalOperator(d)),
                tdia.shifted(0.7, tl.DiagonalOperator(d, device="cpu")))
    raise KeyError(kind)


KINDS = ["dense", "identity", "dia", "aij_rect", "shell", "diagonal",
         "scaled", "sum", "difference", "negated", "product", "adjoint",
         "shifted", "shifted_by_b"]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("kind", KINDS)
def test_mult_and_mult_h_match_reference(kind):
    jop, top = _pairs(kind)
    assert tuple(top.shape) == tuple(jop.shape)
    assert top.nnz == jop.nnz
    rng = np.random.default_rng(12)
    x = rng.standard_normal(jop.shape[1])
    z = rng.standard_normal(jop.shape[0])
    y = top.mult(torch.from_numpy(x))
    assert y.dtype == torch.float64 and y.shape == (jop.shape[0],)
    assert _rel(y.numpy(), np.asarray(jop.mult(jnp.asarray(x)))) < 1e-13
    yh = top.mult_h(torch.from_numpy(z)).numpy()
    assert _rel(yh, np.asarray(jop.mult_h(jnp.asarray(z)))) < 1e-13


@pytest.mark.parametrize("kind", ["sum", "product", "aij_rect", "dia"])
def test_to_dense_and_to_scipy_match_reference(kind):
    jop, top = _pairs(kind)
    dj = np.asarray(jop.to_dense())
    assert _rel(top.to_dense().numpy(), dj) < 1e-13
    s = top.to_scipy()
    s = s.toarray() if sp.issparse(s) else s
    assert _rel(s, dj) < 1e-13


def test_norm_estimates_match_reference():
    for kind in ("dense", "dia", "aij_rect", "sum"):
        jop, top = _pairs(kind)
        assert abs(top.norm_estimate() - jop.norm_estimate()) \
            <= 1e-12 * jop.norm_estimate(), kind
    # n > 4096: the randomized estimate, the same numpy vector in both
    jb = j_random_sparse(5000, density=0.001, seed=2)
    tb = tst.random_sparse(5000, density=0.001, seed=2, device="cpu")
    jsum, tsum = jb + jb, tb + tb
    assert abs(tsum.norm_estimate() - jsum.norm_estimate()) \
        <= 1e-12 * jsum.norm_estimate()


def test_aslinearoperator_and_adjoint_of_adjoint():
    M, _ = _mats()
    S = sp.random(N, N, density=0.2, random_state=np.random.default_rng(3),
                  format="csr")
    assert isinstance(tst.aslinearoperator(S, device="cpu"), tst.AIJOperator)
    assert isinstance(jst.aslinearoperator(S), jl.AIJOperator)
    dense = tst.aslinearoperator(M, device="cpu")
    assert isinstance(dense, tst.DenseOperator)
    assert tst.aslinearoperator(dense, device="cpu") is dense
    assert dense.H.H is dense
    assert tst.from_dense(M, device="cpu").shape == (N, N)
    x = np.random.default_rng(4).standard_normal(N)
    assert _rel(tst.aslinearoperator(S, device="cpu").mult(
        torch.from_numpy(x)).numpy(),
                S @ x) < 1e-14


@pytest.mark.parametrize("b", [9, 20, 48])
def test_dia_mult_block_of_any_height_is_rows_of_mult(b):
    """A block taller than K5 takes (SPMM_MAX_B = 8 rows) is rows of mult
    on the CPU as on the card (there, in chunks of at most 8 rows: one K5
    launch each, tests/test_torch_gpu.py)."""
    A = tst.laplacian_2d(13, 11, device="cpu")
    n = A.shape[0]
    X = torch.from_numpy(np.random.default_rng(b).standard_normal((b, n)))
    Y = A.mult_block(X)
    assert Y.shape == (b, n)
    for i in range(b):
        torch.testing.assert_close(Y[i], A.mult(X[i]), rtol=0, atol=1e-15)
    # a strided slice of a taller basis, as the subspace solver hands it
    V = torch.zeros((b + 3, n), dtype=torch.float64)
    V[2: b + 2] = X
    torch.testing.assert_close(A.mult_block(V[2: b + 2]), Y, rtol=0,
                               atol=0)
