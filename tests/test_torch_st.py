"""st/st.py of the port against slepc_tpu's, on the CPU.

For each spectral transformation, both packages build it on the same
operators (slepc_tpu's, carried over by interop) and apply it to the same
seeded numpy vector: ``op().mult`` (and ``mult_h`` where the reference has
one) within 1e-10 relative, ``back_transform`` and ``eig_map`` within 1e-14.
The transformed operator is also held against its dense definition.
Divergence on purpose: a failed factorization raises in the port, where the
reference quietly goes iterative (slepc_tpu/st/st.py:107-108).
"""

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import slepc_tpu as jst
from slepc_tpu.st.st import (STCayley as JCayley, STPrecond as JPrecond,
                             STShell as JShell, STShift as JShift,
                             STSinvert as JSinvert)
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches keep the AIJ operators this module ran
    (their pytree metadata holds a scipy matrix), and the reference raises
    when a later module of the same process runs another operator of that
    shape (tests/test_eps_krylovschur.py's Markov chain after the one of
    tests/test_torch_nhep.py): drop them when the module ends."""
    yield
    jax.clear_caches()


N = (9, 8)


def _ops(kind):
    """(jax matrices, dense A, dense B or None)."""
    jA = jst.laplacian_2d(*N)
    n = jA.shape[0]
    Ad = np.asarray(jA.to_dense())
    if kind == "std":
        return [jA], Ad, None
    bd = 1.0 + 0.5 * np.sin(np.arange(n) * 0.3)
    if kind == "diagB":
        return [jA, jst.DIAOperator((0,), bd[None, :])], Ad, np.diag(bd)
    rng = np.random.default_rng(0)
    Bs = sp.diags([0.1 * rng.random(n - 1), bd, np.zeros(n - 1)], [-1, 0, 1])
    Bs = sp.csr_matrix(Bs + sp.tril(Bs, -1).T)
    return [jA, jst.from_scipy(Bs)], Ad, Bs.toarray()


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    return np.abs(got - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


CASES = {
    "shift_std": (JShift, "std", dict(sigma=0.7)),
    "shift_gen": (JShift, "aijB", dict(sigma=0.4)),
    "sinvert_std": (JSinvert, "std", dict(sigma=1.3, hermitian=True)),
    "sinvert_diagB": (JSinvert, "diagB", dict(sigma=0.9)),
    "sinvert_aijB": (JSinvert, "aijB", dict(sigma=0.0)),
    "sinvert_cg": (JSinvert, "std", dict(sigma=-0.5, hermitian=True,
                                         ksp_opts={"ksp_type": "cg",
                                                   "rtol": 1e-13})),
    "cayley_std": (JCayley, "std", dict(sigma=1.1, nu=0.3)),
    "cayley_gen": (JCayley, "diagB", dict(sigma=0.6)),
    "precond": (JPrecond, "std", dict(sigma=0.2)),
}


def _dense_op(name, Ad, Bd, kw):
    n = Ad.shape[0]
    Bm = np.eye(n) if Bd is None else Bd
    sigma = kw.get("sigma", 0.0)
    S = Ad - sigma * Bm
    if name.startswith("shift"):
        return S if Bd is None else np.linalg.solve(Bd, S)
    if name.startswith("sinvert"):
        return np.linalg.solve(S, Bm)
    if name.startswith("cayley"):
        return np.linalg.solve(S, Ad + kw.get("nu", sigma) * Bm)
    return Ad


@pytest.mark.parametrize("name", sorted(CASES))
def test_st_operator_and_maps(name):
    jcls, kind, kw = CASES[name]
    jmats, Ad, Bd = _ops(kind)
    jS = jcls(jmats, **kw)
    tS = interop.st_from_slepc_tpu(jS, device="cpu")
    assert type(tS).__name__ == jcls.__name__ and tS.name == jS.name
    x = np.random.default_rng(1).standard_normal(Ad.shape[0])
    yj = np.asarray(jS.op().mult(jnp.asarray(x)))
    yt = tS.op().mult(torch.from_numpy(x))
    assert _rel(yt, yj) < 1e-10
    assert _rel(yt, _dense_op(name, Ad, Bd, kw) @ x) < 1e-10
    assert _rel(tS.apply(torch.from_numpy(x)), yj) < 1e-10
    theta = np.array([0.3, -1.7, 2.5])
    np.testing.assert_allclose(tS.back_transform(theta),
                               np.asarray(jS.back_transform(theta)), rtol=1e-14)
    np.testing.assert_allclose(tS.eig_map(theta + 5.0),
                               np.asarray(jS.eig_map(theta + 5.0)), rtol=1e-14)
    np.testing.assert_allclose(tS.back_transform(tS.eig_map(theta + 5.0)),
                               theta + 5.0, rtol=1e-12)
    jop = jS.op()
    if getattr(jop, "_rmatvec", True) is not None and name != "precond":
        assert _rel(tS.op().mult_h(torch.from_numpy(x)),
                    np.asarray(jop.mult_h(jnp.asarray(x)))) < 1e-10
    if jS.ksp is not None:
        assert tS.ksp.method == jS.ksp.method


def test_precond_and_shell():
    jmats, Ad, _ = _ops("std")
    jS = JPrecond(jmats, sigma=0.2)
    tS = interop.st_from_slepc_tpu(jS, device="cpu")
    x = np.random.default_rng(2).standard_normal(Ad.shape[0])
    assert _rel(tS.preconditioner()(torch.from_numpy(x)),
                np.asarray(jS.preconditioner()(jnp.asarray(x)))) < 1e-14
    tA = interop.dia_from_slepc_tpu(jmats[0], device="cpu")
    jSh = JShell(jmats, lambda v: 2.0 * jmats[0].mult(v),
                 backtransform_fn=lambda e: e / 2.0)
    tSh = tst.STShell([tA], lambda v: 2.0 * tA.mult(v),
                      backtransform_fn=lambda e: e / 2.0)
    assert _rel(tSh.op().mult(torch.from_numpy(x)),
                np.asarray(jSh.op().mult(jnp.asarray(x)))) < 1e-14
    assert np.array_equal(tSh.back_transform(np.array([4.0])), [2.0])
    assert tSh.op().device == tA.device


def test_set_shift_rebuilds_the_operator():
    jmats, Ad, _ = _ops("std")
    tS = tst.STSinvert([interop.dia_from_slepc_tpu(jmats[0], device="cpu")],
                       sigma=0.5)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(Ad.shape[0]))
    y1 = tS.op().mult(x)
    tS.set_shift(1.5)
    assert tS.ksp is None
    y2 = tS.op().mult(x)
    n = Ad.shape[0]
    assert _rel(y1, np.linalg.solve(Ad - 0.5 * np.eye(n), x.numpy())) < 1e-10
    assert _rel(y2, np.linalg.solve(Ad - 1.5 * np.eye(n), x.numpy())) < 1e-10


def test_shell_operator_goes_iterative_and_singular_direct_raises():
    jmats, Ad, _ = _ops("std")
    tA = interop.dia_from_slepc_tpu(jmats[0], device="cpu")
    shell = tst.ShellOperator(tA.shape, tA.dtype, tA.mult, tA.mult_h,
                              device="cpu")
    tS = tst.STSinvert([shell], sigma=-0.3, hermitian=True,
                       ksp_opts={"rtol": 1e-13})
    x = np.random.default_rng(4).standard_normal(Ad.shape[0])
    y = tS.op().mult(torch.from_numpy(x))
    assert tS.ksp.method == "cg"
    assert _rel(y, np.linalg.solve(Ad + 0.3 * np.eye(len(x)), x)) < 1e-9
    # a singular explicit matrix: the factorization's failure is not hidden
    Z = tst.DenseOperator(np.zeros((5, 5)), device="cpu")
    with pytest.raises(RuntimeError, match="singular"):
        tst.STSinvert([Z], sigma=0.0).op().mult(torch.ones(5, dtype=torch.float64))


def test_check_null_space_attaches_the_nullspace():
    n = 30
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]).tolil()
    T[0, 0] = T[n - 1, n - 1] = 1.0
    T = sp.csr_matrix(T)
    ones = np.ones(n)
    other = np.arange(n, dtype=float)
    jS = JSinvert([jst.from_scipy(T)], sigma=0.0)
    tS = tst.STSinvert([tst.from_scipy(T, device="cpu")], sigma=0.0)
    V = np.stack([ones, other], axis=1)
    assert tS.check_null_space(V) == jS.check_null_space(V) == 1
    assert _rel(tS.nullspace[:, 0].abs(), np.abs(np.asarray(jS.nullspace)[:, 0])) < 1e-14
    b = np.random.default_rng(5).standard_normal(n)
    assert _rel(tS.op().mult(torch.from_numpy(b)),
                np.asarray(jS.op().mult(jnp.asarray(b)))) < 1e-10
    assert tS.check_null_space(other) == 0 and tS.nullspace is None
