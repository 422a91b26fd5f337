"""KSP of the port against slepc_tpu's, on the CPU.

Both packages solve the same seeded numpy systems.  Tolerances:
* ``cg_fixed`` / ``minres_fixed``: 1e-10 relative between the packages
  (the same recurrence, masked after convergence) and against the dense
  solve;
* each ``KSP`` method at rtol 1e-12: 1e-9 relative against the dense solve
  and against the reference's solution (iterative methods stop at
  different steps, so they agree to the solve's own accuracy);
* ``DirectSolver`` backends: 1e-10 relative, inertia exactly;
* the bordered nullspace solve: 1e-10.
``method="minres"`` is MINRES in the port and CG in the reference
(slepc_tpu/ksp/ksp.py:155-158): on an SPD system both agree, on an
indefinite one only the port is held to the dense solve.
"""

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import slepc_tpu as jst
from slepc_tpu.ksp.iterative_jit import cg_fixed as j_cg_fixed
from slepc_tpu.ksp.iterative_jit import minres_fixed as j_minres_fixed
from slepc_tpu.ksp.ksp import KSP as JKSP
from slepc_tpu.ksp.direct import DirectSolver as JDirect
from slepc_tpu.ksp import direct as jdirect
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop
from slepc_tpu_torch.ksp import direct as tdirect
from slepc_tpu_torch.ksp.iterative_jit import cg_fixed, minres_fixed
from slepc_tpu_torch.native.ldl import ldl_available


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches keep the AIJ operators this module ran
    (their pytree metadata holds a scipy matrix), and the reference raises
    when a later module of the same process runs another operator of that
    shape (tests/test_eps_krylovschur.py's Markov chain after the one of
    tests/test_torch_nhep.py): drop them when the module ends."""
    yield
    jax.clear_caches()


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _spd(n=120, seed=1):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return M @ M.T + n * np.eye(n), M, rng.standard_normal(n)


def test_cg_fixed_and_minres_fixed_match_the_reference():
    A, M, b = _spd()
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    xj = np.asarray(j_cg_fixed(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), 200))
    xt = cg_fixed(lambda v: At @ v, bt, 200)
    assert _rel(xt, xj) < 1e-10 and _rel(xt, np.linalg.solve(A, b)) < 1e-10
    # Jacobi-preconditioned, with a start vector
    dinv = 1.0 / np.diag(A)
    x0 = np.random.default_rng(2).standard_normal(len(b))
    xj = np.asarray(j_cg_fixed(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), 200,
                               Minv=lambda r: r * jnp.asarray(dinv),
                               x0=jnp.asarray(x0)))
    xt = cg_fixed(lambda v: At @ v, bt, 200,
                  Minv=lambda r: r * torch.from_numpy(dinv),
                  x0=torch.from_numpy(x0))
    assert _rel(xt, xj) < 1e-10
    assert np.array_equal(x0, np.random.default_rng(2).standard_normal(len(b)))
    # MINRES on an indefinite symmetric system
    Ai = M + M.T + 0.1 * np.eye(len(b))
    Ait = torch.from_numpy(Ai)
    xj = np.asarray(j_minres_fixed(lambda v: jnp.asarray(Ai) @ v, jnp.asarray(b), 400))
    xt = minres_fixed(lambda v: Ait @ v, bt, 400)
    assert _rel(xt, xj) < 1e-8 and _rel(xt, np.linalg.solve(Ai, b)) < 1e-8


@pytest.mark.parametrize("method", ["cg", "minres", "bicgstab", "gmres",
                                    "direct", "auto"])
def test_ksp_methods_on_an_spd_stencil(method):
    jA = jst.laplacian_2d(12, 11)
    tA = interop.dia_from_slepc_tpu(jA, device="cpu")
    b = np.random.default_rng(3).standard_normal(jA.shape[0])
    want = np.linalg.solve(np.asarray(jA.to_dense()), b)
    kw = dict(method=method, rtol=1e-12, hermitian=True)
    xj = np.asarray(JKSP(jA, **kw).solve(jnp.asarray(b)))
    tk = tst.KSP(tA, **kw)
    xt = tk.solve(torch.from_numpy(b))
    assert _rel(xt, want) < 1e-9 and _rel(xt, xj) < 1e-9
    if method == "auto":
        assert tk.method == "direct" == JKSP(jA, **kw).method
    # a block of right-hand sides goes column by column
    B2 = np.stack([b, 2 * b[::-1]], axis=1)
    X2 = tk.solve(torch.from_numpy(B2))
    assert _rel(X2[:, 1], np.linalg.solve(np.asarray(jA.to_dense()), B2[:, 1])) < 1e-9


def test_ksp_minres_is_minres_on_an_indefinite_system():
    jA = jst.laplacian_2d(12, 11)
    tA = interop.dia_from_slepc_tpu(jA, device="cpu").shifted(3.3)
    b = np.random.default_rng(4).standard_normal(jA.shape[0])
    want = np.linalg.solve(np.asarray(jA.to_dense()) - 3.3 * np.eye(len(b)), b)
    x = tst.KSP(tA, method="minres", rtol=1e-12, maxiter=2000).solve(
        torch.from_numpy(b))
    assert _rel(x, want) < 1e-9


def test_ksp_nonsymmetric_bicgstab_gmres_preonly():
    rng = np.random.default_rng(5)
    n = 90
    M = rng.standard_normal((n, n)) / np.sqrt(n) + 4 * np.eye(n)
    b = rng.standard_normal(n)
    want = np.linalg.solve(M, b)
    for method in ("bicgstab", "gmres"):
        xj = np.asarray(JKSP(jst.DenseOperator(M), method=method,
                             rtol=1e-12).solve(jnp.asarray(b)))
        xt = tst.KSP(tst.DenseOperator(M, device="cpu"), method=method,
                     rtol=1e-12).solve(torch.from_numpy(b))
        assert _rel(xt, want) < 1e-9 and _rel(xt, xj) < 1e-9
    xj = np.asarray(JKSP(jst.DenseOperator(M), method="preonly").solve(jnp.asarray(b)))
    xt = tst.KSP(tst.DenseOperator(M, device="cpu"), method="preonly").solve(
        torch.from_numpy(b))
    assert _rel(xt, xj) < 1e-14
    with pytest.raises(ValueError, match="unknown KSP method"):
        tst.KSP(tst.DenseOperator(M, device="cpu"), method="sor")


def _direct_cases():
    rng = np.random.default_rng(6)
    L = sp.csr_matrix(np.asarray(jst.laplacian_2d(9, 7).to_dense()))
    perm = rng.permutation(L.shape[0])
    sym = (L[perm][:, perm] + sp.identity(L.shape[0])).tocsr()
    nonsym = (sym + sp.random(L.shape[0], L.shape[0], density=0.02,
                              random_state=7)).tocsr()
    Md = rng.standard_normal((40, 40))
    Md = Md @ Md.T + 40 * np.eye(40)
    return {
        "dense": (jst.DenseOperator(Md), "dense"),
        "tridiag_device": (jst.laplacian_1d(60), "tridiag_device"),
        "btridiag_device": (jst.laplacian_2d(6, 8), "btridiag_device"),
        "ldl": (jst.from_scipy(sym), "ldl"),
        "splu": (jst.from_scipy(nonsym), "splu"),
    }


@pytest.mark.parametrize("case", ["dense", "tridiag_device", "btridiag_device",
                                  "ldl", "splu"])
def test_direct_solver_backends(case):
    jop, backend = _direct_cases()[case]
    top = interop.operator_from_slepc_tpu(jop, device="cpu")
    jd, td = JDirect(jop), tst.DirectSolver(top)
    assert td.backend == backend == jd.backend
    if case == "ldl":
        assert ldl_available()
    b = np.random.default_rng(8).standard_normal(jop.shape[0])
    dense = np.asarray(jop.to_dense())
    xt = td.solve(torch.from_numpy(b))
    assert _rel(xt, np.linalg.solve(dense, b)) < 1e-10
    assert _rel(xt, np.asarray(jd.solve(jnp.asarray(b)))) < 1e-10
    assert _rel(td.solve_h(torch.from_numpy(b)),
                np.linalg.solve(dense.T, b)) < 1e-10
    if case != "splu":
        assert td.inertia() == jd.inertia() == (0, 0, jop.shape[0])


@pytest.mark.parametrize("sigma", [0.9, 3.1])
def test_inertia_of_shifted_operators(sigma):
    """KSP.inertia over each route: scanned tridiagonal, block tridiagonal,
    native LDL^T on a permuted CSR; against the eigenvalue count."""
    for jop in (jst.laplacian_1d(70), jst.laplacian_2d(6, 8)):
        dd = np.asarray(jop.diags).copy()
        dd[jop.offsets.index(0)] -= sigma
        jsh = jst.DIAOperator(jop.offsets, dd)
        tsh = interop.dia_from_slepc_tpu(jsh, device="cpu")
        below = int(np.sum(np.linalg.eigvalsh(np.asarray(jop.to_dense())) < sigma))
        got = tst.KSP(tsh, method="direct").inertia()
        assert got == JKSP(jsh, method="direct").inertia()
        assert got[0] == below and got[1] == 0
    S = sp.csr_matrix(np.asarray(jst.laplacian_2d(7, 5).to_dense())
                      - sigma * np.eye(35))
    got = tst.KSP(tst.from_scipy(S, device="cpu"), method="cg").inertia()
    assert got == JKSP(jst.from_scipy(S), method="cg").inertia()


def test_host_inertia_functions():
    rng = np.random.default_rng(9)
    d, e = rng.standard_normal(30), rng.standard_normal(29)
    assert tdirect.tridiag_inertia(d, e) == jdirect.tridiag_inertia(d, e)
    A = sp.diags([rng.standard_normal(28), rng.standard_normal(29), d,
                  np.zeros(29), np.zeros(28)], [-2, -1, 0, 1, 2]).tocsr()
    A = A + sp.tril(A, -1).T
    assert tdirect._bandwidth(A) == jdirect._bandwidth(A) == 2
    got = tdirect.banded_ldlt_inertia(A, 2)
    assert got == jdirect.banded_ldlt_inertia(A, 2)
    w = np.linalg.eigvalsh(A.toarray())
    assert got == (int((w < 0).sum()), 0, int((w > 0).sum()))


def test_nullspace_bordered_direct_solve():
    """A singular Neumann-type matrix with its constant nullspace: the
    bordered factorization solves on range(A), in both packages."""
    n = 40
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]).tolil()
    T[0, 0] = T[n - 1, n - 1] = 1.0
    T = sp.csr_matrix(T)
    N = np.ones((n, 1)) / np.sqrt(n)
    b = np.random.default_rng(10).standard_normal(n)
    jk = JKSP(jst.from_scipy(T), method="direct").set_nullspace(N)
    tk = tst.KSP(tst.from_scipy(T, device="cpu"), method="direct").set_nullspace(N)
    xj = np.asarray(jk.solve(jnp.asarray(b)))
    xt = tk.solve(torch.from_numpy(b)).numpy()
    assert _rel(xt, xj) < 1e-10
    bp = b - N[:, 0] * (N[:, 0] @ b)
    assert np.abs(T @ xt - bp).max() < 1e-10 and abs(N[:, 0] @ xt) < 1e-10
    # iterative: right-hand side and solution are projected
    tc = tst.KSP(tst.from_scipy(T, device="cpu"), method="cg", rtol=1e-12,
                 pc="none").set_nullspace(N)
    xc = tc.solve(torch.from_numpy(b)).numpy()
    assert np.abs(T @ xc - bp).max() < 1e-8


def test_solve_linear():
    A, _, b = _spd(30, 11)
    x = tst.solve_linear(tst.DenseOperator(A, device="cpu"), torch.from_numpy(b))
    assert _rel(x, np.linalg.solve(A, b)) < 1e-12
