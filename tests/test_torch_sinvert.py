"""The device shift-and-invert tier (st/sinvert_jit.py) against slepc_tpu's,
on the CPU.

* Operator parity: the same DIA operator, metric and seeded vector through
  ``SinvertCGOperator`` of both packages (the reference on its padded
  layout, its Pallas SpMV in interpret mode), 1e-10 relative, and against
  the sparse direct solve; also an operator carried over by interop, the
  Jacobi-preconditioned and the MINRES arms.
* The three cases of tests/test_round4.py:250-316 through both packages'
  ``EPS`` + ``STSinvertDevice``: eigenvalues within 1e-9 of each other and
  of scipy / the dense spectrum, true residuals <= 1e-8.  The fast path's
  start vector is the same numpy draw in both packages, but the reference
  pads it before its QR, so trajectories are compared by eigenvalues and
  residuals, not step by step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import slepc_tpu as jst
from slepc_tpu.st.sinvert_jit import SinvertCGOperator as JSinvertOp
from slepc_tpu.st.sinvert_jit import STSinvertDevice as JSTSinvertDevice
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    return np.abs(got - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def _japply(jop, x):
    return np.asarray(jop.unpad(jop.mult2d(jop.pad2d(jnp.asarray(x)))))


@pytest.mark.parametrize("sigma,method,iters,scale", [
    (0.0, "cg", 400, None),       # tests/test_round4.py:250-266
    (-0.4, "cg", 300, "jacobi"),  # variable diagonal: Jacobi arm
    (2.05, "minres", 900, None),  # interior shift
])
def test_operator_parity(sigma, method, iters, scale):
    nx, ny, nz = 10, 11, 12
    n = nx * ny * nz
    jA = jst.laplacian_3d(nx, ny, nz, dtype=np.float64)
    if scale:  # spread the diagonal past the Jacobi switch (max/min > 4)
        w = 1.0 + 9.0 * (np.arange(n) % 7 == 0)
        dd = np.asarray(jA.diags).copy()
        dd[jA.offsets.index(0)] *= w
        jA = jst.DIAOperator(jA.offsets, dd)
    tA = interop.dia_from_slepc_tpu(jA, device="cpu")
    bd = 1.0 + 0.5 * np.sin(np.arange(n) * 0.01)
    jop = JSinvertOp.from_dia(jA, sigma=sigma, b_diag=jnp.asarray(bd),
                              iters=iters, method=method)
    top = tst.SinvertCGOperator.from_dia(tA, sigma=sigma, b_diag=bd,
                                         iters=iters, method=method)
    assert (top.invdiag is None) == (jop.invdiag is None) == (scale is None)
    assert top.nnz == jop.nnz
    x = np.random.default_rng(0).standard_normal(n)
    yj = _japply(jop, x)
    yt = top.mult(torch.from_numpy(x))
    S = sp.csr_matrix(jA.to_scipy()) - sigma * sp.diags(bd)
    yref = np.sqrt(bd) * spla.spsolve(sp.csc_matrix(S), np.sqrt(bd) * x)
    tol = 1e-10 if method == "cg" else 1e-8
    assert _rel(yt, yj) < tol and _rel(yt, yref) < tol
    # carried over by interop: same diagonals, vectors, iters and method
    cop = interop.sinvert_operator_from_slepc_tpu(jop, device="cpu")
    assert cop.iters == iters and cop.method == method
    assert np.array_equal(cop.Sop.diags.numpy(), top.Sop.diags.numpy())
    # (its D^{1/2} is the reference's sqrt, which may differ in the last bit)
    assert _rel(cop.mult(torch.from_numpy(x)), yt) < tol
    u = np.random.default_rng(1).standard_normal(n)
    pj = np.asarray(jop.unpad(jop.postprocess_vec(jop.pad2d(jnp.asarray(u)))))
    assert _rel(top.postprocess_vec(torch.from_numpy(u)), pj) < 1e-15


def test_standard_operator_and_argument_checks():
    jA = jst.laplacian_2d(14, 13)
    tA = interop.dia_from_slepc_tpu(jA, device="cpu")
    top = tst.SinvertCGOperator.from_dia(tA, iters=250)
    x = np.random.default_rng(2).standard_normal(tA.shape[0])
    y = top.mult(torch.from_numpy(x))
    assert top.dhalf is None and top.postprocess_vec(y) is y
    assert _rel(y, np.linalg.solve(np.asarray(jA.to_dense()), x)) < 1e-10
    with pytest.raises(ValueError, match="diagonal B"):
        tst.STSinvertDevice([tA, tA])
    with pytest.raises(ValueError, match="DIAOperator A"):
        tst.STSinvertDevice([tst.from_scipy(tA.to_scipy(), device="cpu")])
    with pytest.raises(ValueError, match="'cg' or 'minres'"):
        tst.SinvertCGOperator(tA, method="gmres")


def _solve_both(jA, jB, sigma, st_kw, eps_kw):
    out = []
    for pkg, dev_cls in ((jst, JSTSinvertDevice), (tst, tst.STSinvertDevice)):
        if pkg is tst:
            mats = [interop.dia_from_slepc_tpu(M, device="cpu")
                    for M in ([jA] if jB is None else [jA, jB])]
        else:
            mats = [jA] if jB is None else [jA, jB]
        eps = pkg.EPS(*mats, which="target_magnitude", **eps_kw)
        eps.set_target(sigma)
        eps.set_st(dev_cls(mats, sigma=sigma, **st_kw))
        eps.solve()
        out.append(eps)
    return out


def test_eps_sinvert_device_ghep():
    nx, ny, nz = 12, 13, 14
    n = nx * ny * nz
    jA = jst.laplacian_3d(nx, ny, nz, dtype=np.float64)
    bd = 1.0 + 0.5 * np.sin(np.arange(n) * 0.01)
    jB = jst.DIAOperator((0,), bd[None, :])
    As, Bs = sp.csr_matrix(jA.to_scipy()), sp.diags(bd)
    lam_ref = np.sort(spla.eigsh(As, k=5, M=sp.csc_matrix(Bs), sigma=0,
                                 which="LM", return_eigenvectors=False))
    je, te = _solve_both(jA, jB, 0.0, dict(iters=300),
                         dict(problem_type="ghep", nev=5, ncv=20, tol=1e-10))
    assert te.nconv >= 5 and je.nconv >= 5
    got = np.sort(te.eigenvalues[:5])
    assert np.abs(got - lam_ref).max() < 1e-9 * lam_ref.max()
    assert np.abs(got - np.sort(je.eigenvalues[:5].real)).max() < 1e-9
    order = np.argsort(te.eigenvalues[:5])
    X = te._eigenvectors[:5].numpy()[order].T
    R = As @ X - (Bs @ X) * got
    assert (np.linalg.norm(R, axis=0) / np.abs(got)).max() < 1e-8
    assert max(te.compute_error(i) for i in range(5)) < 1e-8
    np.testing.assert_allclose(np.linalg.norm(X, axis=0), 1.0, rtol=1e-12)


def test_eps_sinvert_device_interior_minres():
    jA = jst.laplacian_3d(8, 9, 10, dtype=np.float64)
    lam_all = np.linalg.eigvalsh(np.asarray(jA.to_dense()))
    sigma = float(0.5 * (lam_all[7] + lam_all[8]))
    ref = np.sort(lam_all[np.argsort(np.abs(lam_all - sigma))[:4]])
    je, te = _solve_both(jA, None, sigma, dict(iters=600, method="minres"),
                         dict(problem_type="hep", nev=4, ncv=20, tol=1e-9))
    assert te.nconv >= 4 and je.nconv >= 4
    got = np.sort(te.eigenvalues[:4])
    assert np.abs(got - ref).max() < 1e-7
    assert np.abs(got - np.sort(je.eigenvalues[:4].real)).max() < 1e-7


@pytest.mark.parametrize("case", ["sinvert", "plain", "blocked"])
def test_fast_path_confirms_candidates_on_the_original_problem(case):
    # laplacian_1d(300) through the device shift-and-invert: ||A|| /
    # lambda_1 ~ 4e4, so the transformed estimate alone (all the
    # reference's fast path tests) stops at tol 1e-8 with a true residual of
    # 2.4e-8.  The port confirms every candidate with ||A x - lambda x||
    # before it counts;
    # set_true_residual asks the same of the plain and the blocked cycle
    if case == "sinvert":
        A = tst.laplacian_1d(300, dtype=torch.float64, device="cpu")
        eps = tst.EPS(A, problem_type="hep", which="target_magnitude",
                      nev=4, ncv=16, tol=1e-8)
        eps.set_target(0.0)
        eps.set_st(tst.STSinvertDevice([A], sigma=0.0, iters=600))
        exact = tst.laplacian_1d_eigs(300, k=4)
    else:
        A = tst.laplacian_2d(18, 17, dtype=torch.float64, device="cpu")
        eps = tst.EPS(A, problem_type="hep", which="largest_real", nev=4,
                      ncv=20, tol=1e-8).set_true_residual()
        eps.block_size = 2 if case == "blocked" else 1
        exact = np.sort(tst.laplacian_2d_eigs(18, 17))[::-1][:4]
    eps.solve()
    assert eps.nconv >= 4
    resid = np.array([eps.compute_error(i) for i in range(eps.nconv)])
    assert resid.max() <= 1e-8 and eps.errests[:eps.nconv].max() < 1e-8
    got = np.array(eps.eigenvalues[:4])
    assert np.abs(np.sort(got) - np.sort(exact)).max() < 1e-9
