"""The port's blocked Krylov-Schur path against slepc_tpu.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances:

* K5's plain version (``dia_spmm_ref``, what the port runs for CPU tensors)
  against the Pallas block kernel ``dia_spmv_padded_block`` (through
  ``DIAPaddedOperator.from_dia(A, block_rows=8).mult2d_block``, the
  tests/test_round4.py:324-336 set-up), f32 on laplacian_2d(40, 41),
  b = 2, 4, 8: within 1e-6 of max|Y| (single rounding of 5-term sums);
* K5's plain version in f64 against ``jax.vmap`` of the reference
  ``DIAOperator.mult``: 1e-13 relative;
* one blocked cycle against ``ks_hep_cycle_blocked`` from the same start
  block: f64 on a flat reference operator, kl / jb / k2 equal, Ritz values
  within 1e-11, error estimates within 1e-10, Ritz rows of the basis within
  1e-10 after aligning each row's sign (projected eigenvectors are defined
  up to sign), and the residual block spanning the same space within 1e-10
  (the port's SVQB scales the Gram diagonally, so its basis of that block
  differs: ROADMAP.md queue 3); f32 through the Pallas
  K5 and panel sweeps (orth="pallas", the tests/test_bv_pallas.py:77-104
  set-up): Ritz values within 1e-4;
* EPS(block_size=4) on laplacian_2d(40, 40) (the tests/test_round2.py:55-67
  case) and ks_cheb_smallest(block=4) (tests/test_round5.py:20-29, 37-47):
  both packages within 1e-10 (1e-9 for the adaptation case, as there) of
  the closed form and of each other;
* the AIJ blocked path (K6 once per row) on the RCM-ordered
  laplacian_3d(15, 16, 18): within 1e-10 of the closed form.

Each JAX reference solve runs once per module, in a fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

import slepc_tpu as jst
from slepc_tpu.eps.cheb_accel import ks_cheb_smallest as j_cheb
from slepc_tpu.eps.ks_jit import ks_hep_cycle_blocked as j_blocked
from slepc_tpu.mat.generators import laplacian_2d
from slepc_tpu.ops import dia_pallas
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop
from slepc_tpu_torch.eps.cheb_accel import ks_cheb_smallest
from slepc_tpu_torch.eps.ks_jit import _init_rows, ks_hep_cycle_blocked
from slepc_tpu_torch.ops import dia


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("b", [2, 4, 8])
def test_block_spmm_matches_pallas_block_kernel(b):
    A = laplacian_2d(40, 41, dtype=np.float32)
    jop = dia_pallas.DIAPaddedOperator.from_dia(A, block_rows=8)
    # the Pallas kernel itself, not its vmap fallback
    assert dia_pallas._block_halo(jop.offsets, 8) is not None
    X = np.random.default_rng(b).standard_normal((b, A.shape[0])) \
        .astype(np.float32)
    Yp = jop.mult2d_block(jnp.stack([jop.pad2d(jnp.asarray(x)) for x in X]))
    Yj = np.stack([np.asarray(jop.unpad(y)) for y in Yp])
    top = interop.dia_from_slepc_tpu(jop, device="cpu")
    Y = top.mult_block(torch.from_numpy(X)).numpy()
    assert Y.dtype == np.float32 and Y.shape == X.shape
    assert np.abs(Y - Yj).max() <= 1e-6 * np.abs(Yj).max()


@pytest.mark.parametrize("kind", ["lap", "rand"])
def test_f64_block_spmm_matches_vmap_of_reference_mult(kind):
    A = laplacian_2d(40, 41)
    if kind == "rand":  # random coefficients on the same offsets
        d = np.random.default_rng(7).standard_normal(np.asarray(A.diags).shape)
        i = np.arange(d.shape[1])
        for k, off in enumerate(A.offsets):
            # the reference's shifts are circular: it pre-zeroes entries
            # whose column falls outside [0, n)
            d[k, (i + off < 0) | (i + off >= d.shape[1])] = 0.0
        A = jst.DIAOperator(A.offsets, d)
    rng = np.random.default_rng(8)
    V = rng.standard_normal((9, A.shape[0]))
    Yj = np.asarray(jax.vmap(A.mult)(jnp.asarray(V[2:6])))
    top = interop.dia_from_slepc_tpu(A, device="cpu")
    Vt = torch.from_numpy(V)
    Y = top.mult_block(Vt[2:6])  # a slice of a taller basis, as the cycle
    assert _rel(Y.numpy(), Yj) < 1e-13
    assert torch.equal(Y, dia.dia_spmm_ref(top.offsets, top.diags, Vt[2:6]))
    for m in range(4):
        assert torch.equal(Y[m], top.mult(Vt[2 + m]))


def _sign_aligned(Vj, Vt):
    sign = np.sign(np.sum(Vj * Vt, axis=1))
    return np.abs(Vj - sign[:, None] * Vt).max()


def test_f64_blocked_cycle_matches_reference():
    side, ncv, b = 24, 12, 4
    A = laplacian_2d(side, side - 1)
    n = A.shape[0]
    rows0 = _init_rows(n, b, np.float64)
    Vj = jnp.zeros((ncv + b, n)).at[:b].set(jnp.asarray(rows0))
    oj = j_blocked(A, Vj, jnp.zeros((ncv + b, ncv)), jnp.asarray(0), 1e-8,
                   jax.random.PRNGKey(0), ncv=ncv, b=b, which="smallest")
    top = interop.dia_from_slepc_tpu(A, device="cpu")
    V = torch.zeros((ncv + b, n), dtype=torch.float64)
    V[:b] = torch.from_numpy(rows0)
    ot = ks_hep_cycle_blocked(top, V, np.zeros((ncv + b, ncv)), 0, 1e-8,
                              torch.Generator().manual_seed(0), ncv=ncv, b=b)
    assert (int(oj[2]), int(oj[3])) == (ot[2], ot[3])  # jb, k2
    kl = ot[2] * b
    assert b <= kl <= ncv - b and kl % b == 0
    assert np.abs(np.asarray(oj[4]) - ot[4]).max() < 1e-11
    assert np.abs(np.asarray(oj[5]) - ot[5]).max() < 1e-10  # errest
    assert abs(float(oj[6]) - ot[6]) < 1e-11  # ||B_last||_F
    Vjn, Vt = np.asarray(oj[0]), ot[0].numpy()
    ritz = np.r_[0:kl, kl + b:ncv]
    assert _sign_aligned(Vjn[ritz], Vt[ritz]) < 1e-10
    # the residual block: the same space in another orthonormal basis (the
    # port's SVQB scales the Gram diagonally, the reference's does not)
    for rows in (slice(kl, kl + b), slice(ncv, ncv + b)):
        Rj, Rt = Vjn[rows], Vt[rows]
        assert np.abs(Rj - (Rj @ Rt.T) @ Rt).max() < 1e-10
    # the restarted H: the locked diagonal, and b coupling rows at kl whose
    # column norms are the Ritz pairs' residuals
    Hj, Ht = np.asarray(oj[1]), ot[1]
    assert np.count_nonzero(Ht[kl + b:]) == 0
    assert np.abs(np.diag(Hj[:ncv]) - np.diag(Ht[:ncv])).max() < 1e-11
    assert np.abs(np.linalg.norm(Hj[kl:kl + b], axis=0)
                  - np.linalg.norm(Ht[kl:kl + b], axis=0)).max() < 1e-10


def test_f32_blocked_cycle_matches_pallas_sweeps():
    side, ncv, b = 90, 12, 4
    A = laplacian_2d(side, side, dtype=np.float32)
    jop = dia_pallas.DIAPaddedOperator.from_dia(A)
    x0 = jop.pad2d(jnp.ones((A.shape[0],), np.float32))
    v0 = x0 / jnp.linalg.norm(x0)
    M = np.random.default_rng(1).standard_normal(
        (int(np.prod(x0.shape)), b)).astype(np.float32)
    M[:, 0] = np.asarray(v0).ravel()
    M *= np.asarray(jop.mask2d).ravel()[:, None]
    Qm, _ = np.linalg.qr(M)
    Vj = jnp.zeros((ncv + b,) + x0.shape, np.float32)
    for i in range(b):
        Vj = Vj.at[i].set(jnp.asarray(Qm[:, i].reshape(x0.shape)))
    oj = j_blocked(jop, Vj, jnp.zeros((ncv + b, ncv), np.float32),
                   jnp.asarray(0), 1e-5, jax.random.PRNGKey(0), ncv=ncv, b=b,
                   which="largest", orth="pallas")
    top = interop.dia_from_slepc_tpu(jop, device="cpu")
    V = torch.zeros((ncv + b, A.shape[0]), dtype=torch.float32)
    V[:b] = torch.from_numpy(interop.basis_from_padded(Vj[:b], A.shape[0]))
    ot = ks_hep_cycle_blocked(top, V, np.zeros((ncv + b, ncv), np.float32),
                              0, 1e-5, torch.Generator().manual_seed(0),
                              ncv=ncv, b=b, which="largest")
    assert np.abs(np.asarray(oj[4]) - ot[4]).max() < 1e-4


def _block_eps(pkg):
    kw = {"device": "cpu"} if pkg is tst else {}
    eps = pkg.EPS(pkg.laplacian_2d(40, 40, **kw), problem_type="hep",
                  which="smallest_real", nev=4, ncv=32, tol=1e-9, max_it=200)
    eps.block_size = 4
    eps.solve()
    return eps


_CHEB_CASES = {  # tests/test_round5.py:20-29 and 37-47
    "converges": dict(side=60, nev=8, ncv=24, degree=60, tol_exact=1e-10),
    "adaptation": dict(side=60, nev=6, ncv=16, degree=40, tol_exact=1e-9,
                       max_cycles=200),
}


def _cheb_args(case):
    c = dict(_CHEB_CASES[case])
    tol_exact = c.pop("tol_exact")
    side = c.pop("side")
    return side, tol_exact, c


@pytest.fixture(scope="module")
def jax_ref():
    out = {"eps": np.sort(np.asarray(_block_eps(jst).eigenvalues).real)}
    for i, case in enumerate(_CHEB_CASES):
        side, _, kw = _cheb_args(case)
        res = j_cheb(laplacian_2d(side, side), tol=1e-8, block=4,
                     key=jax.random.PRNGKey(3 + 2 * i), **kw)
        out[case] = (res["nconv"], np.sort(np.asarray(res["lam"])))
    return out


def test_eps_block_size_matches_reference_and_closed_form(jax_ref):
    exact = tst.laplacian_2d_eigs(40, 40, k=4)  # double eigenvalues
    eps = _block_eps(tst)
    assert eps.nconv >= 4 and len(jax_ref["eps"]) >= 4
    lam = np.sort(eps.eigenvalues[:4])
    assert np.abs(lam - exact).max() < 1e-10
    assert np.abs(jax_ref["eps"][:4] - exact).max() < 1e-10
    assert np.abs(lam - jax_ref["eps"][:4]).max() < 1e-10
    assert max(eps.compute_error(i) for i in range(4)) < 1e-8


@pytest.mark.parametrize("case", list(_CHEB_CASES))
def test_cheb_block_matches_reference_and_closed_form(jax_ref, case):
    side, tol_exact, kw = _cheb_args(case)
    nev = kw["nev"]
    exact = tst.laplacian_2d_eigs(side, side, k=nev)
    tst.reset_launch_counts()
    res = ks_cheb_smallest(tst.laplacian_2d(side, side, device="cpu"), tol=1e-8, block=4,
                           **kw)
    assert all(v == 0 for v in tst.launch_counts().values())  # CPU: plain
    j_nconv, j_lam = jax_ref[case]
    assert res["nconv"] >= nev and j_nconv >= nev
    lam = np.sort(res["lam"][:nev])
    assert np.abs(lam - exact).max() < tol_exact
    assert np.abs(j_lam[:nev] - exact).max() < tol_exact
    assert np.abs(lam - j_lam[:nev]).max() < tol_exact
    assert np.max(res["resid"][:nev]) < 1e-8
    if case == "adaptation":
        assert res["stats"]["adaptations"] >= 1


def test_cheb_block_through_eps_rounds_ncv_up():
    A = tst.laplacian_2d(30, 29, device="cpu")
    eps = tst.EPS(A, problem_type="hep", which="smallest_real", nev=4,
                  ncv=22, tol=1e-9,
                  options=tst.Options.from_cli("-eps_cheb_degree 40"))
    eps.cheb_block = 4
    eps.solve()  # ncv 22 -> 24
    assert eps.nconv >= 4
    exact = tst.laplacian_2d_eigs(30, 29, k=4)
    assert np.abs(np.sort(eps.eigenvalues[:4]) - exact).max() < 1e-10


def test_cheb_block_ncv_must_divide():
    A = tst.laplacian_2d(20, 20, device="cpu")  # tests/test_round5.py:31-35
    with pytest.raises(ValueError, match="multiple"):
        ks_cheb_smallest(A, nev=4, tol=1e-8, ncv=22, degree=20, block=4)


def test_eps_block_size_on_rcm_ordered_csr():
    L = sp.csr_matrix(tst.laplacian_3d(15, 16, 18, device="cpu").to_scipy())
    perm = reverse_cuthill_mckee(L, symmetric_mode=True)
    A = tst.from_scipy(L[perm][:, perm].tocsr(), device="cpu")
    assert A.fast_form() is A  # the CSR form: K6 once per row
    X = np.random.default_rng(2).standard_normal((3, A.shape[0]))
    Y = A.mult_block(torch.from_numpy(X)).numpy()
    assert _rel(Y, (A.to_scipy() @ X.T).T) < 1e-14
    eps = tst.EPS(A, problem_type="hep", which="smallest_real", nev=4,
                  ncv=24, tol=1e-9, options=tst.Options.from_cli(
                      "-eps_block_size 4"))
    eps.solve()
    assert eps.block_size == 4 and eps.nconv >= 4
    exact = tst.laplacian_3d_eigs(15, 16, 18, k=4)
    assert np.abs(np.sort(eps.eigenvalues[:4]) - exact).max() < 1e-10
    assert max(eps.compute_error(i) for i in range(4)) < 1e-8


@pytest.mark.slow
def test_f32_blocked_solve_at_tol_1e5_in_both_packages():
    """Measurement for PERF.md, marked slow so the tier-1 run leaves it: the
    f32 blocked solve of chip_smoke.py phase 6 (laplacian_2d(95, 97),
    nev 6, ncv 28, block_size 4) at tol 1e-5, at most 1000 restarts, on the
    CPU in both packages: nconv, restarts, and where the six wanted error
    estimates level off (least over the run, and at the end).  Run with
    ``pytest -m slow -s tests/test_torch_block.py -k f32_blocked``."""
    out = {}
    for name, pkg, A in (
            ("slepc_tpu", jst, jst.laplacian_2d(95, 97, dtype=np.float32)),
            ("slepc_tpu_torch", tst, tst.laplacian_2d(
                95, 97, dtype=torch.float32, device="cpu"))):
        eps = pkg.EPS(A, problem_type="hep", which="smallest_real", nev=6,
                      ncv=28, tol=1e-5, max_it=1000, options=pkg.Options())
        eps.block_size = 4
        errs = []
        eps.monitor.add(lambda _e, _its, _k2, _th, err: errs.append(
            np.array(err[:6], np.float64)))
        eps.solve()
        E = np.array(errs)
        out[name] = (eps.nconv, eps.its, E.min(axis=0), E[-1])
        print(f"{name}: nconv={eps.nconv} its={eps.its} least estimates "
              f"{np.array2string(E.min(axis=0), precision=2)} last "
              f"{np.array2string(E[-1], precision=2)}")
    assert out["slepc_tpu_torch"][0] >= 6
    assert out["slepc_tpu"][2].min() > 1e-6  # levels off above 1e-6
