"""Port CGS2 panel sweeps (slepc_tpu_torch/ops/bv.py) against the Pallas
panel kernels of slepc_tpu/ops/bv_pallas.py (interpret mode).

The same basis, panel and coefficients, made with numpy from a seed, go
through slepc_tpu's kernels on the padded (K, R, 512) layout and the port's
wrappers on the flat (K, R*512) layout (plain PyTorch for CPU tensors).
Cases and tolerances are those of tests/test_bv_pallas.py: f32, 1e-5
relative (1e-4 for the dots of the fused update+dots).
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slepc_tpu.ops import bv_pallas as bvp
from slepc_tpu_torch.ops import bv


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches keep the AIJ operators this module ran
    (their pytree metadata holds a scipy matrix), and the reference raises
    when a later module of the same process runs another operator of that
    shape (tests/test_eps_krylovschur.py's Markov chain after the one of
    tests/test_torch_nhep.py): drop them when the module ends."""
    yield
    jax.clear_caches()


@pytest.mark.parametrize("K,b,R", [(9, 1, 64), (9, 3, 64), (33, 8, 384)])
def test_panel_sweeps_match_pallas(K, b, R):
    rng = np.random.default_rng(0)
    V = rng.standard_normal((K, R, bvp.W)).astype(np.float32)
    Wb = rng.standard_normal((b, R, bvp.W)).astype(np.float32)
    C = rng.standard_normal((K, b)).astype(np.float32)
    tV = torch.from_numpy(V.reshape(K, -1))
    tW = torch.from_numpy(Wb.reshape(b, -1))
    tC = torch.from_numpy(C)

    def rel(port, ref, floor=0.0):
        port = port.numpy().reshape(np.shape(ref))
        ref = np.asarray(ref)
        return float(np.abs(port - ref).max() / (np.abs(ref).max() + floor))

    assert rel(bv.panel_dots(tV, tW), bvp.panel_dots(jnp.asarray(V),
                                                     jnp.asarray(Wb))) < 1e-5
    u_ref = bvp.panel_update(jnp.asarray(V), jnp.asarray(C), jnp.asarray(Wb))
    assert rel(bv.panel_update(tV, tC, tW), u_ref) < 1e-5
    u2_ref, d2_ref = bvp.panel_update_dots(jnp.asarray(V), jnp.asarray(C),
                                           jnp.asarray(Wb))
    u2, d2 = bv.panel_update_dots(tV, tC, tW)
    assert rel(u2, u2_ref) < 1e-5
    assert rel(d2, d2_ref, floor=1e-6) < 1e-4


def test_panel_sweeps_take_a_basis_prefix():
    """The Krylov cycle passes V[:j+1] of a taller basis: a row-strided
    prefix view must give the same result as a compact copy."""
    rng = np.random.default_rng(1)
    Vfull = torch.from_numpy(rng.standard_normal((12, 1000)))
    W = torch.from_numpy(rng.standard_normal((1, 1000)))
    V = Vfull[:5]
    C = bv.panel_dots(V, W)
    assert torch.allclose(C, V.clone() @ W.T, rtol=0, atol=1e-12)
    U, D = bv.panel_update_dots(V, C, W)
    assert torch.allclose(U, W - C.T @ V.clone(), rtol=0, atol=1e-12)
    assert torch.allclose(D, V.clone() @ U.T, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# bv/orthog.py, bv/bv.py, bv/krylov.py: the port's row-major basis against
# slepc_tpu's (n, m) column basis on the same seeded numpy data.  The
# reference's masks select "the previous columns"; the port slices the row
# prefix.  Tolerances: 1e-12 on orthogonalized vectors and coefficients
# (f64, the same sweeps in another summation order), 1e-10 on the block
# factorizations (Cholesky / eigh of a Gram matrix), signs aligned where a
# factor is unique only up to sign.
# ---------------------------------------------------------------------------

import scipy.sparse as sp

import slepc_tpu as jst
from slepc_tpu.bv import orthog as jorth
from slepc_tpu.bv.bv import BV as JBV
from slepc_tpu.bv.krylov import arnoldi_extend as j_arnoldi
from slepc_tpu.bv.krylov import lanczos_extend as j_lanczos
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop
from slepc_tpu_torch.bv import orthog as torth
from slepc_tpu_torch.bv.bv import BV, OrthogBlockType
from slepc_tpu_torch.bv.krylov import arnoldi_extend, lanczos_extend


def _metric(n, seed=3):
    d = 1.0 + np.random.default_rng(seed).random(n)
    Bs = sp.diags([0.1 * np.ones(n - 1), d, 0.1 * np.ones(n - 1)],
                  [-1, 0, 1]).tocsr()
    return jst.from_scipy(Bs), tst.from_scipy(Bs, device="cpu"), Bs.toarray()


@pytest.mark.parametrize("metric", [False, True])
@pytest.mark.parametrize("passes", [1, 2, 3])
def test_orthogonalize_vec_matches_reference(metric, passes):
    rng = np.random.default_rng(1)
    n, m, j = 90, 12, 7
    V = np.linalg.qr(rng.standard_normal((n, m)))[0]
    w = rng.standard_normal(n)
    jB, tB, Bd = _metric(n) if metric else (None, None, None)
    mask = (np.arange(m) < j).astype(np.float64)
    wj, cj, nbj, naj = jorth.orthogonalize_vec(
        jnp.asarray(V), jnp.asarray(mask), jnp.asarray(w),
        None if jB is None else jB.mult, passes=passes)
    wt, ct, nbt, nat = torth.orthogonalize_vec(
        torch.from_numpy(V.T.copy())[:j], torch.from_numpy(w),
        None if tB is None else tB.mult, passes=passes)
    assert np.abs(wt.numpy() - np.asarray(wj)).max() < 1e-12
    assert np.abs(ct.numpy() - np.asarray(cj)[:j]).max() < 1e-12
    assert abs(float(nbt) - float(nbj)) < 1e-12
    assert abs(float(nat) - float(naj)) < 1e-12
    # no rows to project against: the vector comes back untouched
    w0, c0, nb0, na0 = torth.orthogonalize_vec(
        torch.zeros((0, n), dtype=torch.float64), torch.from_numpy(w))
    assert w0 is not None and c0.numel() == 0 and float(nb0) == float(na0)


@pytest.mark.parametrize("metric", [False, True])
@pytest.mark.parametrize("name", ["cholqr", "cholqr2", "svqb", "mgs_block"])
def test_block_orthonormalization_matches_reference(name, metric):
    rng = np.random.default_rng(2)
    n, m = 70, 11  # more rows than one K3 panel
    X = rng.standard_normal((n, m)) @ np.diag(np.logspace(0, 2, m))
    jB, tB, Bd = _metric(n) if metric else (None, None, np.eye(n))
    Qj, Fj = getattr(jorth, name)(jnp.asarray(X), None if jB is None else jB.mult)
    Qt, Ft = getattr(torth, name)(torch.from_numpy(X.T.copy()),
                                  None if tB is None else tB.mult)
    Qt = Qt.numpy()
    np.testing.assert_allclose(Qt @ Bd @ Qt.T, np.eye(m), atol=1e-10)
    sign = np.sign(np.sum(Qt.T * np.asarray(Qj), axis=0))
    assert np.abs(Qt.T * sign - np.asarray(Qj)).max() < 1e-10
    if name == "svqb":  # Q_cols = X_cols T
        np.testing.assert_allclose(X @ Ft, Qt.T, atol=1e-10)
    else:               # X_cols = Q_cols R
        np.testing.assert_allclose(Qt.T @ Ft, X, atol=1e-9)
        np.testing.assert_allclose(np.abs(Ft), np.abs(np.asarray(Fj)), atol=1e-9)


def test_cholqr2_shifts_a_rank_deficient_block():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((4, 60))
    X[3] = X[0] + X[1]  # exactly dependent rows: the Gram matrix is singular
    Q, _ = torth.cholqr2(torch.from_numpy(X))
    assert torch.isfinite(Q).all()


def _bv_pair(n, m, metric, seed=4):
    rng = np.random.default_rng(seed)
    jbv = JBV(n, m)
    jbv.array = jnp.asarray(rng.standard_normal((n, m)))
    jB = tB = None
    if metric:
        jB, tB, _ = _metric(n)
        jbv.set_matrix(jB)
    return jbv, interop.bv_from_slepc_tpu(jbv, device="cpu")


@pytest.mark.parametrize("metric", [False, True])
def test_bv_columns_constraints_and_orthonormalization(metric):
    n, m = 80, 6
    jbv, tbv = _bv_pair(n, m, metric)
    assert tbv.array.shape == (m, n) and (tbv.matrix is not None) == metric
    C = np.random.default_rng(5).standard_normal((n, 2))
    assert jbv.insert_constraints(jnp.asarray(C)) == \
        tbv.insert_constraints(C.T) == 2
    assert tbv.array.shape == (m + 2, n) and tbv.nc == 2
    for j in range(3):
        cj, nj, lj = jbv.orthonormalize_column(j, replace_lindep=True)
        ct, nt, lt = tbv.orthonormalize_column(j, replace_lindep=True)
        assert lj == lt and abs(nj - nt) < 1e-12 * max(1.0, abs(nj))
        # the reference pads its coefficients with masked zeros
        assert np.abs(ct - np.asarray(cj)[:j]).max(initial=0.0) < 1e-11
        assert np.abs(np.asarray(cj)[j:]).max() == 0.0
        assert abs(tbv.norm_column(j) - 1.0) < 1e-12
    A = np.asarray(jbv.array)
    sign = np.sign(np.sum(tbv.array.numpy().T * A, axis=0))
    assert np.abs(tbv.array.numpy().T * sign - A)[:, :5].max() < 1e-11
    np.testing.assert_allclose(tbv.to_numpy()[:, :3],
                               np.asarray(jbv.to_numpy())[:, :3], atol=1e-11)
    y = np.random.default_rng(6).standard_normal(n)
    tbv.set_active_columns(0, 3)
    jbv.set_active_columns(0, 3)
    np.testing.assert_allclose(tbv.dot_vec(y).numpy(),
                               np.asarray(jbv.dot_vec(jnp.asarray(y))), atol=1e-11)
    v, c, nrm, lindep = tbv.orthogonalize_vec(y)
    vj, cj, nrmj, lindepj = jbv.orthogonalize_vec(jnp.asarray(y))
    assert lindep == lindepj and abs(nrm - nrmj) < 1e-11
    assert np.abs(v.numpy() - np.asarray(vj)).max() < 1e-11


def test_bv_lindep_replacement_and_block_ops():
    n, m = 50, 5
    jbv, tbv = _bv_pair(n, m, False, seed=7)
    for bv_ in (jbv, tbv):
        bv_.orthonormalize_column(0)
        bv_.set_column(1, 3.0 * np.asarray(bv_.get_column(0)))  # dependent
    cj, nj, lj = jbv.orthonormalize_column(1, replace_lindep=True)
    ct, nt, lt = tbv.orthonormalize_column(1, replace_lindep=True)
    assert lt == lj is False and abs(nt - nj) < 1e-10
    assert abs(float(torch.dot(tbv.get_column(0), tbv.get_column(1)))) < 1e-12
    # mult_in_place (K4) and mult_vec against the reference
    Q = np.linalg.qr(np.random.default_rng(8).standard_normal((m, m)))[0]
    jbv.mult_in_place(Q, 0, 3)
    tbv.mult_in_place(Q, 0, 3)
    np.testing.assert_allclose(tbv.to_numpy(), np.asarray(jbv.to_numpy()),
                               atol=1e-10)
    q = np.arange(1.0, 4.0)
    np.testing.assert_allclose(tbv.mult_vec(q).numpy(),
                               np.asarray(jbv.mult_vec(q)), atol=1e-10)
    for bt in (OrthogBlockType.CHOL, OrthogBlockType.SVQB, OrthogBlockType.GS):
        _, t2 = _bv_pair(n, m, False, seed=9)
        t2.orthogonalize(bt)
        G = t2.array @ t2.array.T
        np.testing.assert_allclose(G.numpy(), np.eye(m), atol=1e-10)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        BV(10, 2)  # no card here, and no quiet CPU fallback


@pytest.mark.parametrize("metric", [False, True])
def test_arnoldi_and_lanczos_extend_match_reference(metric):
    nx, ny, mmax, nc = 9, 8, 10, 1
    n = nx * ny
    jA = jst.laplacian_2d(nx, ny)
    tA = interop.dia_from_slepc_tpu(jA, device="cpu")
    jB, tB, Bd = _metric(n) if metric else (None, None, np.eye(n))
    rng = np.random.default_rng(10)
    V0 = np.zeros((n, nc + mmax + 1))
    c = rng.standard_normal(n)
    V0[:, 0] = c / np.sqrt(c @ Bd @ c)
    v = rng.standard_normal(n)
    v -= V0[:, 0] * (V0[:, 0] @ Bd @ v)
    V0[:, 1] = v / np.sqrt(v @ Bd @ v)
    if metric:  # B^{-1} A is B-self-adjoint
        Binv = np.linalg.inv(Bd)
        jop = jst.ShellOperator((n, n), np.float64,
                                lambda x: jnp.asarray(Binv) @ jA.mult(x))
        top = tst.ShellOperator((n, n), torch.float64,
                                lambda x: torch.from_numpy(Binv) @ tA.mult(x),
                                device="cpu")
    else:
        jop, top = jA, tA
    Vj, Hj, betaj, brkj, _ = j_arnoldi(jop, jnp.asarray(V0),
                                      jnp.zeros((mmax + 1, mmax)), 0, 6,
                                      nc=nc, Bop=jB)
    Vt = torch.from_numpy(V0.T.copy())
    Ht = np.zeros((mmax + 1, mmax))
    Vt, Ht, betat, brkt = arnoldi_extend(top, Vt, Ht, 0, 6, nc=nc, Bop=tB)
    assert not brkt and not bool(brkj)
    assert abs(betat - float(betaj)) < 1e-10
    np.testing.assert_allclose(Ht, np.asarray(Hj), atol=1e-10)
    np.testing.assert_allclose(Vt.numpy().T, np.asarray(Vj), atol=1e-10)
    # a second window continues the same factorization
    Vj, Hj, betaj, _, _ = j_arnoldi(jop, Vj, Hj, 6, mmax, nc=nc, Bop=jB)
    Vt, Ht, betat, _ = arnoldi_extend(top, Vt, Ht, 6, mmax, nc=nc, Bop=tB)
    np.testing.assert_allclose(Ht, np.asarray(Hj), atol=1e-9)
    G = Vt.numpy() @ Bd @ Vt.numpy().T
    np.testing.assert_allclose(G, np.eye(nc + mmax + 1), atol=1e-10)
    # Lanczos: the tridiagonal read off the same loop
    al, be = np.zeros(mmax), np.zeros(mmax)
    Vj2, alj, bej, bmj, _, _ = j_lanczos(jop, jnp.asarray(V0), jnp.asarray(al),
                                         jnp.asarray(be), 0, mmax, nc=nc, Bop=jB)
    Vt2, alt, bet, bmt, _ = lanczos_extend(top, torch.from_numpy(V0.T.copy()),
                                           al, be, 0, mmax, nc=nc, Bop=tB)
    np.testing.assert_allclose(alt, np.asarray(alj), atol=1e-10)
    np.testing.assert_allclose(bet, np.asarray(bej), atol=1e-10)
    assert abs(bmt - float(bmj)) < 1e-10


def test_arnoldi_breakdown_restarts_with_a_random_vector():
    n = 12
    e0 = np.zeros(n)
    e0[0] = 1.0
    top = tst.DiagonalOperator(np.arange(1.0, n + 1), device="cpu")
    V = torch.zeros((5, n), dtype=torch.float64)
    V[0] = torch.from_numpy(e0)  # an eigenvector: A v is parallel to v
    H = np.zeros((5, 4))
    V, H, beta, brk = arnoldi_extend(top, V, H, 0, 3)
    assert brk and H[1, 0] == 0.0 and abs(H[0, 0] - 1.0) < 1e-14
    np.testing.assert_allclose((V[:4] @ V[:4].T).numpy(), np.eye(4), atol=1e-12)


# ---- the launch planning of the panel sweeps (no card needed) -------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", range(1, 9))
@pytest.mark.parametrize("K", [1, 3, 5, 17, 29, 49, 52, 64, 65, 129])
def test_panel_plan_covers_the_paths(dtype, b, K):
    elt = 8 if dtype == torch.float64 else 4
    for n in (720, 9215, 10_350_000):
        for mode in (0, 1, 2):
            if mode == 2 and not bv.fused_update_dots(K, b):
                with pytest.raises(ValueError, match="planned each"):
                    bv.plan_panel(mode, K, b, n, dtype)
                continue
            plan = bv.plan_panel(mode, K, b, n, dtype)
            assert plan["vec"] == (n % (16 // elt) == 0)
            assert plan["width"] >= b and plan["width"] in (1, 2, 4, 8)
            assert plan["rows"] == (8 if plan["width"] <= 2 else 4)
            covered = 0
            for one in plan["launches"]:
                assert one["k0"] == covered
                covered = one["k1"]
                assert 1 <= one["groups"] <= bv.MAX_GROUPS
                assert one["k1"] - one["k0"] <= one["groups"] * plan["rows"]
                assert one["threads"] == 32 * one["groups"] * one["cw"] <= 512
                assert one["tile"] == 32 * one["cw"] * (
                    16 // elt if plan["vec"] else 1)
                assert one["smem"] <= bv.SMEM_LIMIT == 232_448
                assert 1 <= one["grid"] <= -(-n // one["tile"])
            assert covered == K
            # one launch up to one block's reach of 16 row groups
            assert (len(plan["launches"]) == 1) == (K <= 16 * plan["rows"])


def test_panel_plan_alignment_occupancy_and_refusals():
    f64 = torch.float64
    assert bv.plan_panel(0, 49, 1, 4096, f64)["vec"]
    assert not bv.plan_panel(0, 49, 1, 4096, f64, v_base=8)["vec"]
    assert not bv.plan_panel(0, 49, 1, 4096, f64, w_base=8)["vec"]
    assert not bv.plan_panel(0, 49, 1, 4096, f64, ldv=4097)["vec"]
    assert bv.plan_panel(0, 49, 1, 4096, f64, ldv=8192, ldw=4098)["vec"]
    assert not bv.plan_panel(0, 49, 1, 4095, f64, ldv=4096)["vec"]  # odd n
    # the grid comes from the SM count and the kernel's occupancy
    seen = []
    plan = bv.plan_panel(2, 49, 1, 10_350_000, f64, sm_count=100,
                         blocks_per_sm=lambda vec, one: seen.append(
                             (vec, one["groups"], one["cw"])) or 3)
    assert seen == [(True, 7, 1)] and plan["launches"][0]["grid"] == 300
    assert bv.plan_panel(0, 49, 1, 100, f64)["launches"][0]["grid"] == 2
    # shared memory holds the G parts of the update, not the basis tile: it
    # does not grow with K past one block's reach
    big = bv.plan_panel(1, 1000, 8, 10_000, f64)
    assert max(one["smem"] for one in big["launches"]) == \
        bv.plan_panel(1, 64, 8, 10_000, f64)["launches"][0]["smem"]
    assert bv.plan_panel(0, 49, 1, 4096, f64)["launches"][0]["smem"] <= 4096
    # update+dots: one kernel within a block's reach below width 8
    assert bv.fused_update_dots(49, 1) and bv.fused_update_dots(64, 4)
    assert bv.fused_update_dots(128, 2) and not bv.fused_update_dots(129, 2)
    assert not bv.fused_update_dots(65, 4) and not bv.fused_update_dots(8, 5)
    for bad in (dict(mode=3), dict(b=9), dict(K=0), dict(n=0)):
        args = dict(mode=0, K=4, b=1, n=10, dtype=f64)
        args.update(bad)
        with pytest.raises(ValueError):
            bv.plan_panel(**args)
    with pytest.raises(TypeError):
        bv.plan_panel(0, 4, 1, 10, torch.float16)


@pytest.mark.parametrize("K,b", [(49, 1), (129, 2), (65, 3), (64, 4),
                                 (130, 4), (8, 5), (129, 8), (200, 7)])
def test_panel_sweeps_in_row_chunks_match_plain(K, b):
    """The launch sequence around the kernel (row chunks past one block's
    reach, update+dots as two sweeps where it is not fused), with the plain
    versions standing in for the kernel launches."""
    rng = np.random.default_rng(5)
    n = 300
    V = torch.from_numpy(np.linalg.qr(rng.standard_normal((n, K)))[0].T.copy())
    W = torch.from_numpy(rng.standard_normal((b, n)))
    C = torch.from_numpy(rng.standard_normal((K, b)))
    calls = []

    def sweep(m, vec, one, Vrows, Wm, Crows):
        calls.append((m, one["k0"], one["k1"]))
        assert Vrows.shape[0] == one["k1"] - one["k0"]
        if m == 0:
            return None, bv.panel_dots_ref(Vrows, Wm)
        if m == 1:
            return bv.panel_update_ref(Vrows, Crows, Wm), None
        return bv.panel_update_dots_ref(Vrows, Crows, Wm)

    def plan_for(m, Wm):
        return bv.plan_panel(m, K, b, n, torch.float64)

    reach = 16 * bv.ROWS[torch.float64][bv._compiled_width(b)]
    chunks = [(k0, min(k0 + reach, K)) for k0 in range(0, K, reach)]
    U, D = bv._run_plan(0, V, W, None, plan_for, sweep)
    assert U is None and calls == [(0, *c) for c in chunks]
    assert torch.allclose(D, bv.panel_dots_ref(V, W), rtol=0, atol=1e-12)
    calls.clear()
    U, D = bv._run_plan(1, V, W, C, plan_for, sweep)
    assert D is None and calls == [(1, *c) for c in chunks]
    U_ref, D_ref = bv.panel_update_dots_ref(V, C, W)
    assert torch.allclose(U, U_ref, rtol=0, atol=1e-12)
    calls.clear()
    U, D = bv._run_plan(2, V, W, C, plan_for, sweep)
    if bv.fused_update_dots(K, b):
        assert calls == [(2, 0, K)]
    else:
        assert calls == [(1, *c) for c in chunks] + [(0, *c) for c in chunks]
    assert torch.allclose(U, U_ref, rtol=0, atol=1e-12)
    assert torch.allclose(D, D_ref, rtol=0, atol=1e-11)
