"""The complex kernels' plain versions (K1c / K2c, K3c, K4c, K6c) against
slepc_tpu on the CPU, and the complex launch planning.

The same numpy inputs go to both packages:

* ``dia_spmv_ref`` on complex diagonals against the reference's split-
  complex tier (``SplitComplexDIAOperator``: four real Pallas DIA passes in
  interpret mode, ``DIAPaddedOperator`` for c64 planes and the
  double-single ``DIAPaddedOperatorDS`` for c128 planes);
* ``csr_spmv_ref`` against the reference ``AIJOperator`` on complex data;
* ``panel_*_ref`` against the reference's conjugate CGS2
  (``slepc_tpu/bv/orthog.py``: c = V^H w, w -= V c);
* ``rotate_ref`` against numpy ``Q.T @ V``.

Tolerances, relative to the largest entry: c128 1e-13 (a double-single
plane is ~2e-15, a native sum ~1e-16, so 1e-13 leaves room for the
summation orders only), c64 1e-5 (single rounding of sums of 3-50 terms,
~1e-7 each, amplified by the cancellation of the Re / Im cross terms).
"""

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu.bv import orthog as jorth
from slepc_tpu.mat.linop import DIAOperator as JDIAOperator
from slepc_tpu.ops import dia_pallas as dp
from slepc_tpu.ops.complex_split import SplitComplexDIAOperator
from slepc_tpu_torch.bv import orthog as torth
from slepc_tpu_torch.ops import _build, bv, csr, dia, rotate


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches keep the AIJ operators this module ran
    (their pytree metadata holds a scipy matrix), and the reference raises
    when a later module of the same process runs another operator of that
    shape (tests/test_eps_krylovschur.py's Markov chain after the one of
    tests/test_torch_nhep.py): drop them when the module ends."""
    yield
    jax.clear_caches()


RB = 8  # block_rows of the padded Pallas operators (test scale)
TOL = {np.complex64: 1e-5, np.complex128: 1e-13}
TORCH = {np.complex64: torch.complex64, np.complex128: torch.complex128}


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _cplx(rng, shape, dtype):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _split_pallas(offsets, d):
    """The reference's split-complex operator on its Pallas planes."""
    rdt = np.float32 if d.dtype == np.complex64 else np.float64
    kind = dp.DIAPaddedOperator if rdt == np.float32 \
        else dp.DIAPaddedOperatorDS
    planes = [kind.from_dia(JDIAOperator(offsets, np.ascontiguousarray(
        p.astype(rdt))), block_rows=RB) for p in (d.real, d.imag)]
    return SplitComplexDIAOperator(*planes)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("kind", ["tridiag", "lap2", "lap3"])
def test_dia_plain_version_matches_split_pallas(kind, dtype):
    base = {"tridiag": None, "lap2": jst.laplacian_2d(24, 23),
            "lap3": jst.laplacian_3d(7, 6, 5)}[kind]
    offsets = (-1, 0, 1) if base is None else tuple(base.offsets)
    n = 1000 if base is None else base.shape[0]
    rng = np.random.default_rng(3)
    d = _cplx(rng, (len(offsets), n), dtype)
    x = _cplx(rng, n, dtype)
    op = _split_pallas(offsets, d)
    assert op.padded
    yj = op.unpad_split(op.mult_split(op.pad_split(x)))
    y = dia.dia_spmv(offsets, torch.from_numpy(d), torch.from_numpy(x))
    assert y.dtype == TORCH[dtype]
    assert _rel(y.numpy(), yj) < TOL[dtype]
    # and the operator class: mult, mult_h (the adjoint's diagonals, on
    # the same kernel) and mult_block
    # (one mult a row for a complex block) against scipy
    A = tst.DIAOperator(offsets, d, device="cpu")
    As = A.to_scipy()
    assert _rel(A.mult(torch.from_numpy(x)).numpy(), As @ x) < TOL[dtype]
    assert _rel(A.mult_h(torch.from_numpy(x)).numpy(),
                As.conj().T @ x) < TOL[dtype]
    X = _cplx(rng, (3, n), dtype)
    assert _rel(A.mult_block(torch.from_numpy(X)).numpy(),
                (As @ X.T).T) < TOL[dtype]


@pytest.mark.parametrize("form", ["dia", "csr", "dense"])
def test_real_operators_apply_to_complex_vectors_by_parts(form):
    """A real B meets the complex vectors of a complex A (GHEP), a real A
    those of a complex shift: each real operator applies itself to the real
    and imaginary parts (each on its real kernel on a card)."""
    L = tst.laplacian_2d(9, 8, device="cpu")
    A = {"dia": L, "csr": tst.from_scipy(L.to_scipy(), device="cpu"),
         "dense": tst.DenseOperator(L.to_dense(), device="cpu")}[form]
    rng = np.random.default_rng(4)
    x = _cplx(rng, 72, np.complex128)
    Ad = L.to_dense().numpy()
    assert _rel(A.mult(torch.from_numpy(x)).numpy(), Ad @ x) < 1e-15
    if form == "dia":
        X = _cplx(rng, (10, 72), np.complex128)
        assert _rel(A.mult_block(torch.from_numpy(X)).numpy(),
                    X @ Ad.T) < 1e-15


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_csr_plain_version_matches_reference_aij(dtype):
    rng = np.random.default_rng(5)
    n = 700
    M = sp.random(n, n, density=0.02, random_state=rng, format="csr")
    M2 = sp.random(n, n, density=0.02, random_state=rng, format="csr")
    C = (M + 1j * M2).astype(dtype).tocsr()
    C[3, :] = 0.0  # an empty row
    C.eliminate_zeros()
    x = _cplx(rng, n, dtype)
    yj = np.asarray(jst.AIJOperator.from_scipy(C).mult(jnp.asarray(x)))
    top = tst.from_scipy(C, device="cpu")
    assert top.dtype == TORCH[dtype]
    y = csr.csr_spmv(top.rowptr, top.cols, top.vals, torch.from_numpy(x), n)
    assert _rel(y.numpy(), yj) < TOL[dtype]
    assert _rel(top.mult_h(torch.from_numpy(x)).numpy(),
                C.conj().T @ x) < TOL[dtype]
    assert csr.CSR_BUDGET[TORCH[dtype]] == {np.complex64: 2048,
                                            np.complex128: 1024}[dtype]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("K,b", [(1, 1), (12, 1), (49, 1), (20, 4)])
def test_panel_plain_versions_match_conjugate_cgs(K, b, dtype):
    rng = np.random.default_rng(K + b)
    n = 300
    V = np.linalg.qr(_cplx(rng, (n, K), np.complex128))[0].astype(dtype)
    W = _cplx(rng, (n, b), dtype)
    mask = jnp.ones(K, dtype=np.float32 if dtype == np.complex64
                    else np.float64)
    Vt = torch.from_numpy(np.ascontiguousarray(V.T))
    Wt = torch.from_numpy(np.ascontiguousarray(W.T))
    # dots: c = V^H w (the conjugate on the basis)
    Cj = np.stack([np.asarray(jorth.project_coeffs(jnp.asarray(V), mask,
                                                   jnp.asarray(W[:, m])))
                   for m in range(b)], axis=1)
    C = bv.panel_dots(Vt, Wt)
    assert C.dtype == TORCH[dtype] and _rel(C.numpy(), Cj) < TOL[dtype]
    # update: w - V c (no conjugate), one CGS pass of the reference
    Uj = np.stack([np.asarray(jorth.cgs_pass(
        jnp.asarray(V), mask, jnp.asarray(W[:, m]),
        jnp.asarray(W[:, m]))[0]) for m in range(b)])
    U = bv.panel_update(Vt, C, Wt)
    assert _rel(U.numpy(), Uj) < TOL[dtype]
    # update + dots: the second pass's coefficients
    U2, D2 = bv.panel_update_dots(Vt, C, Wt)
    assert _rel(U2.numpy(), Uj) < TOL[dtype]
    D2j = np.stack([np.asarray(jorth.project_coeffs(
        jnp.asarray(V), mask, jnp.asarray(Uj[m]))) for m in range(b)], 1)
    scale = float(np.abs(np.asarray(Cj)).max())
    assert float(np.abs(D2.numpy() - D2j).max()) < TOL[dtype] * scale
    # a whole CGS2 column against the reference's orthogonalize_vec
    if b == 1:
        wj, cj, nbj, naj = jorth.orthogonalize_vec(
            jnp.asarray(V), mask, jnp.asarray(W[:, 0]))
        wt, ct, nbt, nat = torth.orthogonalize_vec(Vt, Wt[0])
        assert _rel(wt.numpy(), wj) < TOL[dtype]
        assert _rel(ct.numpy(), cj) < TOL[dtype]
        assert abs(float(nat) - float(np.real(naj))) < 1e3 * TOL[dtype]
        assert not nat.is_complex()


@pytest.mark.parametrize("name", ["cholqr", "cholqr2", "svqb", "mgs_block"])
def test_complex_block_orthonormalization_matches_reference(name):
    rng = np.random.default_rng(6)
    n, m = 70, 11
    X = _cplx(rng, (n, m), np.complex128) @ np.diag(np.logspace(0, 2, m))
    Qj, Fj = getattr(jorth, name)(jnp.asarray(X))
    Qt, Ft = getattr(torth, name)(torch.from_numpy(X.T.copy()))
    Qt = Qt.numpy()
    np.testing.assert_allclose(Qt.conj() @ Qt.T, np.eye(m), atol=1e-10)
    # columns agree up to a unit phase
    ph = np.sum(Qt.T.conj() * np.asarray(Qj), axis=0)
    assert np.abs(Qt.T * (ph / np.abs(ph)) - np.asarray(Qj)).max() < 1e-10
    if name == "svqb":  # Q_cols = X_cols T
        np.testing.assert_allclose(X @ Ft, Qt.T, atol=1e-10)
    else:               # X_cols = Q_cols R
        np.testing.assert_allclose(Qt.T @ Ft, X, atol=1e-9)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("K,P", [(48, 40), (48, 1), (4, 4), (70, 66)])
def test_rotate_plain_version_matches_numpy(K, P, dtype):
    rng = np.random.default_rng(K * P)
    n = 257
    Q = _cplx(rng, (K, P), dtype)
    V = _cplx(rng, (K, n), dtype)
    want = Q.astype(np.complex128).T @ V.astype(np.complex128)
    got = rotate.rotate(torch.from_numpy(Q), torch.from_numpy(V))
    assert got.dtype == TORCH[dtype] and _rel(got.numpy(), want) < TOL[dtype]
    # in place, as the restart writes V[:P]
    if P <= K:
        Vt = torch.from_numpy(V.copy())
        rotate.rotate(torch.from_numpy(Q), Vt, out=Vt[:P])
        assert _rel(Vt[:P].numpy(), want) < TOL[dtype]
    # a real Q on a complex V is the real rotation of the (K, 2n) real view
    Qr = rng.standard_normal((K, P)).astype(np.float32 if dtype ==
                                            np.complex64 else np.float64)
    got = rotate.rotate(torch.from_numpy(Qr), torch.from_numpy(V))
    assert got.dtype == TORCH[dtype]
    assert _rel(got.numpy(), Qr.T @ V.astype(np.complex128)) < TOL[dtype]


@pytest.mark.parametrize("dtype,elt", [(torch.complex64, 8),
                                       (torch.complex128, 16)])
def test_complex_launch_plans(dtype, elt):
    """K3c / K4c plan with the complex element sizes: a 16-byte load is two
    c64 or one c128 value; K4c c128 is the real form on the f64 tensor cores
    (8 warps of 8 complex columns, Q^T as complex rows of a stride = 2 mod
    8, ring rows of 68 complex), K4c c64 the FP32 register tile (a warp of
    8 rows, a lane of 4 complex columns, 128 columns a tile); both take the
    ring depth that gives the most blocks an SM."""
    n = 10_000_000
    pl = bv.plan_panel(2, 49, 1, n, dtype)
    assert pl["vec"] and pl["launches"][0]["tile"] == 32 * (16 // elt)
    assert pl["launches"][0]["smem"] == bv._block_smem(
        2, 1, pl["launches"][0]["groups"], pl["launches"][0]["cw"],
        16 // elt, dtype)
    pr = rotate.plan_rotate(48, 40, n, dtype)
    if dtype == torch.complex128:
        assert pr["variant"] == "mma_c128" and pr["tile"] == 64
        assert pr["threads"] == 256 and pr["row_tiles"] == 5
        assert pr["smem"] == (40 * 50 + pr["stages"] * rotate.CHUNK * 68) * elt
    else:
        assert pr["variant"] == "ffma_c64" and pr["tile"] == 128
        assert pr["threads"] == 32 * 5
        assert pr["smem"] == (48 * 40 + pr["stages"] * rotate.CHUNK * 128) * elt
    # an odd n on c64 takes 8-byte copies; c128 is 16 bytes either way
    assert rotate.plan_rotate(48, 40, n + 1, dtype)["vec"] == \
        (dtype == torch.complex128)
    # the ring depth with the most blocks an SM, the deepest of those
    occ = {2: 3, 3: 3, 4: 2}
    got = rotate.plan_rotate(48, 40, n, dtype,
                             blocks_per_sm=lambda vec, K, P, s: occ[s])
    assert got["stages"] == 3 and got["grid"] == 132 * 3


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("K,P,n,base", [
    (49, 40, 10_350_000, 0),      # K not a multiple of 4 (nor of 2: c128 pads)
    (47, 33, 4097, 0),            # odd n: c64's narrow copies
    (3, 9, 130, 8),               # a base 8 bytes off: c64's narrow copies
    (130, 130, 1000, 0),          # Q wider than one launch
    (48, 200, 100_003, 0),        # three launches and a ragged last one
    (1, 1, 1, 0)])
def test_complex_rotate_plan_cases(dtype, K, P, n, base):
    plan = rotate.plan_rotate(K, P, n, dtype, v_base=base, out_base=base)
    mp = plan["max_p"]
    assert mp == rotate.MAX_P == 64
    assert plan["chunks"] == [(p0, min(p0 + mp, P)) for p0 in range(0, P, mp)]
    pc = plan["chunks"][0][1]
    assert 8 * plan["row_tiles"] >= pc and plan["threads"] % 32 == 0
    assert 2 <= plan["stages"] <= 4 and plan["smem"] <= rotate.SMEM_LIMIT
    elt = dtype.itemsize
    # a c128 row is 16-byte aligned whatever n is (its base always is)
    assert plan["vec"] == (n % (16 // elt) == 0 and base % 16 == 0)
    if dtype == torch.complex128:
        kpad = -(-K // 2) * 2
        sq = rotate._q_stride128(kpad)
        assert sq >= kpad and sq % 8 == 2
        assert plan["smem"] == (8 * plan["row_tiles"] * sq + plan["stages"]
                                * rotate.CHUNK * 68) * elt
    else:
        assert plan["smem"] == (K * 8 * plan["row_tiles"] + plan["stages"]
                                * rotate.CHUNK * 128) * elt
    assert 1 <= plan["grid"] <= -(-n // plan["tile"])


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_rotate_plan_refuses_a_q_too_tall(dtype):
    # the ring shrinks first; past two stages no block holds Q^T
    K = {torch.complex64: 350, torch.complex128: 180}[dtype]
    assert rotate.plan_rotate(K, 64, 1000, dtype)["stages"] < 4
    with pytest.raises(ValueError, match="shared memory"):
        rotate.plan_rotate(2 * K, 64, 1000, dtype)
    with pytest.raises(ValueError, match="empty"):
        rotate.plan_rotate(0, 4, 10, dtype)
    # a quarter of that height fits
    assert rotate.plan_rotate(K // 4, 64, 1000, dtype)["smem"] <= \
        rotate.SMEM_LIMIT


def _real_form(Q):
    """The A operand K4c c128 forms lane by lane from Q^T in shared memory
    (csrc/rotate.cu): the (2P, 2K) real matrix whose product with the
    (2K, n) real view of V, row 2k + part holding part (Re, Im) of V[k],
    is Re Q^T V (rows 0..P-1, an m16 tile's rows g) over Im Q^T V (rows
    P..2P-1, its rows g + 8): Qr for an even k4 index and -Qi for an odd
    one in the Re rows, Qi and Qr in the Im rows."""
    K, P = Q.shape
    A = Q.real.new_empty((2 * P, 2 * K))
    A[:P, 0::2], A[:P, 1::2] = Q.real.T, -Q.imag.T
    A[P:, 0::2], A[P:, 1::2] = Q.imag.T, Q.real.T
    return A


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("K,P", [(48, 40), (49, 33), (1, 1), (7, 64)])
def test_rotate_real_form_matches_plain(dtype, K, P):
    """K4c c128's real form of the product is Re and Im of Q^T V."""
    rng = np.random.default_rng(K + P)
    n = 33
    Q = torch.from_numpy(_cplx(rng, (K, P), dtype))
    V = torch.from_numpy(_cplx(rng, (K, n), dtype))
    A = _real_form(Q)
    B = torch.view_as_real(V).permute(0, 2, 1).reshape(2 * K, n)
    got = torch.complex(*(A @ B).split(P))
    assert _rel(got.numpy(), rotate.rotate_ref(Q, V).numpy()) < TOL[dtype]


@pytest.mark.parametrize("dtype,rows", [
    (torch.float32, {1: 8, 2: 8, 4: 4, 8: 4}),
    (torch.float64, {1: 8, 2: 8, 4: 4, 8: 4}),
    (torch.complex64, {1: 8, 2: 8, 4: 4, 8: 2}),
    (torch.complex128, {1: 7, 2: 4, 4: 4, 8: 1})])
def test_panel_rows_per_type(dtype, rows):
    """K3's rows a thread holds, per element type and compiled width: the
    plan's reach (16 row groups) and its row chunks follow them."""
    assert bv.ROWS[dtype] == rows
    for b in range(1, 9):
        width = bv._compiled_width(b)
        plan = bv.plan_panel(0, 130, b, 4096, dtype)
        assert plan["rows"] == rows[width]
        reach = bv.MAX_GROUPS * rows[width]
        assert [(o["k0"], o["k1"]) for o in plan["launches"]] == [
            (k0, min(k0 + reach, 130)) for k0 in range(0, 130, reach)]


@pytest.mark.parametrize("dtype,fused", [
    (torch.float64, {(49, 1): True, (49, 2): True, (64, 4): True,
                     (65, 4): False, (49, 8): False, (128, 2): True}),
    (torch.complex64, {(49, 1): True, (49, 2): True, (64, 4): True,
                       (65, 4): False, (49, 8): False, (128, 2): True}),
    (torch.complex128, {(49, 1): True, (49, 2): True, (64, 2): True,
                        (65, 2): False, (49, 3): False, (4, 4): False,
                        (112, 1): True, (113, 1): False})])
def test_fused_update_dots_per_type(dtype, fused):
    """update+dots is one kernel within a block's reach below width 8, and
    below width 4 for complex128; else the update and dots sweeps, which
    plan_panel plans each."""
    for (K, b), want in fused.items():
        assert bv.fused_update_dots(K, b, dtype) == want
        if want:
            assert bv.plan_panel(2, K, b, 1000, dtype)["launches"]
        else:
            with pytest.raises(ValueError, match="planned each"):
                bv.plan_panel(2, K, b, 1000, dtype)
    assert bv.fused_update_dots(49, 4) == bv.fused_update_dots(
        49, 4, torch.float64)  # the real plan is the default


def test_complex_dtype_codes_and_launch_counters():
    assert _build.DTYPE_CODE["torch.complex64"] == 2
    assert _build.DTYPE_CODE["torch.complex128"] == 3
    assert _build.dtype_code(torch.zeros(1, dtype=torch.complex128)) == 3
    with pytest.raises(TypeError, match="complex128"):
        _build.dtype_code(torch.zeros(1, dtype=torch.int32))
    counts = tst.launch_counts()
    for key in ("dia_spmv_c64", "dia_spmv_c128", "csr_spmv_c64",
                "csr_spmv_c128", "rotate_c64", "rotate_c128",
                "panel_dots_c128", "panel_update_c64",
                "panel_update_dots_c128"):
        assert counts[key] == 0  # the plain versions launch nothing
    for key in ("dia_spmm_c64", "dia_spmm_c128"):  # K5c
        assert counts[key] == 0
