"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and the CUDA toolkit, so they skip on a CPU-only
host.  Run them on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest`` because tests/conftest.py sets up JAX, which the port's
machine need not have).  Shapes are small and odd on purpose: ragged tiles,
strided basis prefixes, offsets at and past the vector ends, empty CSR rows
and rows far longer than the lanes the CSR kernel gives a row.
"""

import ctypes

import numpy as np
import pytest
import torch

import slepc_tpu_torch as stt
from slepc_tpu_torch.ksp import tridiag_device as td
from slepc_tpu_torch.ops import _build, bv, csr, dia, rotate, stream

pytestmark = pytest.mark.gpu

DTYPES = [(torch.float32, 2e-6), (torch.float64, 1e-14)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rand(shape, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n,offsets", [
    (1, (0,)), (7, (-9, -1, 0, 1, 9)), (1000, (-200, -1, 0, 1, 200)),
    (45_013, (-45_000, -200, -1, 0, 1, 200, 45_000))])
def test_dia_kernel_matches_plain(cuda, dtype, tol, n, offsets):
    d = _rand((len(offsets), n), dtype, cuda, 0)
    x = _rand((n,), dtype, cuda, 1)
    before = dict(dia.launches)
    y = dia.dia_spmv(offsets, d, x)
    ref = dia.dia_spmv_ref(offsets, d, x)
    torch.cuda.synchronize()
    scale = dia.dia_spmv_ref(offsets, d.abs(), x.abs()).max()
    assert float((y - ref).abs().max() / scale) <= 4 * tol
    key = "dia_spmv_f64" if dtype == torch.float64 else "dia_spmv_f32"
    assert dia.launches[key] == before[key] + 1


# K3 / K4 at the edges of their designs: K around the rows a thread holds
# (8 or 4) and past one block's reach (16 row groups: K = 65 at b > 2, 129),
# every panel width, n below one tile, odd (f64) or not a multiple of 4
# (f32: the one-element loads), and over many strides of the grid.
PANEL_K = [1, 3, 5, 17, 49, 65, 129]
PANEL_N = [1, 37, 130, 4096, 4097, 100_003, 300_004]
PANEL_CASES = [(9, 3, 130), (33, 8, 4097), (49, 1, 100_003), (64, 2, 777)] + [
    (K, b, PANEL_N[(i + b) % len(PANEL_N)])
    for i, K in enumerate(PANEL_K) for b in range(1, 9)]


def _panel_check(V, W, C, tol):
    dscale = V.abs() @ W.abs().T
    uscale = W.abs() + C.abs().T @ V.abs()
    D = bv.panel_dots(V, W)
    assert float(((D - bv.panel_dots_ref(V, W)).abs() / dscale).max()) <= tol
    U = bv.panel_update(V, C, W)
    U_ref = bv.panel_update_ref(V, C, W)
    assert float(((U - U_ref).abs() / uscale).max()) <= tol
    U2, D2 = bv.panel_update_dots(V, C, W)
    assert float(((U2 - U_ref).abs() / uscale).max()) <= tol
    d2scale = V.abs() @ U_ref.abs().T
    assert float(((D2 - bv.panel_dots_ref(V, U_ref)).abs()
                  / d2scale).max()) <= 10 * tol
    # deterministic: no atomics, same bits every time
    assert torch.equal(bv.panel_dots(V, W), D)
    U3, D3 = bv.panel_update_dots(V, C, W)
    assert torch.equal(U3, U2) and torch.equal(D3, D2)
    assert torch.equal(bv.panel_update(V, C, W), U)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("K,b,n", PANEL_CASES)
def test_panel_kernels_match_plain(cuda, dtype, tol, K, b, n):
    # V is the prefix of a taller basis, as in the Krylov cycle
    Vfull = _rand((K + 3, n), dtype, cuda, 2)
    V = Vfull[:K]
    W = _rand((b, n), dtype, cuda, 3)
    C = _rand((K, b), dtype, cuda, 4)
    _panel_check(V, W, C, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("layout", ["offset", "w_row_strided", "padded_rows",
                                    "w_in_basis"])
@pytest.mark.parametrize("K,b,n", [(17, 1, 4096), (49, 4, 20_000),
                                   (5, 8, 1024)])
def test_panel_kernels_take_views(cuda, dtype, tol, layout, K, b, n):
    C = _rand((K, b), dtype, cuda, 4)
    if layout == "offset":  # bases that are not 16-byte aligned
        V = _rand((K + 1, n + 1), dtype, cuda, 2)[:K, 1:]
        W = _rand((b, n + 1), dtype, cuda, 3)[:, 1:]
    elif layout == "w_row_strided":  # every other row of a taller panel
        V = _rand((K, n), dtype, cuda, 2)
        W = _rand((2 * b, n), dtype, cuda, 3)[::2]
    elif layout == "padded_rows":  # aligned rows longer than n
        V = _rand((K, n + 4), dtype, cuda, 2)[:, :n]
        W = _rand((b, n + 8), dtype, cuda, 3)[:, :n]
    else:  # the panel is rows of the same buffer as the basis
        full = _rand((K + b, n), dtype, cuda, 2)
        V, W = full[:K], full[K:]
    before = dict(bv.launches)
    _panel_check(V, W, C, tol)
    t = "f64" if dtype == torch.float64 else "f32"
    assert bv.launches[f"panel_dots_{t}"] > before[f"panel_dots_{t}"]


def test_panel_plan_matches_the_compiled_kernel(cuda):
    lib = _build.load()
    assert lib.slepc_panel_max_b() == bv.MAX_B
    assert lib.slepc_panel_max_groups() == bv.MAX_GROUPS
    for dtype in bv.ROWS:
        for b in range(1, 9):
            assert lib.slepc_panel_rows(_build.DTYPE_CODE[str(dtype)], b) == \
                bv.ROWS[dtype][bv._compiled_width(b)]
    for dtype in (torch.float32, torch.float64):
        code = 0 if dtype == torch.float32 else 1
        for mode in (0, 1, 2):
            for K, b, n in [(1, 1, 10), (49, 1, 4096), (52, 4, 4096),
                            (129, 8, 4097), (64, 8, 1 << 20)]:
                if mode == 2 and not bv.fused_update_dots(K, b):
                    with pytest.raises(ValueError, match="planned each"):
                        bv.plan_panel(mode, K, b, n, dtype)
                    continue
                plan = bv.plan_panel(mode, K, b, n, dtype)
                for one in plan["launches"]:
                    assert one["smem"] == lib.slepc_panel_smem(
                        code, mode, b, one["groups"], one["cw"],
                        int(plan["vec"]))


ROTATE_K = [1, 3, 5, 17, 49, 65, 129]
ROTATE_P = [1, 7, 8, 9, 40, 64]
ROTATE_N = [1, 37, 130, 4096, 4101, 100_003, 300_004]
ROTATE_CASES = [(24, 18, 4096 + 5), (48, 40, 100_003), (64, 64, 333),
                (100, 130, 1000)] + [
    (K, P, ROTATE_N[(i + j) % len(ROTATE_N)])
    for i, K in enumerate(ROTATE_K) for j, P in enumerate(ROTATE_P)]


def _rotate_tol(dtype, tol, K):
    # past K = 64 the bound is K * eps: the kernel takes the k-sum in
    # another order than cuBLAS takes it
    return max(tol, K * torch.finfo(dtype).eps)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-14)])
@pytest.mark.parametrize("K,P,n", ROTATE_CASES)
def test_rotate_kernel_matches_plain(cuda, dtype, tol, K, P, n):
    full = _rand((K + 1, n), dtype, cuda, 5)
    V = full[:K]
    Q = _rand((K, P), dtype, cuda, 6)
    key = "rotate_f64" if dtype == torch.float64 else "rotate_f32"
    before = rotate.launches[key]
    out = rotate.rotate(Q, V)
    assert rotate.launches[key] == before + -(-P // rotate.MAX_P)
    ref = rotate.rotate_ref(Q, V)
    err = (out - ref).abs() / (Q.abs().T @ V.abs())
    assert float(err.max()) <= _rotate_tol(dtype, tol, K)
    # deterministic: fixed order of the k-sum, same bits every time
    assert torch.equal(rotate.rotate(Q, V), out)
    # into a given buffer, and in place into rows of V itself
    buf = torch.full_like(out, float("nan"))
    assert rotate.rotate(Q, V, out=buf) is buf and torch.equal(buf, out)
    if P <= K:
        for r0 in (0, K - P):
            work = full.clone()
            rotate.rotate(Q, work[:K], out=work[r0: r0 + P])
            assert torch.equal(work[r0: r0 + P], out)
            keep = torch.ones(K + 1, dtype=torch.bool, device=cuda)
            keep[r0: r0 + P] = False
            assert torch.equal(work[keep], full[keep])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-14)])
@pytest.mark.parametrize("layout", ["offset", "padded_rows", "out_offset"])
@pytest.mark.parametrize("K,P,n", [(48, 40, 20_000), (20, 1, 4096),
                                   (4, 4, 1024)])
def test_rotate_kernel_takes_views(cuda, dtype, tol, layout, K, P, n):
    Q = _rand((K, P), dtype, cuda, 6)
    out = None
    if layout == "offset":  # a base that is not 16-byte aligned, in place
        full = _rand((K + 1, n + 1), dtype, cuda, 5)
        V = full[:K, 1:]
        out = V[:P]
    elif layout == "padded_rows":  # aligned rows longer than n
        V = _rand((K, n + 4), dtype, cuda, 5)[:, :n]
    else:  # aligned V, out at an odd element offset
        V = _rand((K, n), dtype, cuda, 5)
        out = torch.empty((P, n + 1), dtype=dtype, device=cuda)[:, 1:]
    ref = rotate.rotate_ref(Q, V)
    scale = Q.abs().T @ V.abs()
    got = rotate.rotate(Q, V, out=out)
    assert float(((got - ref).abs() / scale).max()) <= _rotate_tol(dtype, tol, K)


def test_rotate_plan_matches_the_compiled_kernel(cuda):
    lib = _build.load()
    assert lib.slepc_rotate_max_p() == rotate.MAX_P
    for dtype in (torch.float32, torch.float64):
        code = 0 if dtype == torch.float32 else 1
        for K, P in [(1, 1), (48, 40), (49, 24), (129, 64), (20, 1), (4, 4),
                     (400, 8)]:
            plan = rotate.plan_rotate(K, P, 100_000, dtype)
            assert plan["smem"] == lib.slepc_rotate_smem(code, K, P,
                                                         plan["stages"])


def test_rotate_rejects_overlaps_and_shapes(cuda):
    f64 = torch.float64
    full = torch.zeros((12, 64), dtype=f64, device=cuda)
    V = full[:8]
    Q = torch.zeros((8, 4), dtype=f64, device=cuda)
    before = stt.launch_counts()
    with pytest.raises(ValueError, match="overlaps V"):
        rotate.rotate(Q, V, out=full.view(-1)[8: 8 + 4 * 64].view(4, 64))
    with pytest.raises(ValueError, match="overlaps V"):
        rotate.rotate(Q, V, out=full[::2][:4])  # rows of V at another stride
    with pytest.raises(ValueError, match="overlaps Q"):
        rotate.rotate(full[:8, :4], torch.zeros((8, 4), dtype=f64, device=cuda),
                      out=full[:4, :4])
    with pytest.raises(ValueError, match="is not"):
        rotate.rotate(Q, V, out=torch.zeros((5, 64), dtype=f64, device=cuda))
    with pytest.raises(ValueError, match="dtype or device"):
        rotate.rotate(Q, V, out=torch.zeros((4, 64), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        rotate.rotate(Q, V, out=torch.zeros((4, 128), dtype=f64,
                                            device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="shared memory"):
        rotate.rotate(torch.zeros((600, 64), dtype=f64, device=cuda),
                      torch.zeros((600, 64), dtype=f64, device=cuda))
    with pytest.raises(ValueError, match="does not match"):
        rotate.rotate(Q[:7], V)
    assert stt.launch_counts() == before


def test_kernels_reject_what_they_do_not_take(cuda):
    V = torch.zeros((4, 10), dtype=torch.float64, device=cuda)
    before = stt.launch_counts()
    with pytest.raises(ValueError):
        bv.panel_dots(V, torch.zeros((9, 10), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        bv.panel_dots(V, torch.zeros((1, 10), dtype=torch.float32, device=cuda))
    with pytest.raises(TypeError):
        dia.dia_spmv((0,), torch.zeros((1, 10), dtype=torch.float16, device=cuda),
                     torch.zeros(10, dtype=torch.float16, device=cuda))
    # a DIA operator takes x of exactly its column count (a shorter x would
    # give the product of its leading block)
    A = stt.laplacian_2d(6, 5, device=cuda)
    for wrong in (29, 31):
        x = torch.ones(wrong, dtype=torch.float64, device=cuda)
        for call in (A.mult, A.mult_h, lambda v: A.mult_block(v[None])):
            with pytest.raises(ValueError, match="30 columns"):
                call(x)
    assert stt.launch_counts() == before


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b", range(1, 9))
@pytest.mark.parametrize("n,offsets", [
    (7, (-9, -1, 0, 1, 9)), (1001, (-200, -1, 0, 1, 200)),
    (45_013, (-45_000, -200, -1, 0, 1, 200, 45_000))])
def test_dia_block_kernel_matches_plain(cuda, dtype, tol, b, n, offsets):
    d = _rand((len(offsets), n), dtype, cuda, 0)
    # X is b rows of a wider basis (row stride n + 3), as K5 takes a slice
    # of the cycle's basis without a copy
    X = _rand((b + 4, n + 3), dtype, cuda, 1)[2:2 + b, :n]
    assert X.stride(0) == n + 3
    key = "dia_spmm_f64" if dtype == torch.float64 else "dia_spmm_f32"
    before = dia.launches[key]
    Y = dia.dia_spmm(offsets, d, X)
    ref = dia.dia_spmm_ref(offsets, d, X)
    torch.cuda.synchronize()
    assert dia.launches[key] == before + 1
    assert Y.shape == (b, n)
    scale = dia.dia_spmm_ref(offsets, d.abs(), X.abs()).max()
    assert float((Y - ref).abs().max() / scale) <= 4 * tol
    # row m is K1/K2's product with X[m]
    Y1 = torch.stack([dia.dia_spmv(offsets, d, X[m].contiguous())
                      for m in range(b)])
    assert float((Y - Y1).abs().max() / scale) <= 4 * tol
    # deterministic: same bits every time
    assert torch.equal(dia.dia_spmm(offsets, d, X), Y)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b", [1, 3, 4, 8])
@pytest.mark.parametrize("layout", ["aligned", "odd_stride", "odd_base",
                                    "odd_n"])
def test_dia_block_kernel_near_and_far(cuda, dtype, tol, b, layout):
    # offsets inside the staged window, beyond it (the plan's cap: +-3000
    # at b >= 3 in f64) and past +-n; X a row slice of a taller basis with
    # an aligned row stride (16-byte copies), an odd one or an odd base (one
    # element a copy); an odd n (a ragged last tile)
    n = 20_001 if layout == "odd_n" else 20_000
    offsets = (-30_000, -3000, -700, -5, -1, 0, 1, 5, 700, 3000, 30_000)
    tile = 1024
    plan = dia.plan_spmm(offsets, n, b, dtype, tile)
    d = _rand((len(offsets), n), dtype, cuda, 2)
    width = n + {"aligned": 8, "odd_stride": 3, "odd_base": 8, "odd_n": 5}[layout]
    V = _rand((b + 3, width), dtype, cuda, 3)
    start = 1 if layout == "odd_base" else 0
    X = V[2:2 + b, start:start + n]
    assert lib_smem(dtype, b, plan) == plan.smem
    Y = dia.dia_spmm(offsets, d, X, tile=tile)
    ref = dia.dia_spmm_ref(offsets, d, X)
    scale = dia.dia_spmm_ref(offsets, d.abs(), X.abs()).max()
    assert float((Y - ref).abs().max() / scale) <= 4 * tol
    for _ in range(3):  # bitwise repeatable
        assert torch.equal(dia.dia_spmm(offsets, d, X, tile=tile), Y)
    if b >= 3 and dtype == torch.float64:  # +-3000 past the cap: direct
        assert plan.where[1] == plan.where[9] == dia.DIRECT


def lib_smem(dtype, b, plan):
    code = _build.DTYPE_CODE[str(dtype)]
    return 0 if dia.NEAR not in plan.where else \
        _build.load().slepc_dia_spmm_smem(code, b, plan.tile, plan.halo)


def test_dia_block_kernel_rejects_what_it_does_not_take(cuda):
    offsets = (-1, 0, 1)
    d = torch.ones((3, 50), dtype=torch.float64, device=cuda)
    X = torch.ones((9, 50), dtype=torch.float64, device=cuda)
    before = dict(dia.launches)
    with pytest.raises(ValueError, match="does not match"):
        dia.dia_spmm(offsets, d, X[0])  # a vector, not a (b, n) block
    with pytest.raises(ValueError, match="dtype or device"):
        dia.dia_spmm(offsets, d, X[:4].float())
    with pytest.raises(ValueError, match="dtype or device"):
        dia.dia_spmm(offsets, d, X[:4].cpu())
    with pytest.raises(ValueError, match="contiguous"):
        dia.dia_spmm(offsets, d, torch.ones((4, 100), dtype=torch.float64,
                                           device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="diagonals"):
        dia.dia_spmm(tuple(range(33)), torch.ones((33, 50), dtype=torch.float64,
                                                  device=cuda), X[:4])
    op = stt.DIAOperator(offsets, d)
    with pytest.raises(ValueError, match="50 columns"):
        op.mult_block(X[:4, :49])
    assert dia.launches == before


# ---- the fused Chebyshev step (K2's and K5's designs with an epilogue) ----

# (alpha, beta) of a filter's first step (-a, b) and of a later one
# (-2a, 2b); a later step subtracts p = t_{k-1}
CHEB_COEFFS = {"first": (-0.61, 1.37), "later": (-1.22, 2.74)}


def _cheb_scale(offsets, d, t, p, alpha, beta):
    """max of |alpha| |A| |t| + |beta| |t| + |p|: the size of the terms."""
    spmv = dia.dia_spmv_ref if t.dim() == 1 else dia.dia_spmm_ref
    s = abs(alpha) * spmv(offsets, d.abs(), t.abs()) + abs(beta) * t.abs()
    return (s if p is None else s + p.abs()).max()


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("step", ["first", "later"])
@pytest.mark.parametrize("n,offsets", [
    (1, (0,)), (7, (-9, -1, 0, 1, 9)), (1000, (-200, -1, 1, 200)),
    (45_013, (-45_000, -200, -1, 0, 1, 200, 45_000))])
def test_dia_cheb_step_matches_plain(cuda, dtype, tol, step, n, offsets):
    # y = alpha A t + beta t - p in one launch against the product and the
    # three passes: offsets past the ends (n = 7), no offset-0 diagonal
    # (t's own entry read on its own), the flagship's offsets
    alpha, beta = CHEB_COEFFS[step]
    d = _rand((len(offsets), n), dtype, cuda, 0)
    t = _rand((n,), dtype, cuda, 1)
    p = None if step == "first" else _rand((n,), dtype, cuda, 2)
    kept = [v.clone() for v in (t, p) if v is not None]
    before = dict(dia.launches)
    y = dia.dia_cheb_step(offsets, d, t, p, alpha, beta)
    ref = dia.dia_cheb_step_ref(offsets, d, t, p, alpha, beta)
    torch.cuda.synchronize()
    scale = _cheb_scale(offsets, d, t, p, alpha, beta)
    assert float((y - ref).abs().max() / scale) <= 4 * tol
    key = "dia_cheb_f64" if dtype == torch.float64 else "dia_cheb_f32"
    assert dia.launches == {**before, key: before[key] + 1}
    # neither input is written; the same bits every time
    assert all(torch.equal(a, b) for a, b in zip(kept, (t, p)))
    assert torch.equal(dia.dia_cheb_step(offsets, d, t, p, alpha, beta), y)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("step", ["first", "later"])
@pytest.mark.parametrize("b", [1, 3, 4, 8, 11])
@pytest.mark.parametrize("layout", ["aligned", "odd_stride", "odd_base",
                                    "odd_n", "far_only"])
def test_dia_cheb_step_block_near_and_far(cuda, dtype, tol, step, b, layout):
    # K5's design with the step at its store: offsets inside the staged
    # window, beyond it and past +-n (far_only: no window at all, X's own
    # entries read from device memory); X and P row slices of two taller
    # bases with their own row strides (aligned, odd, an odd base); an odd
    # n; b = 11 in two launches (8 + 3)
    alpha, beta = CHEB_COEFFS[step]
    n = 20_001 if layout == "odd_n" else 20_000
    offsets = (-19_000, -15_000, 15_000, 19_000) if layout == "far_only" \
        else (-30_000, -3000, -700, -5, -1, 0, 1, 5, 700, 3000, 30_000)
    tile = 1024
    d = _rand((len(offsets), n), dtype, cuda, 2)
    width = n + {"aligned": 8, "odd_stride": 3, "odd_base": 8, "odd_n": 5,
                 "far_only": 8}[layout]
    start = 1 if layout == "odd_base" else 0
    V = _rand((b + 3, width), dtype, cuda, 3)
    Q = _rand((b + 5, width + 2), dtype, cuda, 4)
    X = V[2:2 + b, start:start + n]
    P = None if step == "first" else Q[1:1 + b, start:start + n]
    if layout == "far_only":
        assert dia.NEAR not in dia.plan_spmm(offsets, n, min(b, 8), dtype,
                                             tile).where
    V0, Q0 = V.clone(), Q.clone()
    key = "dia_cheb_block_" + ("f64" if dtype == torch.float64 else "f32")
    before = dict(dia.launches)
    Y = dia.dia_cheb_step_block(offsets, d, X, P, alpha, beta, tile=tile)
    ref = dia.dia_cheb_step_block_ref(offsets, d, X, P, alpha, beta)
    torch.cuda.synchronize()
    assert dia.launches == {**before, key: before[key] + -(-b // 8)}
    assert Y.shape == (b, n)
    scale = _cheb_scale(offsets, d, X, P, alpha, beta)
    assert float((Y - ref).abs().max() / scale) <= 4 * tol
    # row m is the one-vector fused step on X[m], P[m]
    Y1 = torch.stack([dia.dia_cheb_step(
        offsets, d, X[m].contiguous(),
        None if P is None else P[m].contiguous(), alpha, beta)
        for m in range(b)])
    assert float((Y - Y1).abs().max() / scale) <= 4 * tol
    assert torch.equal(V, V0) and torch.equal(Q, Q0)
    for _ in range(2):  # bitwise repeatable
        assert torch.equal(dia.dia_cheb_step_block(offsets, d, X, P, alpha,
                                                   beta, tile=tile), Y)


def test_dia_cheb_step_rejects_what_it_does_not_take(cuda):
    offsets = (-1, 0, 1)
    d = torch.ones((3, 50), dtype=torch.float64, device=cuda)
    X = torch.ones((4, 50), dtype=torch.float64, device=cuda)
    before = dict(dia.launches)
    with pytest.raises(ValueError, match="does not match"):
        dia.dia_cheb_step(offsets, d, X[0], X[0, :49], -1.0, 2.0)
    with pytest.raises(ValueError, match="does not match"):
        dia.dia_cheb_step_block(offsets, d, X, X[:3], -1.0, 2.0)
    with pytest.raises(ValueError, match="float32 and float64"):
        dia.dia_cheb_step(offsets, d.to(torch.complex128),
                          X[0].to(torch.complex128), None, -1.0, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        dia.dia_cheb_step(offsets, d, X[0], torch.ones(
            (100,), dtype=torch.float64, device=cuda)[::2], -1.0, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        dia.dia_cheb_step_block(offsets, d, X, torch.ones(
            (4, 100), dtype=torch.float64, device=cuda)[:, ::2], -1.0, 2.0)
    assert dia.launches == before


@pytest.mark.parametrize("form", ["mult", "mult_block"])
def test_cheb_amplifier_on_the_card_matches_the_cpu(cuda, form):
    """One whole ChebAmplifyOperator(DIAOperator, lo, hi, 450) apply on the
    card, every step one fused launch, against the same apply on the CPU
    (the product and three passes)."""
    from slepc_tpu_torch.st.cheb import gershgorin_upper

    A = stt.laplacian_3d(40, 45, 46, device="cpu")
    Ac = stt.DIAOperator(A.offsets, A.diags.to(cuda))
    lo, hi, deg = 0.05, gershgorin_upper(A), 450
    shape = (A.shape[0],) if form == "mult" else (4, A.shape[0])
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(shape))
    before = dict(dia.launches)
    y = getattr(stt.ChebAmplifyOperator(Ac, lo, hi, deg), form)(x.to(cuda))
    torch.cuda.synchronize()
    key = "dia_cheb_f64" if form == "mult" else "dia_cheb_block_f64"
    assert dia.launches == {**before, key: before[key] + deg}
    ref = getattr(stt.ChebAmplifyOperator(A, lo, hi, deg), form)(x)
    assert float((y.cpu() - ref).abs().max() / ref.abs().max()) <= 1e-12


def _csr(lengths, ncols, seed):
    rng = np.random.default_rng(seed)
    rowptr = np.zeros(len(lengths) + 1, np.int64)
    rowptr[1:] = np.cumsum(lengths)
    cols = rng.integers(0, max(ncols, 1), rowptr[-1]).astype(np.int32)
    return rowptr, cols, rng.standard_normal(rowptr[-1])


def _lengths(kind):
    rng = np.random.default_rng(9)
    if kind == "empty":
        return [0], 1
    if kind == "no_rows":
        return [], 5
    if kind == "tiny":  # empty rows and a row of 40 under 8 lanes
        return [0, 3, 0, 40, 1, 0, 2], 9
    if kind == "ragged":
        ln = rng.integers(0, 13, 1001)
        ln[[5, 500, 1000]] = 500
        return ln, 1001
    ln = rng.poisson(7, 100_003)  # flagship-like rows, with long ones
    ln[::997] = 100
    return ln, 100_003


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("kind", ["empty", "no_rows", "tiny", "ragged", "big"])
def test_csr_kernel_matches_plain(cuda, dtype, tol, kind):
    lengths, ncols = _lengths(kind)
    _check_csr_kernel(cuda, dtype, tol, lengths, ncols)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("lanes,mean", [(2, 1.6), (4, 3), (8, 6), (16, 12),
                                        (32, 40)])
def test_csr_kernel_every_lane_count(cuda, dtype, tol, lanes, mean):
    # the mean row lengths that once selected each lane count, with empty
    # rows and longer rows, at budgets that make a block's rows few (several
    # lanes a row) or many (one thread a row), and past the budget
    rng = np.random.default_rng(lanes)
    lengths = rng.poisson(mean, 20_011)
    lengths[::101] = 0
    lengths[50::1009] = 3 * lanes + 1
    for budget in (64, 512, csr.CSR_BUDGET[dtype]):
        _check_csr_kernel(cuda, dtype, tol, lengths, 20_011, budget=budget)


def _check_csr_kernel(cuda, dtype, tol, lengths, ncols, budget=None,
                      vals_offset=0):
    rp, cl, vl = _csr(lengths, ncols, 7)
    rowptr = torch.from_numpy(rp).to(cuda)
    cols = torch.from_numpy(cl).to(cuda)
    # vals_offset: vals as a slice of a longer array (an unaligned base)
    vals = torch.from_numpy(np.concatenate([np.ones(vals_offset), vl])) \
        .to(cuda, dtype)[vals_offset:]
    x = _rand((ncols,), dtype, cuda, 8)
    plan = None if budget is None else csr.csr_plan(rowptr, budget)
    key = "csr_spmv_f64" if dtype == torch.float64 else "csr_spmv_f32"
    before = csr.launches[key]
    y = csr.csr_spmv(rowptr, cols, vals, x, ncols, plan=plan)
    ref = csr.csr_spmv_ref(rowptr, cols, vals, x)
    torch.cuda.synchronize()
    assert y.shape == ref.shape == (len(lengths),)
    assert csr.launches[key] == before + (1 if len(lengths) else 0)
    if len(lengths):
        scale = csr.csr_spmv_ref(rowptr, cols, vals.abs(), x.abs()).clamp_min(1)
        assert float(((y - ref).abs() / scale).max()) <= 4 * tol
        empty = torch.from_numpy(np.asarray(lengths) == 0).to(cuda)
        assert bool((y[empty] == 0).all())  # empty rows write 0
        # deterministic: no atomics, same bits every time
        for _ in range(3):
            assert torch.equal(csr.csr_spmv(rowptr, cols, vals, x, ncols,
                                            plan=plan), y)
    return rowptr, cols, vals, x, y


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("kind", ["one_row", "one_long_row", "long_rows",
                                  "at_budget", "straddle", "wide", "narrow",
                                  "hubs"])
def test_csr_kernel_row_blocks(cuda, dtype, tol, kind):
    # m = 1; a single row past the budget (cut into chunks); long rows
    # among short ones; blocks of exactly the budget; rows that straddle
    # block edges (odd lengths against a budget of 64); more columns than
    # rows, and fewer; hub rows of 10^5 entries at the default budget
    B = csr.CSR_BUDGET[dtype] if kind == "hubs" else 64
    rng = np.random.default_rng(3)
    lengths, ncols = {
        "one_row": ([5], 7),
        "one_long_row": ([5000], 300),
        "long_rows": (np.where(np.arange(3001) % 500 == 7, 700,
                               rng.integers(0, 9, 3001)), 3001),
        "at_budget": ([8] * 800, 800),
        "straddle": (rng.integers(1, 40, 4001) | 1, 4001),
        "wide": (rng.poisson(7, 1000), 50_000),
        "narrow": (rng.poisson(7, 10_000), 17),
        "hubs": (np.where(np.isin(np.arange(50_000), [3, 30_000, 49_999]),
                          100_000, rng.poisson(7, 50_000)), 50_000),
    }[kind]
    plan = csr.csr_plan(torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int64)), B)
    if kind == "at_budget":
        assert plan.nblocks == 100
    _check_csr_kernel(cuda, dtype, tol, lengths, ncols, budget=B)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_csr_kernel_takes_an_unaligned_vals_slice_and_shares_its_plan(
        cuda, dtype, tol):
    lengths = np.random.default_rng(4).poisson(7, 30_001)
    rowptr, cols, vals, x, y = _check_csr_kernel(
        cuda, dtype, tol, lengths, 30_001, vals_offset=1)
    assert vals.data_ptr() % 16 != 0
    # |A| through the plan of A: the Gershgorin bound's call
    op = stt.AIJOperator(rowptr, cols, vals, (len(lengths), 30_001))
    plan = op.row_plan()
    assert plan is op.row_plan() and plan.budget == csr.CSR_BUDGET[dtype]
    ones = torch.ones(30_001, dtype=dtype, device=cuda)
    got = csr.csr_spmv(rowptr, cols, vals.abs(), ones, 30_001, plan=plan)
    want = csr.csr_spmv_ref(rowptr, cols, vals.abs(), ones)
    assert float((got - want).abs().max() / want.abs().max()) <= 4 * tol
    assert torch.equal(op.mult(x), y)


def test_csr_kernel_rejects_what_it_does_not_take(cuda):
    rp, cl, vl = _csr([2, 0, 3], 4, 1)
    rowptr = torch.from_numpy(rp).to(cuda)
    cols = torch.from_numpy(cl).to(cuda)
    vals = torch.from_numpy(vl).to(cuda)
    x = torch.ones(8, dtype=torch.float64, device=cuda)
    before = dict(csr.launches)
    with pytest.raises(ValueError, match="contiguous"):
        csr.csr_spmv(rowptr, cols, vals, x[::2], 4)
    with pytest.raises(ValueError, match="int32"):
        csr.csr_spmv(rowptr, cols.long(), vals, x[:4], 4)
    with pytest.raises(ValueError, match="dtype or device"):
        csr.csr_spmv(rowptr, cols, vals.cpu(), x[:4], 4)
    with pytest.raises(TypeError):
        csr.csr_spmv(rowptr, cols, vals.half(), x[:4].half(), 4)
    with pytest.raises(ValueError, match="4 columns"):  # x too short to gather
        csr.csr_spmv(rowptr, cols, vals, x[:3], 4)
    with pytest.raises(ValueError, match="columns"):
        stt.AIJOperator(rowptr, cols, vals, (3, 4)).mult(x[:3])
    assert csr.launches == before
    # the planner's limits are the compiled kernel's
    lib = _build.load()
    assert lib.slepc_csr_max_rows() == csr.CSR_MAX_ROWS
    assert lib.slepc_csr_max_budget() == csr.CSR_MAX_BUDGET


def test_aij_operator_routes_to_its_kernel_on_the_card(cuda):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    L = stt.laplacian_3d(15, 16, 18).to_scipy()
    p = reverse_cuthill_mckee(sp.csr_matrix(L), symmetric_mode=True)
    A = L[p][:, p].tocsr()
    x = np.random.default_rng(3).standard_normal(A.shape[0])
    xt = torch.from_numpy(x).to(cuda)
    aij = stt.from_scipy(A, device=cuda).fast_form()
    dia_op = stt.from_scipy(L, device=cuda).fast_form()
    assert isinstance(aij, stt.AIJOperator)
    assert isinstance(dia_op, stt.DIAOperator)
    stt.reset_launch_counts()
    y = aij.mult(xt)
    yh = aij.mult_h(xt)
    yd = dia_op.mult(xt)
    counts = stt.launch_counts()
    assert counts["csr_spmv_f64"] == 2 and counts["dia_spmv_f64"] == 1
    for out, want in ((y, A @ x), (yh, A.T @ x), (yd, L @ x)):
        assert np.abs(out.cpu().numpy() - want).max() <= 1e-13


# ---- K7, the stream yardstick --------------------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("nd,n,start,pad", [
    (1, 1, 0, 0), (7, 1000, 0, 0), (7, 1001, 1, 0), (3, 4099, 3, 0),
    (32, 70_001, 0, 0), (7, 1001, 0, 3), (5, 4099, 0, 1)])
def test_stream_kernel_matches_plain(cuda, dtype, tol, nd, n, start, pad):
    # start > 0 or an odd row stride: rows that are not 16-byte aligned take
    # the scalar kernel; pad > 0: aligned rows of odd length, the vector
    # kernel and its scalar tail
    d = _rand((nd, start + n + pad), dtype, cuda, 2)[:, start: start + n]
    x = _rand((n + start,), dtype, cuda, 3)[start:].clone()
    before = dict(stream.launches)
    y = stream.stream_sum(d, x)
    ref = stream.stream_sum_ref(d, x)
    torch.cuda.synchronize()
    scale = stream.stream_sum_ref(d.abs(), x.abs()).max()
    assert float((y - ref).abs().max() / scale) <= 4 * tol
    key = "stream_sum_f64" if dtype == torch.float64 else "stream_sum_f32"
    assert stream.launches[key] == before[key] + 1
    out = torch.empty_like(x)
    assert stream.stream_sum(d, x, out=out) is out
    assert torch.equal(out, y)  # deterministic


def test_stream_rejects_without_fallback_and_measures_a_rate(cuda):
    d = torch.ones((3, 64), dtype=torch.float64, device=cuda)
    x = torch.ones(64, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        stream.stream_sum(d[:, ::2], x[:32])
    with pytest.raises(ValueError, match="dtype or device"):
        stream.stream_sum(d, x.cpu())
    with pytest.raises(TypeError, match="float32 or float64"):
        stream.stream_sum(d.half(), x.half())
    rate = stream.stream_bandwidth(7, 1 << 20, torch.float64, cuda, reps=5)
    assert 10.0 < rate < 3350.0  # GB/s, below the card's published peak


# ---- the scanned LDL^T on the card -----------------------------------------

@pytest.mark.parametrize("n,sigma", [(1000, 0.0), (100_003, 1.3),
                                     (1_000_000, 2.0001)])
def test_scanned_tridiagonal_ldlt_on_the_card(cuda, n, sigma):
    A = stt.laplacian_1d(n, device=cuda)
    a, b = td.tridiag_of_operator(A)
    exact = stt.laplacian_1d_eigs(n)
    assert int(td.tridiag_inertia(a, b, sigma)) == int(np.sum(exact < sigma))
    rhs = _rand((n,), torch.float64, cuda, 4)
    piv = td.tridiag_pivots(a, b, sigma)
    x = td.tridiag_solve(a, b, sigma, rhs, pivots=piv)
    r = A.mult(x) - sigma * x - rhs
    assert float(r.norm() / rhs.norm()) <= 1e-8
    # the same recurrences on the CPU give the same pivots
    piv_cpu = td.tridiag_pivots(a.cpu(), b.cpu(), sigma)
    ok = piv_cpu.abs() > 1e-6  # away from the near-zero pivots
    rel = ((piv.cpu() - piv_cpu).abs() / piv_cpu.abs())[ok]
    assert float(rel.median()) <= 1e-10


def test_block_tridiagonal_ldlt_on_the_card(cuda):
    A = stt.laplacian_2d(12, 9, device=cuda)
    Ab, Bb = (torch.from_numpy(M).to(cuda) for M in td.btridiag_of_operator(A))
    exact = stt.laplacian_2d_eigs(12, 9)
    for sigma in (0.0, 1.5, 3.7):
        assert int(td.btridiag_inertia(Ab, Bb, sigma)) == int(np.sum(exact < sigma))
    rhs = _rand((A.shape[0],), torch.float64, cuda, 5)
    x = td.btridiag_solve(Ab, Bb, 1.5, rhs)
    assert float((A.mult(x) - 1.5 * x - rhs).norm() / rhs.norm()) <= 1e-10


def _slicing_case(case, device):
    """(operators, interval, problem type) of a slicing case: the
    scanned tridiagonal, the block-tridiagonal and the host LDL^T pencil
    (a permuted grid Laplacian as CSR, a diagonal B)."""
    if case == "tridiag_device":
        return [stt.laplacian_1d(400, device=device)], (0.5, 0.9), "hep"
    if case == "btridiag_device":
        return [stt.laplacian_2d(12, 9, device=device)], (1.0, 2.0), "hep"
    import scipy.sparse as sp

    n = 70
    perm = np.random.default_rng(0).permutation(n)
    L = stt.laplacian_2d(10, 7, device="cpu").to_dense().numpy()
    A = stt.from_scipy(sp.csr_matrix(L[perm][:, perm]), device=device)
    bd = 1.0 + 0.3 * np.cos(np.arange(n) * 0.2)
    return [A, stt.DIAOperator((0,), bd[None, :], device=device)], \
        (0.8, 1.7), "ghep"


def _slice(ops, interval, problem_type, npart):
    eps = stt.EPS(*ops, problem_type=problem_type, options=stt.Options())
    eps.set_interval(*interval)
    eps.set_partitions(npart)
    eps.solve()
    return eps


@pytest.mark.parametrize("case", ["tridiag_device", "btridiag_device",
                                  "ldl"])
def test_slicing_partitions_on_the_card_match_one_partition_and_the_cpu(
        cuda, case):
    """Two slicing partitions on the card give one partition's values to
    1e-10 and the CPU run's nconv, values (1e-9) and factorization count,
    on the card's factorization backend, with kernels launched."""
    ops, interval, pt = _slicing_case(case, cuda)
    one = _slice(ops, interval, pt, 1)
    stt.reset_launch_counts()
    two = _slice(ops, interval, pt, 2)
    assert sum(stt.launch_counts().values()) > 0
    assert two.nconv == one.nconv > 0
    np.testing.assert_allclose(two.eigenvalues, one.eigenvalues, rtol=0,
                               atol=1e-10)
    cpu = _slice(_slicing_case(case, "cpu")[0], interval, pt, 2)
    assert cpu.nconv == two.nconv
    assert cpu.slice_factorizations == two.slice_factorizations
    np.testing.assert_allclose(two.eigenvalues, cpu.eigenvalues, rtol=1e-9)
    if case != "ldl":
        assert two.slice_backends == (case,)


def test_slicing_partitions_as_ranks_on_the_card(cuda, tmp_path):
    """Slicing's partitions as two gloo ranks sharing the card
    (tests/_torch_ranks.py's slice cases): each rank's result equals rank
    0's, and the one-process port's on the CPU (nconv, values 1e-9,
    factorizations), every pair's true residual <= 1e-8, the card's
    backend, K3 and K4 launched on rank 0 (the lead of partition 0)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_ranks as ranks

    cases = ("slice_tri_p2", "slice_grid_p2", "slice_ldl_p2")
    got = ranks.spawn(tmp_path, 2, cases, timeout=300, device="cuda")
    for c, backend in zip(cases, ("tridiag_device", "btridiag_device",
                                  None)):
        r, one = got[c], ranks.run_case(c, None)
        assert bool(r["ranks"]) and not bool(one["ranks"]), c
        assert list(r["leads"]) == [0, 1], c
        assert int(r["nconv"]) == int(one["nconv"]) > 5, c
        np.testing.assert_allclose(r["lam"], one["lam"], rtol=1e-9)
        assert int(r["facts"]) == int(one["facts"]), c
        assert str(r["reason"]) == "CONVERGED_TOL", c
        assert float(r["dlam"]) == 0.0 and float(r["dX"]) == 0.0, c
        assert r["resid"].max() <= 1e-8, c
        if backend is not None:
            assert str(r["backends"]) == backend, c
        k3 = sum(int(r[f"k_panel_{v}_f64"]) for v in ("dots", "update",
                                                      "update_dots"))
        assert k3 > 0 and int(r["k_rotate_f64"]) > 0, c
        assert int(r["s_allgather"]) == 1 and int(r["s_allreduce"]) == 2, c


# ---- the non-Hermitian slice on the card ----------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b", [9, 20, 48])
def test_dia_mult_block_of_any_height_on_the_card(cuda, dtype, tol, b):
    """DIAOperator.mult_block takes any b on the card, as on the CPU: K5
    in ceil(b / 8) launches."""
    assert _build.load().slepc_dia_spmm_max_b() == dia.SPMM_MAX_B
    offsets = (-200, -1, 0, 1, 200)
    n = 10_007
    d = _rand((len(offsets), n), dtype, cuda, 0)
    X = _rand((b, n), dtype, cuda, 1)
    before = dict(dia.launches)
    Y = stt.DIAOperator(offsets, d).mult_block(X)
    ref = dia.dia_spmm_ref(offsets, d, X)
    torch.cuda.synchronize()
    scale = dia.dia_spmm_ref(offsets, d.abs(), X.abs()).max()
    assert float((Y - ref).abs().max() / scale) <= 4 * tol
    key = "dia_spmm_f64" if dtype == torch.float64 else "dia_spmm_f32"
    assert dia.launches[key] == before[key] + -(-b // dia.SPMM_MAX_B)


def _on_both(make, solve):
    """The same solve on the CPU (plain versions) and on the card (kernels);
    returns (cpu eps, card eps, the card's launch deltas)."""
    cpu = solve(make("cpu"))
    before = stt.launch_counts()
    card = solve(make("cuda"))
    after = stt.launch_counts()
    return cpu, card, {k: after[k] - before[k] for k in after}


def _spiral(n):
    rng = np.random.default_rng(5)
    th = np.linspace(0, 4 * np.pi, n)
    r = np.linspace(0.5, 2.0, n)
    d = (r * np.exp(1j * th)).astype(np.complex64)
    d[:8] = (np.linspace(3.0, 2.4, 8)
             * np.exp(1j * np.linspace(0.3, 5.5, 8))).astype(np.complex64)
    off = 0.05 * (rng.standard_normal(n)
                  + 1j * rng.standard_normal(n)).astype(np.complex64)
    lo = np.zeros(n, np.complex64)
    hi = np.zeros(n, np.complex64)
    hi[: n - 1] = off[: n - 1]
    lo[1:] = off[: n - 1] * 0.3
    return np.stack([lo, d, hi]).astype(np.complex128)


def _nhep(nev, ncv=None, tol=1e-9, setup=None, **kw):
    def solve(A):
        eps = stt.EPS(A, problem_type="nhep", nev=nev, ncv=ncv, tol=tol,
                      options=stt.Options(), **kw)
        if setup is not None:
            setup(eps)
        eps.solve()
        return eps
    return solve


def _held(cpu, card, count, resid=1e-8):
    assert card.nconv >= count and card.nconv == cpu.nconv
    np.testing.assert_allclose(card.eigenvalues[:card.nconv],
                               cpu.eigenvalues[:cpu.nconv], atol=1e-9)
    for i in range(card.nconv):
        assert card.compute_error(i) < resid


@pytest.mark.parametrize("case", ["markov", "spiral", "spiral_f32",
                                  "harmonic", "interval", "ellipse",
                                  "arbitrary", "balance"])
def test_nhep_paths_on_the_card(cuda, case):
    """Phase 11's cases at a small size: the card's kernels against the
    plain versions' trajectory on the CPU."""
    f64 = torch.float64
    spiral = lambda dev, dt=f64: stt.from_complex_dia(
        (-1, 0, 1), _spiral(1 << 10), dtype=dt, device=dev)
    if case == "markov":
        cpu, card, d = _on_both(lambda dev: stt.markov(30, device=dev),
                                _nhep(4, max_it=300))
        assert d["csr_spmv_f64"] > 0
        assert abs(np.abs(card.eigenvalues[:4]).max() - 1) < 1e-8
    elif case in ("spiral", "spiral_f32"):
        dt = f64 if case == "spiral" else torch.float32
        cpu, card, d = _on_both(lambda dev: spiral(dev, dt),
                                _nhep(12, 64, 1e-8 if dt == f64 else 1e-4))
        t = "f64" if dt == f64 else "f32"
        assert min(d[f"dia_spmv_{t}"], d[f"panel_dots_{t}"],
                   d[f"rotate_{t}"]) > 0
        if dt == torch.float32:
            assert card.nconv >= 12
            assert max(card.compute_error(i) for i in range(12)) < 1e-3
            return
    elif case == "harmonic":
        def harmonic(eps):
            eps.set_target(3.1)
            eps.set_st(stt.STShift([eps.A]))
            eps.set_which("target_magnitude")
            eps.set_extraction("harmonic")
        cpu, card, d = _on_both(spiral, _nhep(2, 32, setup=harmonic))
        assert d["panel_update_f64"] > 0
    elif case in ("interval", "ellipse"):
        rg = (stt.RGInterval(1.0, np.inf, -np.inf, np.inf) if case ==
              "interval" else stt.RGEllipse(center=2.0, radius=1.5))
        cpu, card, d = _on_both(spiral, _nhep(
            4 if case == "interval" else 2, 32,
            setup=lambda e: e.set_rg(rg)))
        assert np.all(rg.check_inside(card.eigenvalues[:card.nconv]) >= 0)
    elif case == "arbitrary":
        cpu, card, d = _on_both(spiral, _nhep(4, 32, setup=lambda e: (
            e.set_arbitrary_selection(lambda lam, x: -abs(lam.real)))))
    else:
        rng = np.random.default_rng(0)
        n = 200
        D = 10.0 ** rng.uniform(-3, 3, n)
        M0 = rng.standard_normal((n, n)) / np.sqrt(n)
        Ad = (M0 / D[:, None]) * D[None, :]
        cpu, card, d = _on_both(lambda dev: stt.DenseOperator(Ad, device=dev),
                                _nhep(3, 40, 1e-8, max_it=300,
                                      setup=lambda e: e.set_balance()))
        w = np.linalg.eigvals(M0)
        for lam in card.eigenvalues[:3]:
            assert np.min(np.abs(w - lam)) < 1e-7
        _held(cpu, card, 3, resid=1e-6)
        return
    _held(cpu, card, 2)


@pytest.mark.parametrize("form", ["dia", "csr"])
def test_st_filter_on_the_card(cuda, form):
    exact = stt.laplacian_1d_eigs(200)
    inside = exact[(exact > 1.0 + 1e-9) & (exact < 1.2)]

    def make(dev):
        A = stt.laplacian_1d(200, device=dev)
        return A if form == "dia" else stt.from_scipy(A.to_scipy(),
                                                      device=dev)

    def solve(A):
        eps = stt.EPS(A, problem_type="hep", which="largest_real", nev=5,
                      ncv=40, tol=1e-6, options=stt.Options())
        eps.set_st(stt.STFilter([A], interval=(1.0, 1.2), degree=150,
                                spectral_range=(0.0, 4.0)))
        eps.solve()
        return eps

    cpu, card, d = _on_both(make, solve)
    assert d["dia_spmv_f64" if form == "dia" else "csr_spmv_f64"] > 0
    got = np.sort(card.eigenvalues[:card.nconv])
    got = got[got > 1.0 + 1e-9]
    np.testing.assert_allclose(got, inside[: len(got)], atol=1e-8)
    assert len(got) >= 3


@pytest.mark.parametrize("solver", ["power", "subspace", "arnoldi", "lanczos",
                                    "lapack"])
def test_solvers_on_the_card(cuda, solver):
    n = 100
    exact = stt.laplacian_1d_eigs(n)
    kw = dict(which="largest_real", nev=3, ncv=20, max_it=3000)
    if solver == "power":
        kw = dict(nev=1, max_it=2000)
    launched = "dia_spmm_f64" if solver == "subspace" else "dia_spmv_f64"

    def solve(A):
        eps = stt.EPS(A, problem_type="hep", solver=solver,
                      options=stt.Options(), **kw)
        if solver == "power":
            eps.set_target(1.01)
        eps.solve()
        return eps

    cpu, card, d = _on_both(lambda dev: stt.laplacian_1d(n, device=dev),
                            solve)
    assert card.nconv == cpu.nconv >= kw["nev"]
    np.testing.assert_allclose(card.eigenvalues[:card.nconv],
                               cpu.eigenvalues[:cpu.nconv], atol=1e-9)
    if solver != "power":  # power + sinvert solves on the card's LDL^T
        assert d[launched] > 0
    want = (exact[np.argmin(np.abs(exact - 1.01))] if solver == "power"
            else np.sort(exact)[::-1][:3])
    np.testing.assert_allclose(np.sort(card.eigenvalues[:kw["nev"]])[::-1],
                               np.atleast_1d(want), rtol=1e-7)


def test_gnhep_on_the_card(cuda):
    import scipy.linalg as sla
    import scipy.sparse as sp

    n = 300
    rng = np.random.default_rng(4)
    As = (sp.diags(3.0 * 0.9 ** np.arange(n))
          + 0.01 * sp.random(n, n, density=0.01, random_state=rng)).tocsr()
    bd = 1.0 + 0.5 * np.sin(np.arange(n))
    w = sla.eigvals(As.toarray(), np.diag(bd))

    def make(dev):
        return (stt.from_scipy(As, device=dev),
                stt.DIAOperator((0,), torch.from_numpy(bd[None, :]).to(dev)))

    def solve(AB):
        eps = stt.EPS(*AB, problem_type="gnhep", nev=4, tol=1e-10,
                      options=stt.Options())
        eps.solve()
        return eps

    cpu, card, d = _on_both(make, solve)
    assert d["csr_spmv_f64"] > 0
    _held(cpu, card, 4)
    for lam in card.eigenvalues[:4]:
        assert np.min(np.abs(w - lam)) < 1e-9 * abs(lam)


# ---- the complex instantiations K1c / K2c, K3c, K4c, K6c (item 11a-ii) ----

CDTYPES = [(torch.complex64, 2e-6), (torch.complex128, 1e-14)]
SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}


def _crand(shape, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(z).to(dev, dtype)


@pytest.mark.parametrize("dtype,tol", CDTYPES)
@pytest.mark.parametrize("n,offsets", [
    (1, (0,)), (7, (-9, -1, 0, 1, 9)), (1000, (-200, -1, 0, 1, 200)),
    (45_013, (-45_000, -200, -1, 0, 1, 200, 45_000))])
def test_complex_dia_kernel_matches_plain(cuda, dtype, tol, n, offsets):
    d = _crand((len(offsets), n), dtype, cuda, 0)
    x = _crand((n,), dtype, cuda, 1)
    key = f"dia_spmv_{SUFFIX[dtype]}"
    before = dia.launches[key]
    y = dia.dia_spmv(offsets, d, x)
    ref = dia.dia_spmv_ref(offsets, d, x)
    torch.cuda.synchronize()
    scale = dia.dia_spmv_ref(offsets, d.abs(), x.abs()).max()
    assert float((y - ref).abs().max() / scale) <= 4 * tol
    assert dia.launches[key] == before + 1
    # a complex block: one K5c launch, each row K1c / K2c's product
    A = stt.DIAOperator(offsets, d)
    X = _crand((3, n), dtype, cuda, 2)
    spmm_key = f"dia_spmm_{SUFFIX[dtype]}"
    spmm = dia.launches[spmm_key]
    Y = A.mult_block(X)
    assert dia.launches[key] == before + 1
    assert dia.launches[spmm_key] == spmm + 1
    bscale = dia.dia_spmm_ref(offsets, d.abs(), X.abs()).max()
    for m in range(3):
        Ym = dia.dia_spmv(offsets, d, X[m])
        assert float((Y[m] - Ym).abs().max() / bscale) <= 4 * tol


CPANEL_CASES = [(9, 3, 130), (33, 8, 4097), (49, 1, 100_003), (64, 2, 777),
                (1, 1, 1), (17, 4, 4096), (65, 5, 300_004), (129, 1, 4097),
                (129, 8, 37), (5, 2, 100_003),
                # c128 holds 4 / 2 rows a thread at widths 2 / 4: one block's
                # reach is 64 / 32 rows, past it row chunks and two sweeps
                (49, 2, 100_003), (49, 4, 4097), (65, 2, 300_004),
                (65, 4, 777), (32, 4, 100_003)]


@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 1e-5),
                                       (torch.complex128, 1e-13)])
@pytest.mark.parametrize("K,b,n", CPANEL_CASES)
def test_complex_panel_kernels_match_plain(cuda, dtype, tol, K, b, n):
    Vfull = _crand((K + 3, n), dtype, cuda, 2)
    V = Vfull[:K]
    W = _crand((b, n), dtype, cuda, 3)
    C = _crand((K, b), dtype, cuda, 4)
    key = f"panel_dots_{SUFFIX[dtype]}"
    before = bv.launches[key]
    _panel_check(V, W, C, tol)
    assert bv.launches[key] > before
    # the dots conjugate the basis: <v, v> is real and positive
    G = bv.panel_dots(V[:1], V[:1])
    assert abs(float(G.imag)) <= tol * float(G.real)


@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 1e-5),
                                       (torch.complex128, 1e-13)])
@pytest.mark.parametrize("layout", ["offset", "padded_rows"])
def test_complex_panel_kernels_take_views(cuda, dtype, tol, layout):
    K, b, n = 17, 2, 4096
    C = _crand((K, b), dtype, cuda, 4)
    if layout == "offset":  # one element in: c64 rows not 16-byte aligned
        V = _crand((K + 1, n + 1), dtype, cuda, 2)[:K, 1:]
        W = _crand((b, n + 1), dtype, cuda, 3)[:, 1:]
    else:
        V = _crand((K, n + 4), dtype, cuda, 2)[:, :n]
        W = _crand((b, n + 8), dtype, cuda, 3)[:, :n]
    _panel_check(V, W, C, tol)


CROTATE_CASES = [(24, 18, 4101), (48, 40, 100_003), (64, 64, 333),
                 (100, 130, 1000), (1, 1, 1), (49, 9, 130), (129, 7, 4096),
                 (4, 4, 300_004), (48, 1, 37), (49, 33, 10_007),
                 (130, 130, 4097), (48, 40, 2_000_003)]


@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 1e-5),
                                       (torch.complex128, 1e-14)])
@pytest.mark.parametrize("K,P,n", CROTATE_CASES)
def test_complex_rotate_kernel_matches_plain(cuda, dtype, tol, K, P, n):
    full = _crand((K + 1, n), dtype, cuda, 5)
    V = full[:K]
    Q = _crand((K, P), dtype, cuda, 6)
    key = f"rotate_{SUFFIX[dtype]}"
    before = rotate.launches[key]
    out = rotate.rotate(Q, V)
    assert rotate.launches[key] == before + -(-P // rotate.MAX_P)
    ref = rotate.rotate_ref(Q, V)
    err = (out - ref).abs() / (Q.abs().T @ V.abs())
    assert float(err.max()) <= _rotate_tol(dtype.to_real(), tol, K)
    assert torch.equal(rotate.rotate(Q, V), out)
    if P <= K:  # in place into rows of V; the other rows stay
        for r0 in (0, K - P):
            work = full.clone()
            rotate.rotate(Q, work[:K], out=work[r0: r0 + P])
            assert torch.equal(work[r0: r0 + P], out)
            keep = torch.ones(K + 1, dtype=torch.bool, device=cuda)
            keep[r0: r0 + P] = False
            assert torch.equal(work[keep], full[keep])
    # a real Q on the complex basis: the real kernel on its (K, 2n) view
    Qr = _rand((K, P), dtype.to_real(), cuda, 7)
    real_key = "rotate_" + ("f64" if dtype == torch.complex128 else "f32")
    before_real = rotate.launches[real_key]
    got = rotate.rotate(Qr, V)
    assert rotate.launches[real_key] > before_real
    ref = rotate.rotate_ref(Qr.to(dtype), V)
    err = (got - ref).abs() / (Qr.abs().T @ V.abs())
    assert float(err.max()) <= _rotate_tol(dtype.to_real(), 4 * tol, K)


def test_complex_plans_match_the_compiled_kernels(cuda):
    lib = _build.load()
    assert lib.slepc_rotate_max_p() == rotate.MAX_P
    for dtype in (torch.complex64, torch.complex128):
        code = _build.DTYPE_CODE[str(dtype)]
        # every row-tile variant of both kernels (P of 1 .. 64 rows), K odd
        # and even, and Q wider than one launch
        for K, P in [(1, 1), (48, 40), (49, 24), (129, 64), (4, 4), (3, 9),
                     (49, 33), (47, 48), (130, 130), (400, 8)]:
            plan = rotate.plan_rotate(K, P, 100_000, dtype)
            assert plan["max_p"] == lib.slepc_rotate_max_p()
            assert plan["smem"] == lib.slepc_rotate_smem(
                code, K, min(P, plan["max_p"]), plan["stages"])
            blocks = ctypes.c_int(0)
            assert lib.slepc_rotate_occupancy(
                code, int(plan["vec"]), K, min(P, plan["max_p"]),
                plan["stages"], ctypes.byref(blocks)) == 0
            assert blocks.value >= 1
        for b in range(1, 9):
            assert lib.slepc_panel_rows(code, b) == \
                bv.ROWS[dtype][bv._compiled_width(b)]
        for mode in (0, 1, 2):
            for K, b, n in [(1, 1, 10), (49, 1, 4096), (52, 4, 4097),
                            (129, 8, 4097), (49, 2, 4096), (32, 4, 4096)]:
                if mode == 2 and not bv.fused_update_dots(K, b, dtype):
                    continue
                plan = bv.plan_panel(mode, K, b, n, dtype)
                for one in plan["launches"]:
                    assert one["smem"] == lib.slepc_panel_smem(
                        code, mode, b, one["groups"], one["cw"],
                        int(plan["vec"]))


@pytest.mark.parametrize("dtype,tol", CDTYPES)
@pytest.mark.parametrize("kind", ["empty", "tiny", "ragged", "big", "hubs"])
def test_complex_csr_kernel_matches_plain(cuda, dtype, tol, kind):
    if kind == "hubs":  # rows past the budget: chunks summed in order
        rng = np.random.default_rng(3)
        lengths = rng.poisson(5, 20_000)
        lengths[[7, 9000]] = 50_000
        ncols = 20_000
    else:
        lengths, ncols = _lengths(kind)
    rp, cl, _ = _csr(lengths, ncols, 7)
    rowptr = torch.from_numpy(rp).to(cuda)
    cols = torch.from_numpy(cl).to(cuda)
    vals = _crand((len(cl),), dtype, cuda, 9)
    x = _crand((ncols,), dtype, cuda, 8)
    key = f"csr_spmv_{SUFFIX[dtype]}"
    before = csr.launches[key]
    y = csr.csr_spmv(rowptr, cols, vals, x, ncols)
    ref = csr.csr_spmv_ref(rowptr, cols, vals, x)
    torch.cuda.synchronize()
    assert csr.launches[key] == before + 1
    scale = csr.csr_spmv_ref(rowptr, cols, vals.abs(), x.abs()).clamp_min(1)
    assert float(((y - ref).abs() / scale).max()) <= 4 * tol
    for _ in range(2):  # no atomics in the sums: the same bits every time
        assert torch.equal(csr.csr_spmv(rowptr, cols, vals, x, ncols), y)


def _gauge_2d(nx, ny, dev, dtype=torch.complex128):
    L = stt.laplacian_2d(nx, ny, device="cpu")
    n = L.shape[0]
    phi = 2 * np.pi * np.random.default_rng(11).random(n)
    d = L.diags.numpy().astype(np.complex128)
    for k, o in enumerate(L.offsets):
        lo, hi = max(0, -o), min(n, n - o)
        d[k, lo:hi] *= np.exp(1j * (phi[lo:hi] - phi[lo + o:hi + o]))
    return stt.DIAOperator(L.offsets, torch.from_numpy(d).to(dev, dtype))


@pytest.mark.parametrize("case", ["hep_dia", "hep_csr", "hep_c64", "nhep",
                                  "ghep", "shift", "arnoldi", "subspace"])
def test_complex_solves_on_the_card(cuda, case):
    """The complex paths at a small size: the card's complex kernels
    against the plain versions' trajectory on the CPU."""
    c128 = torch.complex128

    def hep(nev=4, **kw):
        def solve(A):
            eps = stt.EPS(A, problem_type="hep", which="smallest_real",
                          nev=nev, options=stt.Options(), **kw)
            eps.solve()
            return eps
        return solve

    if case in ("hep_dia", "hep_c64"):
        dt = c128 if case == "hep_dia" else torch.complex64
        cpu, card, d = _on_both(lambda dev: _gauge_2d(30, 29, dev, dt),
                                hep(tol=1e-8 if dt == c128 else 1e-5))
        t = SUFFIX[dt]
        assert min(d[f"dia_spmv_{t}"], d[f"panel_dots_{t}"],
                   d[f"panel_update_dots_{t}"], d[f"rotate_{t}"]) > 0
        if dt == torch.complex64:
            assert card.nconv >= 4
            np.testing.assert_allclose(card.eigenvalues[:4],
                                       cpu.eigenvalues[:4], rtol=1e-4)
            return
    elif case == "hep_csr":
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        G = _gauge_2d(30, 29, "cpu").to_scipy()
        perm = reverse_cuthill_mckee(sp.csr_matrix(abs(G)), symmetric_mode=True)
        G = G[perm][:, perm].tocsr()
        cpu, card, d = _on_both(lambda dev: stt.from_scipy(G, device=dev),
                                hep())
        assert d["csr_spmv_c128"] > 0 and d["dia_spmv_c128"] == 0
    elif case == "nhep":
        cpu, card, d = _on_both(lambda dev: stt.DIAOperator(
            (-1, 0, 1), torch.from_numpy(_spiral(1 << 10)).to(dev)),
            _nhep(6, 32, 1e-8))
        assert min(d["dia_spmv_c128"], d["rotate_c128"]) > 0
    elif case == "ghep":
        def make(dev):
            G = _gauge_2d(30, 29, dev)
            b = 1.0 + 0.5 * torch.sin(0.1 * torch.arange(G.shape[0]))
            return G, stt.DIAOperator((0,), b[None].double().to(dev))

        def solve(ops):
            eps = stt.EPS(*ops, problem_type="ghep", which="largest_real",
                          nev=3, options=stt.Options())
            eps.solve()
            return eps
        cpu, card, d = _on_both(make, solve)
        # the real B applies to complex vectors by parts, on K2
        assert d["dia_spmv_c128"] > 0 and d["dia_spmv_f64"] > 0
    elif case == "shift":
        def solve(A):
            eps = stt.EPS(A, problem_type="hep", nev=4, options=stt.Options())
            eps.set_target(0.5 + 0.1j)
            eps.solve()
            return eps
        cpu, card, d = _on_both(lambda dev: stt.laplacian_2d(30, 29,
                                                             device=dev),
                                solve)
        assert d["panel_dots_c128"] > 0 and d["rotate_c128"] > 0
        _held(cpu, card, 4, resid=1e-7)
        return
    else:
        def solve(A):
            eps = stt.EPS(A, problem_type="nhep", nev=3, ncv=16, max_it=3000,
                          solver=case, options=stt.Options())
            eps.solve()
            return eps
        cpu, card, d = _on_both(lambda dev: stt.DIAOperator(
            (-1, 0, 1), torch.from_numpy(_spiral(1 << 10)).to(dev)), solve)
        # subspace applies the operator to its whole block: K5c
        spmv = "dia_spmm_c128" if case == "subspace" else "dia_spmv_c128"
        assert d[spmv] > 0 and d["rotate_c128"] > 0
    _held(cpu, card, 3 if case in ("ghep", "arnoldi", "subspace") else 4)


@pytest.mark.parametrize("what", ["block_size", "cheb_block", "sinvert"])
def test_complex_paths_of_11a_iii_raise_on_the_card(cuda, what):
    """The three complex paths that raised before they were ported (the
    name is kept for its ids): the blocked cycle on K5c, K3c and K4c
    against the closed form and the CPU's trajectory; cheb_block runs the
    plain cycle (no K5c launch); the device shift-and-invert still raises,
    with no launch."""
    def solve(dev):
        G = _gauge_2d(12, 11, dev)
        eps = stt.EPS(G, problem_type="hep", which="smallest_real", nev=2,
                      options=stt.Options())
        if what == "block_size":
            eps.block_size = 2
        elif what == "cheb_block":
            eps.cheb_degree, eps.cheb_block = 20, 2
        else:
            eps.set_target(0.0)
            eps.set_st(stt.STSinvertDevice([G], sigma=0.0, iters=50))
        eps.solve()
        return eps

    if what == "sinvert":
        before = stt.launch_counts()
        with pytest.raises(NotImplementedError,
                           match="reference has no complex device"):
            solve(cuda)
        assert stt.launch_counts() == before
        return
    cpu, card, d = _on_both(lambda dev: dev, solve)
    _held(cpu, card, 2)
    exact = stt.laplacian_2d_eigs(12, 11, k=2)
    np.testing.assert_allclose(np.sort(card.eigenvalues[:2]), exact,
                               rtol=0, atol=1e-10)
    assert d["panel_dots_c128"] > 0 and d["rotate_c128"] > 0
    if what == "block_size":
        assert d["dia_spmm_c128"] > 0 and d["dia_spmv_c128"] == 0
    else:
        assert d["dia_spmm_c128"] == 0 and d["dia_spmv_c128"] > 0


@pytest.mark.parametrize("dtype,tol", CDTYPES)
@pytest.mark.parametrize("b", [1, 3, 4, 8])
@pytest.mark.parametrize("layout", ["aligned", "odd_stride", "odd_n"])
def test_complex_block_kernel_matches_plain(cuda, dtype, tol, b, layout):
    """K5c: near and far offsets, offsets past +-n, X a row slice of a
    taller basis (an odd row stride: one-element copies in c64), a ragged
    last tile; its plan's shared memory against the compiled kernel's;
    bitwise repeatable."""
    n = 20_001 if layout == "odd_n" else 20_000
    offsets = (-30_000, -3000, -700, -5, -1, 0, 1, 5, 700, 3000, 30_000)
    plan = dia.plan_spmm(offsets, n, b, dtype)
    d = _crand((len(offsets), n), dtype, cuda, 2)
    width = n + {"aligned": 8, "odd_stride": 3, "odd_n": 5}[layout]
    X = _crand((b + 3, width), dtype, cuda, 3)[2:2 + b, :n]
    assert lib_smem(dtype, b, plan) == plan.smem
    key = f"dia_spmm_{SUFFIX[dtype]}"
    before = dia.launches[key]
    Y = dia.dia_spmm(offsets, d, X)
    assert dia.launches[key] == before + 1
    ref = dia.dia_spmm_ref(offsets, d, X)
    torch.cuda.synchronize()
    scale = dia.dia_spmm_ref(offsets, d.abs(), X.abs()).max()
    assert float((Y - ref).abs().max() / scale) <= 4 * tol
    for _ in range(2):
        assert torch.equal(dia.dia_spmm(offsets, d, X), Y)


@pytest.mark.parametrize("solver", ["trlanczos", "cross"])
def test_svd_on_the_card(cuda, solver):
    """The SVD of a 3-D gradient (30 x 32 x 34 unknowns, G^T G the 7-point
    Laplacian) on K6 for G and G^H, K3 and K4, against the closed form and
    the CPU's run."""
    import scipy.sparse as sp

    nx, ny, nz = 30, 32, 34

    def D(k):
        return sp.diags([np.ones(k), -np.ones(k)], [0, -1], shape=(k + 1, k))

    def eye(k):
        return sp.identity(k, format="csr")

    G = sp.vstack([sp.kron(eye(nz), sp.kron(eye(ny), D(nx))),
                   sp.kron(eye(nz), sp.kron(D(ny), eye(nx))),
                   sp.kron(D(nz), sp.kron(eye(ny), eye(nx)))]).tocsr()

    def solve(dev):
        svd = stt.SVD(stt.from_scipy(G, device=dev), nsv=4, ncv=20,
                      tol=1e-9, solver=solver)
        svd.solve()
        return svd

    cpu, card, d = _on_both(lambda dev: dev, solve)
    exact = np.sqrt(stt.laplacian_3d_eigs(nx, ny, nz))[::-1][:4]
    assert card.nconv >= 4 and card.nconv == cpu.nconv
    np.testing.assert_allclose(card.sigma[:4], exact, rtol=1e-9)
    np.testing.assert_allclose(card.sigma[:4], cpu.sigma[:4], rtol=1e-10)
    for i in range(4):
        assert card.compute_error(i) < 1e-8
    assert d["csr_spmv_f64"] > 0 and d["panel_dots_f64"] > 0
    assert d["rotate_f64"] > 0


# ---- the preconditioned and contour-integral solvers (items 11b, 11c) ----

def _gd_case(dev, n=4096):
    """tests/test_round3.py's variable diagonal as a DIA operator."""
    d = np.linspace(1.0, 50.0, n)
    lo = np.r_[0.0, -np.ones(n - 1)]
    hi = np.r_[-np.ones(n - 1), 0.0]
    return stt.DIAOperator((-1, 0, 1), np.stack([lo, d, hi]), device=dev)


@pytest.mark.parametrize("solver,keys", [
    ("gd", ("dia_spmv_f64", "panel_dots_f64", "panel_update_f64",
            "panel_update_dots_f64", "rotate_f64")),
    ("gd_host", ("dia_spmm_f64", "panel_dots_f64", "rotate_f64")),
    ("jd", ("dia_spmv_f64", "dia_spmm_f64", "panel_dots_f64")),
    ("lobpcg", ("dia_spmm_f64",)),
    ("lobpcg_precond", ("dia_spmm_f64",)),
    ("rqcg", ("dia_spmv_f64", "dia_spmm_f64"))])
def test_preconditioned_solvers_on_the_card(cuda, solver, keys):
    """Each solver at its CPU tests' size on a DIA operator: the same values
    as on the CPU, and its kernels launched (the GD cycle: K2, K3, K4; the
    block paths: K5)."""
    name = solver.split("_")[0]

    tol = 1e-6 if name == "rqcg" else 1e-8

    def solve(A):
        eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=3,
                      ncv=20, tol=tol, max_it=6000, solver=name,
                      options=stt.Options())
        if solver in ("gd", "gd_host", "jd", "lobpcg_precond"):
            eps.set_st(stt.STPrecond([A]))
        if solver == "gd_host":
            eps.gd_fused = False
        if solver == "jd":
            eps.set_target(0.0)
        eps.solve()
        return eps

    cpu, card, d = _on_both(_gd_case, solve)
    assert card.nconv == cpu.nconv >= 3
    np.testing.assert_allclose(np.sort(card.eigenvalues[:3]),
                               np.sort(cpu.eigenvalues[:3]), rtol=0,
                               atol=1e-9)
    for key in keys:
        assert d[key] > 0, (key, d)
    assert max(card.compute_error(i) for i in range(3)) < 10 * tol


def test_gd_cycle_on_csr_on_the_card(cuda):
    """The GD cycle on a CSR matrix that is not DIA-shaped: K6."""
    import scipy.sparse as sp

    M = (stt.laplacian_2d(24, 23, device="cpu").to_scipy()
         + sp.random(552, 552, density=0.02, random_state=3)).tocsr()
    M = (0.5 * (M + M.T)).tocsr()

    def solve(A):
        eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=3,
                      tol=1e-8, max_it=3000, solver="gd",
                      options=stt.Options())
        eps.solve()
        return eps

    cpu, card, d = _on_both(lambda dev: stt.from_scipy(M, device=dev), solve)
    assert card.nconv == cpu.nconv >= 3
    np.testing.assert_allclose(card.eigenvalues[:3], cpu.eigenvalues[:3],
                               rtol=0, atol=1e-9)
    assert d["csr_spmv_f64"] > 0 and d["rotate_f64"] > 0


def test_ciss_batched_on_the_card(cuda):
    """CISS with ``auto`` on a CUDA DIA operator: the batched solves (the
    real operator on the complex blocks by parts: K5)."""
    n = 200
    exact = stt.laplacian_1d_eigs(n)
    want = exact[(exact > 0.5) & (exact < 0.8)]
    A = stt.laplacian_1d(n, device=cuda)
    eps = stt.EPS(A, problem_type="hep", solver="ciss", tol=1e-8,
                  options=stt.Options())
    eps.set_rg(stt.RGEllipse(center=0.65, radius=0.15, vscale=0.4))
    before = stt.launch_counts()
    eps.solve()
    after = stt.launch_counts()
    assert eps.ciss_inner_iters > 0  # auto picked the batched solves
    assert after["dia_spmm_f64"] > before["dia_spmm_f64"]
    assert eps.nconv == len(want)
    np.testing.assert_allclose(np.sort(eps.eigenvalues.real), want,
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("dtype,key,tol", [
    (torch.float32, "dia_spmv_f32", 2e-6), (torch.float64, "dia_spmv_f64", 1e-14),
    (torch.complex64, "dia_spmv_c64", 2e-6),
    (torch.complex128, "dia_spmv_c128", 1e-14)])
def test_dia_mult_h_runs_on_the_dia_kernel(cuda, dtype, key, tol):
    """A^H x on the card: the adjoint's diagonals are built once, on the
    card, and each mult_h is one K1/K2/K1c/K2c launch (no slice update per
    diagonal), against A^H x from the CPU operator."""
    n, offsets = 45_013, (-200, -1, 0, 3, 45_000)
    rng = np.random.default_rng(5)
    d = rng.standard_normal((len(offsets), n))
    x = rng.standard_normal(n)
    if dtype.is_complex:
        d = d + 1j * rng.standard_normal(d.shape)
        x = x + 1j * rng.standard_normal(n)
    ref = stt.DIAOperator(offsets, d, device="cpu").mult_h(torch.from_numpy(x))
    A = stt.DIAOperator(offsets, torch.from_numpy(d).to(cuda, dtype))
    xt = torch.from_numpy(x).to(cuda, dtype)
    for call in range(2):
        before = stt.launch_counts()
        y = A.mult_h(xt)
        after = stt.launch_counts()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {key: 1}
    assert A.adjoint().diags.device == xt.device
    err = (y.cpu().to(ref.dtype) - ref).abs().max() / ref.abs().max()
    assert float(err) <= 10 * tol


@pytest.mark.parametrize("case", ["two_sided_dia", "ghiep", "ghiep_pairs",
                                  "bse_projected", "bse_complex"])
def test_structured_variants_on_the_card(cuda, case):
    """The paths of item 11d on CUDA operators, each on its kernels, held
    against the same solve on the CPU."""
    def run(dev):
        if case == "two_sided_dia":
            rng = np.random.default_rng(7)
            n = 3000
            lo = 0.3 * rng.standard_normal(n)
            hi = 0.3 * rng.standard_normal(n)
            lo[0] = hi[-1] = 0.0
            A = stt.DIAOperator((-1, 0, 1), np.stack(
                [lo, np.linspace(0.0, 3.0, n), hi]), device=dev)
            eps = stt.EPS(A, problem_type="nhep", nev=4, ncv=24,
                          which="largest_real", options=stt.Options())
            eps.set_two_sided()
        elif case == "ghiep":
            n = 400
            A = stt.laplacian_1d(n, device=dev)
            om = np.where(np.arange(n) % 3 == 0, -1.0, 1.0)
            B = stt.DIAOperator((0,), om[None], device=dev)
            eps = stt.EPS(A, B, problem_type="ghiep", nev=3, ncv=16,
                          options=stt.Options())
            eps.set_target(0.3)
        elif case == "ghiep_pairs":
            # a projection with complex pairs: the loop re-solves as GNHEP
            rng = np.random.default_rng(3)
            n = 600
            lo = 0.2 * rng.standard_normal(n)
            lo[0] = 0.0
            A = stt.DIAOperator((-1, 0, 1), np.stack(
                [lo, np.linspace(-2.0, 2.0, n), np.roll(lo, -1)]), device=dev)
            om = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
            B = stt.DIAOperator((0,), om[None], device=dev)
            eps = stt.EPS(A, B, problem_type="ghiep", nev=3, ncv=16,
                          which="largest_real", options=stt.Options())
        else:
            rng = np.random.default_rng(3)
            n = 64
            cx = case == "bse_complex"
            R = rng.standard_normal((n, n)) + (1j * rng.standard_normal(
                (n, n)) if cx else 0)
            R = 0.5 * (R + R.conj().T) + 2 * n * np.eye(n)
            C = rng.standard_normal((n, n)) + (1j * rng.standard_normal(
                (n, n)) if cx else 0)
            C = 0.5 * (C + C.T)
            H = stt.create_bse(stt.DenseOperator(R, device=dev),
                               stt.DenseOperator(C, device=dev))
            eps = stt.EPS(H, problem_type="bse", nev=4, tol=1e-9,
                          options=stt.Options())
            eps.bse_variant = "projected" if case == "bse_projected" \
                else "auto"
        before = stt.launch_counts()
        eps.solve()
        after = stt.launch_counts()
        return eps, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    te, counts = run(cuda)
    ce, _ = run("cpu")
    assert te.nconv >= 3 and te.nconv == ce.nconv
    lam, lam_c = (np.sort_complex(np.asarray(e.eigenvalues[:3], complex))
                  for e in (te, ce))
    np.testing.assert_allclose(lam, lam_c, rtol=1e-9, atol=0)
    if case == "two_sided_dia":
        # the real operator on the complex bases by parts: K2
        assert counts["dia_spmv_f64"] > 0 and counts["rotate_c128"] > 0
        assert counts["panel_dots_c128"] > 0
        lam0 = complex(te.eigenvalues[0])
        y = te.get_left_eigenvector(0)
        yh = te.A.mult_h(y) - lam0.conjugate() * y
        assert float(torch.linalg.vector_norm(yh)) < 1e-7 * float(
            torch.linalg.vector_norm(y)) * abs(lam0)
    elif case in ("ghiep", "ghiep_pairs"):
        assert counts["dia_spmv_f64"] > 0  # B, the metric
        assert counts["rotate_f64"] > 0 and counts["panel_dots_f64"] > 0
        assert te.gnhep_resolve is ce.gnhep_resolve is (case == "ghiep_pairs")
    elif case == "bse_projected":
        assert counts["panel_dots_c128"] > 0 and counts["rotate_f64"] > 0
    else:
        assert counts["panel_dots_c128"] > 0


# ---- matrix functions, matrix equations, polynomial problems (items 13, 14)

def _launched(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def shifted_dia(L, s, scale=1.0):
    """scale * (L + s I) for a DIA operator L with a main diagonal."""
    d = L.diags.clone()
    d[L.offsets.index(0)] += s
    return stt.DIAOperator(L.offsets, scale * d)


def lyapii_band(n, dev):
    """A stable nonsymmetric tridiagonal DIA matrix with an isolated
    rightmost eigenvalue near -0.4 (lyapii's use case)."""
    main = -np.concatenate([[0.4], 2.0 + np.linspace(0.0, 3.0, n - 1)])
    up, lo = np.full(n, 0.1), np.full(n, 0.05)
    up[-1], lo[0] = 0.0, 0.0
    return stt.DIAOperator((-1, 0, 1), np.stack([lo, main, up]), device=dev)


@pytest.mark.parametrize("case", ["mfn_krylov", "mfn_expokit", "mfn_c128",
                                  "mfn_f32", "lme_lyapunov",
                                  "lme_sylvester", "lyapii"])
def test_matrix_functions_and_equations_on_the_card(cuda, case):
    """MFN (SpMV + K3 Arnoldi, K4 update), LME (the same Arnoldi, K4 for
    Z^T = L^T V, K5 for the residual's A Z) and lyapii (K5 for A V) on the
    card, each against the same solve on the CPU."""
    def run(dev):
        if case.startswith("mfn"):
            dt = {"mfn_c128": torch.complex128,
                  "mfn_f32": torch.float32}.get(case, torch.float64)
            L = stt.laplacian_2d(30, 31, dtype=dt, device=dev)
            f = stt.FNExp()
            f.set_scale(-0.5)
            m = stt.MFN(L, f, ncv=10 if case == "mfn_krylov" else 30,
                        solver="expokit" if case == "mfn_expokit"
                        else "krylov", tol=1e-5 if dt == torch.float32
                        else 1e-10)
            b = np.cos(np.arange(L.shape[0]) * 0.1)
            before = stt.launch_counts()
            y = m.solve(b)
            return y.cpu().numpy(), m.its, _launched(before,
                                                     stt.launch_counts())
        if case == "lyapii":
            A = lyapii_band(50, dev)
            eps = stt.EPS(A, problem_type="nhep", solver="lyapii", nev=1,
                          tol=1e-8, max_it=80, options=stt.Options())
            before = stt.launch_counts()
            eps.solve()
            return np.array(eps.eigenvalues[:1]), eps.its, _launched(
                before, stt.launch_counts())
        L = stt.laplacian_2d(20, 21, device=dev)
        rng = np.random.default_rng(0)
        C = rng.standard_normal((L.shape[0], 2))
        before = stt.launch_counts()
        if case == "lme_lyapunov":  # A = -(L + 0.1 I)
            lme = stt.LME(shifted_dia(L, 0.1, -1.0), ncv=30, tol=1e-9)
            Z = lme.solve(C)
            res = lme.compute_residual(Z, C)
            X = (Z @ Z.T).cpu().numpy()
        else:
            B = shifted_dia(stt.laplacian_1d(700, device=dev), 1.5)
            lme = stt.LME(shifted_dia(stt.laplacian_1d(800, device=dev),
                                      2.0), B=B, problem_type="sylvester",
                          ncv=20, tol=1e-10)
            L, R = lme.solve(rng.standard_normal(800),
                             rng.standard_normal(700))
            X, res = (L @ R.T).cpu().numpy(), lme.errest
        return (X, res), lme.its, _launched(before, stt.launch_counts())

    out, its, counts = run(cuda)
    ref, its_c, _ = run("cpu")
    assert its == its_c
    if case.startswith("lme"):
        (X, res), (Xc, _) = out, ref
        assert res < 1e-8
        assert np.linalg.norm(X - Xc) <= 1e-10 * np.linalg.norm(Xc)
        assert counts["panel_dots_f64"] > 0 and counts["rotate_f64"] > 0
        assert counts["dia_spmv_f64"] > 0
        if case == "lme_lyapunov":
            assert counts["dia_spmm_f64"] > 0
        return
    rel = {"mfn_f32": 1e-4}.get(case, 1e-10)
    assert np.linalg.norm(out - ref) <= rel * np.linalg.norm(ref)
    tag = {"mfn_c128": "c128", "mfn_f32": "f32"}.get(case, "f64")
    if case == "lyapii":
        assert counts["dia_spmm_f64"] > 0
    else:
        assert counts[f"dia_spmv_{tag}"] > 0
        assert counts[f"panel_dots_{tag}"] > 0
        assert counts[f"rotate_{tag}"] > 0


@pytest.mark.parametrize("solver", ["toar", "qarnoldi", "linear", "stoar",
                                    "toar_c128", "jd", "qslice"])
def test_pep_on_the_card(cuda, solver):
    """PEP on DIA coefficients on the card: TOAR (K2 SpMVs, K3 first-level
    CGS2, K4 combinations / compression / extraction), Q-Arnoldi (K3 on a
    two-row panel, K4 restart), linear and STOAR through EPS, a complex
    target (K2c / K3c / K4c), JD and the interval, each against the same
    solve on the CPU."""
    def run(dev):
        n = 60 if solver == "jd" else 400
        K = stt.laplacian_1d(n, device=dev)
        C = stt.DIAOperator((0,), np.full((1, n), 2.2 if solver in (
            "stoar", "qslice") else 0.3), device=dev)
        M = stt.DIAOperator((0,), np.ones((1, n)), device=dev)
        name = "toar" if solver == "toar_c128" else \
            "stoar" if solver == "qslice" else solver
        pep = stt.PEP([K, C, M], nev=2 if solver == "jd" else 3,
                      solver=name, tol=1e-10)
        if solver == "qslice":
            pep.set_interval(-0.02, -0.005)
        elif solver == "toar_c128":
            pep.set_target(-0.15 + 0.5j)
        else:
            pep.set_target(-0.15)
        before = stt.launch_counts()
        pep.solve()
        return pep, _launched(before, stt.launch_counts())

    pep, counts = run(cuda)
    pc, _ = run("cpu")
    assert pep.nconv == pc.nconv >= {"qslice": 1, "jd": 2}.get(solver, 3)
    k = pep.nconv
    if solver == "jd":  # conjugate pairs tie on the target distance, and
        # which one the Davidson loop follows turns on rounding
        for i in range(k):
            assert pep.compute_error(i) < 1e-8
        assert counts["dia_spmv_f64"] > 0
        return
    got = np.sort_complex(np.round(np.asarray(pep.eigenvalues[:k],
                                              complex), 12))
    want = np.sort_complex(np.round(np.asarray(pc.eigenvalues[:k],
                                               complex), 12))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    for i in range(k):
        assert pep.compute_error(i) < 1e-8
    tag = "c128" if solver == "toar_c128" else "f64"
    assert counts["dia_spmv_f64"] > 0
    if solver in ("toar", "toar_c128", "qarnoldi", "qslice"):
        assert counts[f"rotate_{tag}"] > 0
        assert counts[f"panel_dots_{tag}"] > 0


def _delay_split(n, dev):
    """examples/ex_nep_delay.py's delay problem as DIA operators on dev."""
    h = np.pi / (n + 1)
    up = np.zeros(n)
    up[: n - 1] = 1.0 / (h * h)
    lo = np.zeros(n)
    lo[1:] = 1.0 / (h * h)
    xi = np.arange(1, n + 1) * h
    mats = [stt.DIAOperator((0,), -np.ones((1, n)), device=dev),
            stt.DIAOperator((-1, 0, 1),
                            np.stack([lo, np.full(n, -2.0 / (h * h)), up]),
                            device=dev),
            stt.DIAOperator((0,), (4.1 - xi * (1 - np.exp(xi - np.pi)))[None],
                            device=dev)]
    fns = [stt.FNRational([1.0, 0.0]), stt.FNRational([1.0]), stt.FNExp()]
    fns[2].set_scale(-1.0)
    return mats, fns


@pytest.mark.parametrize("solver", ["nleigs", "nleigs_full", "ciss", "rii",
                                    "pep_ciss"])
def test_nep_on_the_card(cuda, solver):
    """NEP on DIA split operators on the card against the same solve on the
    CPU (values within 1e-10): the compact NLEIGS (K2 by parts on the real
    diagonals, K3c CGS2 on the first-level basis, K4c combinations,
    compression and extraction), the full-basis NLEIGS (EPS on the d*n
    shell), CISS (host quadrature, polish on the card) and RII; then PEP's
    ciss, which runs NEP's."""
    def run(dev):
        if solver == "pep_ciss":
            K = stt.laplacian_1d(200, device=dev)
            C = stt.DIAOperator((0,), np.full((1, 200), 0.4), device=dev)
            M = stt.DIAOperator((0,), np.ones((1, 200)), device=dev)
            nep = stt.PEP([K, C, M], nev=2, solver="ciss", tol=1e-10)
            nep.set_target(-0.2)
            nep.set_rg(stt.RGEllipse(center=-0.2, radius=0.1))
        else:
            mats, fns = _delay_split(128, dev)
            name = "nleigs" if solver == "nleigs_full" else solver
            nep = stt.NEP(nev=3 if name != "rii" else 1, solver=name,
                          target=-1.0 if name != "rii" else 0.1, tol=1e-9)
            nep.set_split_operators(mats, fns)
            nep.set_rg(stt.RGEllipse(center=-1.0, radius=1.5, vscale=0.5))
            nep.nleigs_full_basis = solver == "nleigs_full"
        before = stt.launch_counts()
        nep.solve()
        return nep, _launched(before, stt.launch_counts())

    nep, counts = run(cuda)
    ncpu, _ = run("cpu")
    assert nep.nconv == ncpu.nconv >= (1 if solver == "rii" else 2)
    k = nep.nconv
    assert nep.get_eigenvectors().device.type == "cuda"
    got = np.sort_complex(np.round(np.asarray(nep.eigenvalues[:k],
                                              complex), 12))
    want = np.sort_complex(np.round(np.asarray(ncpu.eigenvalues[:k],
                                               complex), 12))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    for i in range(k):
        assert nep.compute_error(i) < 1e-7
    assert counts.get("dia_spmv_f64", 0) > 0
    if solver in ("nleigs", "nleigs_full"):
        for key in ("panel_dots_c128", "panel_update_c128", "rotate_c128"):
            assert counts.get(key, 0) > 0, (key, counts)
    if solver == "nleigs":
        assert counts.get("panel_update_dots_c128", 0) > 0, counts


@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_row_partition_on_the_card(cuda, tmp_path, backend, world):
    """The row partition on the card (tests/_torch_ranks.py's cases): two
    gloo ranks sharing the card (their halo rows staged through host
    memory) and one NCCL rank, against the one-rank port on the CPU; the
    kernels launched in the ranks (K2, K2c, K5, K3, K4, K6)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_ranks as ranks

    cases = ("halo_spmv", "halo_spmm", "tsqr", "ks_cycle", "eps_f64",
             "eps_c128", "cheb", "blocked", "csr_rcm")
    got = ranks.spawn(tmp_path, world, cases, timeout=300, backend=backend,
                      device="cuda")
    one = {c: ranks.run_case(c, None) for c in cases}
    np.testing.assert_allclose(got["halo_spmv"]["y"], one["halo_spmv"]["y"],
                               atol=1e-12)
    np.testing.assert_allclose(got["halo_spmm"]["Y"], one["halo_spmm"]["Y"],
                               atol=1e-12)
    Q, R = got["tsqr"]["Q"], got["tsqr"]["R"]
    np.testing.assert_allclose(Q @ Q.T, np.eye(12), atol=1e-12)
    np.testing.assert_allclose(np.abs(R), np.abs(one["tsqr"]["R"]),
                               atol=1e-12)
    np.testing.assert_allclose(got["ks_cycle"]["theta"],
                               one["ks_cycle"]["theta"], rtol=1e-9)
    for c in ("eps_f64", "eps_c128", "cheb", "blocked", "csr_rcm"):
        assert int(got[c]["nconv"]) == int(one[c]["nconv"]), c
        np.testing.assert_allclose(got[c]["lam"], one[c]["lam"], rtol=1e-9)
        assert got[c]["resid"].max() <= 1e-8, c
        assert got[c]["n_allgather"] == 0 and got[c]["n_halo"] > 0, c
    assert got["ks_cycle"]["first_allreduce"] <= 3 * 24
    for c, key in (("halo_spmv", "dia_spmv_f64"), ("halo_spmm", "dia_spmm_f64"),
                   ("ks_cycle", "panel_update_dots_f64"),
                   ("ks_cycle", "rotate_f64"), ("tsqr", "rotate_f64"),
                   ("blocked", "dia_spmm_f64"), ("csr_rcm", "csr_spmv_f64"),
                   ("eps_c128", "dia_spmv_c128")):
        assert got[c]["k_" + key] > 0, (c, key)
    if backend == "gloo":
        assert got["eps_f64"]["n_halo_stage_s"] > 0


def test_numpy_operands_run_the_kernels_on_the_card(cuda):
    """The array rule on the card: a numpy vector or block given to a card
    operator goes to the card and runs its kernel (K2, K2c, K5, K6 and the
    tridiag_device solve), the answer a CUDA tensor equal to the CPU
    tensors' call; a CUDA tensor the kernel does not take still raises."""
    from slepc_tpu_torch.ksp.direct import DirectSolver

    rng = np.random.default_rng(4)
    n = 3001
    d = rng.standard_normal((3, n))
    dc = d + 1j * rng.standard_normal((3, n))
    x, X = rng.standard_normal(n), rng.standard_normal((4, n))
    csr = stt.laplacian_2d(30, 31, device="cpu").to_scipy() \
        + 0.1 * np.eye(930)[::-1]
    calls = [
        ("dia_spmv_f64", lambda dev: stt.DIAOperator((-1, 0, 1), d,
                                                      device=dev).mult, x),
        ("dia_spmv_f64", lambda dev: stt.DIAOperator((-1, 0, 1), d,
                                                      device=dev).mult_h, x),
        ("dia_spmm_f64", lambda dev: stt.DIAOperator(
            (-1, 0, 1), d, device=dev).mult_block, X),
        ("dia_spmv_c128", lambda dev: stt.DIAOperator(
            (-1, 0, 1), dc, device=dev).mult, x + 1j * x[::-1]),
        ("csr_spmv_f64", lambda dev: stt.from_scipy(csr, device=dev).mult,
         x[:930]),
    ]
    for key, make, v in calls:
        before = stt.launch_counts()[key]
        y = make(cuda)(v)
        assert y.is_cuda and stt.launch_counts()[key] > before, key
        ref = make("cpu")(torch.from_numpy(v))
        assert float((y.cpu() - ref).abs().max()) <= 1e-12 * float(
            ref.abs().max()), key
    t = np.stack([np.r_[0.0, -np.ones(n - 1)], np.full(n, 4.0),
                  np.r_[-np.ones(n - 1), 0.0]])
    ds = DirectSolver(stt.DIAOperator((-1, 0, 1), t, device=cuda))
    assert ds.backend == "tridiag_device"
    y = ds.solve(x)
    assert y.is_cuda
    ref = DirectSolver(stt.DIAOperator((-1, 0, 1), t, device="cpu")).solve(
        torch.from_numpy(x))
    assert float((y.cpu() - ref).abs().max()) <= 1e-12 * float(
        ref.abs().max())
    with pytest.raises(ValueError):  # no fallback for a CUDA tensor
        stt.DIAOperator((-1, 0, 1), d, device=cuda).mult(
            torch.from_numpy(x).to(cuda, torch.float32))
