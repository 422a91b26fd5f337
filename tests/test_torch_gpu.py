"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and the CUDA toolkit, so they skip on a CPU-only
host.  Run them on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest`` because tests/conftest.py sets up JAX, which the port's
machine need not have).  Shapes are small and odd on purpose: ragged tiles,
strided basis prefixes, offsets at and past the vector ends, empty CSR rows
and rows far longer than the lanes the CSR kernel gives a row.
"""

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
    assert float(((D2 - V @ U_ref.T).abs() / d2scale).max()) <= 10 * tol
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
    for b in range(1, 9):
        assert lib.slepc_panel_rows(b) == bv.ROWS[bv._compiled_width(b)]
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
    code = 1 if dtype == torch.float64 else 0
    return 0 if dia.NEAR not in plan.where else \
        _build.load().slepc_dia_spmm_smem(code, b, plan.tile, plan.halo)


def test_dia_block_kernel_rejects_what_it_does_not_take(cuda):
    offsets = (-1, 0, 1)
    d = torch.ones((3, 50), dtype=torch.float64, device=cuda)
    X = torch.ones((9, 50), dtype=torch.float64, device=cuda)
    before = dict(dia.launches)
    with pytest.raises(ValueError, match="block of 9"):
        dia.dia_spmm(offsets, d, X)
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
