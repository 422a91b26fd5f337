"""Port restart rotation (slepc_tpu_torch/ops/rotate.py) against the
double-single Pallas rotation of slepc_tpu/ops/rotate_pallas.py (interpret
mode), at the shapes of tests/test_round5.py (TestDSRotateKernel).

The port computes in native f64 and the reference in double-single
(~1e-15), so both agree with each other to 5e-14 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slepc_tpu.ops.rotate_pallas import rotate_basis_ds
from slepc_tpu_torch.ops import rotate


@pytest.mark.parametrize("K,P,R,W,orth,rb", [
    (24, 18, 16, 256, True, 8),    # orthonormal Q
    (6, 4, 12, 128, False, 16),    # R not divisible by the default Rb
    (8, 6, 72, 128, False, 8),     # uneven tail
])
def test_rotation_matches_double_single_kernel(K, P, R, W, orth, rb):
    rng = np.random.default_rng(7)
    V = rng.standard_normal((K, R, W))
    if orth:
        Qm, _ = np.linalg.qr(rng.standard_normal((K, K)))
        Q = Qm[:, :P]
    else:
        Q = rng.standard_normal((K, P)) / K
    ref = np.asarray(rotate_basis_ds(jnp.asarray(Q), jnp.asarray(V),
                                     block_rows=rb, interpret=True))
    out = rotate.rotate(torch.from_numpy(np.ascontiguousarray(Q)),
                        torch.from_numpy(V.reshape(K, -1))).numpy()
    err = np.abs(out.reshape(ref.shape) - ref).max() / np.abs(ref).max()
    assert err < 5e-14, err


def test_rotation_of_a_basis_prefix():
    """The cycle rotates V[:ncv] of an (ncv+1, n) basis in place of a copy."""
    rng = np.random.default_rng(8)
    V = torch.from_numpy(rng.standard_normal((11, 300)))
    Q = torch.from_numpy(rng.standard_normal((10, 7)))
    out = rotate.rotate(Q, V[:10])
    assert out.shape == (7, 300)
    assert torch.allclose(out, Q.T @ V[:10].clone(), rtol=0, atol=1e-13)


# ---- rotate(..., out=) and the launch planning (no card needed) -----------

@pytest.mark.parametrize("K,P,R,W", [(24, 18, 16, 256), (8, 6, 72, 128)])
@pytest.mark.parametrize("where", ["new", "buffer", "in_place", "in_place_tail"])
def test_rotation_into_out_matches_double_single_kernel(K, P, R, W, where):
    """out= (a separate buffer, V[:P] itself, or the last P rows of V) gives
    rotate_ref's result, and still the double-single kernel's to 5e-14."""
    rng = np.random.default_rng(11)
    V = rng.standard_normal((K + 1, R * W))
    Q = np.linalg.qr(rng.standard_normal((K, K)))[0][:, :P]
    ref = np.asarray(rotate_basis_ds(jnp.asarray(Q), jnp.asarray(
        V[:K].reshape(K, R, W)), block_rows=8, interpret=True)).reshape(P, -1)
    tQ = torch.from_numpy(np.ascontiguousarray(Q))
    full = torch.from_numpy(V.copy())
    tV = full[:K]
    want = rotate.rotate_ref(tQ, tV.clone())
    if where == "new":
        got = rotate.rotate(tQ, tV)
    elif where == "buffer":
        buf = torch.full((P, R * W), float("nan"), dtype=torch.float64)
        got = rotate.rotate(tQ, tV, out=buf)
        assert got is buf
    else:
        r0 = 0 if where == "in_place" else K - P
        got = rotate.rotate(tQ, tV, out=full[r0: r0 + P])
        assert got.data_ptr() == full[r0].data_ptr()
        untouched = [r for r in range(K + 1) if not r0 <= r < r0 + P]
        assert np.array_equal(full[untouched].numpy(), V[untouched])
    assert torch.equal(got, want)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err < 5e-14, err
    assert torch.equal(rotate.rotate_ref(tQ, torch.from_numpy(V[:K].copy()),
                                         out=torch.empty_like(want)), want)


def test_rotation_refuses_other_overlaps_and_wrong_out():
    full = torch.zeros((12, 64), dtype=torch.float64)
    V, Q = full[:8], torch.zeros((8, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="overlaps V"):  # shifted 8 columns
        rotate.rotate(Q, V, out=full.view(-1)[8: 8 + 4 * 64].view(4, 64))
    with pytest.raises(ValueError, match="overlaps V"):  # another row stride
        rotate.rotate(Q, V, out=full[::2][:4])
    with pytest.raises(ValueError, match="overlaps Q"):
        rotate.rotate(full[:8, :4], torch.zeros((8, 4), dtype=torch.float64),
                      out=full[:4, :4])
    with pytest.raises(ValueError, match="is not"):
        rotate.rotate(Q, V, out=torch.zeros((5, 64), dtype=torch.float64))
    with pytest.raises(ValueError, match="dtype or device"):
        rotate.rotate(Q, V, out=torch.zeros((4, 64), dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        rotate.rotate(Q, V, out=torch.zeros((4, 128), dtype=torch.float64)[:, ::2])
    # same stride, disjoint column windows of one buffer: no overlap at all
    wide = torch.arange(8.0 * 200, dtype=torch.float64).reshape(8, 200)
    Q2 = torch.eye(8, dtype=torch.float64)[:, :3]
    got = rotate.rotate(Q2, wide[:, :64], out=wide[:3, 100:164])
    assert torch.equal(got, wide[:3, :64])


# shapes on the port's paths: the flagship restart, (ncv, ncv // 2), one
# Ritz vector, b x b blocks, and the card tests' edges
PLAN_SHAPES = [(48, 40), (48, 48), (28, 14), (32, 16), (64, 32), (21, 10),
               (64, 1), (20, 1), (1, 1), (2, 2), (4, 4), (8, 8), (3, 7),
               (5, 9), (17, 8), (49, 40), (65, 64), (129, 64), (129, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,P", PLAN_SHAPES)
@pytest.mark.parametrize("n", [720, 9215, 10_350_000])
def test_rotate_plan_covers_the_paths(dtype, K, P, n):
    plan = rotate.plan_rotate(K, P, n, dtype)
    elt = 8 if dtype == torch.float64 else 4
    assert plan["variant"] == ("mma_f64" if elt == 8 else "ffma_f32")
    assert plan["vec"] == (n % (16 // elt) == 0)  # odd n: 8/4-byte copies
    assert 2 <= plan["stages"] <= 4
    assert plan["smem"] <= rotate.SMEM_LIMIT == 232_448
    assert plan["chunks"] == [(0, P)]
    assert 8 * plan["row_tiles"] >= P and plan["threads"] % 32 == 0
    if elt == 4:
        assert plan["threads"] == 32 * plan["row_tiles"]
    assert 1 <= plan["grid"] <= -(-n // plan["tile"])
    assert plan["grid"] <= 132 * 8


def test_rotate_plan_alignment_chunks_and_refusals():
    f64, f32 = torch.float64, torch.float32
    # a base or a stride that is not 16-byte aligned takes the narrow copies
    assert rotate.plan_rotate(48, 40, 4096, f64)["vec"]
    assert not rotate.plan_rotate(48, 40, 4096, f64, v_base=8)["vec"]
    assert not rotate.plan_rotate(48, 40, 4096, f64, out_base=8)["vec"]
    assert not rotate.plan_rotate(48, 40, 4096, f64, ldv=4097)["vec"]
    assert rotate.plan_rotate(48, 40, 4096, f64, ldv=4098, ldo=5000)["vec"]
    assert not rotate.plan_rotate(48, 40, 4098, f32)["vec"]  # n % 4 != 0
    # a Q wider than one launch's 64 columns is split
    assert rotate.plan_rotate(100, 130, 1000, f64)["chunks"] == [
        (0, 64), (64, 128), (128, 130)]
    # every shape the first kernel took, K (P + 64) elt <= 227 KB, has a plan
    for dtype, elt in ((f64, 8), (f32, 4)):
        for K in (1, 8, 48, 129, 200, 227, 400):
            for P in (1, 8, 40, 64, 163, 500, 3000):
                if K * (P + 64) * elt <= 232_448:
                    plan = rotate.plan_rotate(K, P, 100_000, dtype)
                    assert plan["smem"] <= rotate.SMEM_LIMIT
    # the ring shrinks before a shape is refused
    assert rotate.plan_rotate(400, 64, 1000, f64)["stages"] < 4
    with pytest.raises(ValueError, match="shared memory"):
        rotate.plan_rotate(600, 64, 1000, f64)
    with pytest.raises(ValueError, match="empty"):
        rotate.plan_rotate(0, 4, 10, f64)
    with pytest.raises(TypeError):
        rotate.plan_rotate(4, 4, 10, torch.float16)
    # the occupancy of the compiled kernel, when known, sizes the grid
    seen = []

    def four(*key):
        seen.append(key)
        return 4

    assert rotate.plan_rotate(48, 40, 10_350_000, f64, sm_count=132,
                              blocks_per_sm=four)["grid"] == 528
    assert rotate.plan_rotate(48, 40, 100, f64, blocks_per_sm=four)["grid"] == 2
    assert seen == [(True, 48, 40, 4)] * 2  # (vec, K, P, stages), once a plan
