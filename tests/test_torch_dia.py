"""Port DIA SpMV (slepc_tpu_torch/ops/dia.py) against the Pallas DIA kernels.

The same operators and vectors, made with numpy from a seed, go through the
plain PyTorch SpMV (what the port runs for CPU tensors) and through
slepc_tpu's padded Pallas kernels in interpret mode: f32 via both
``dia_spmv_padded`` and ``dia_spmv_padded_v3`` (and ``mult2d``, which picks
one), f64 via the double-single ``DIAPaddedOperatorDS``.  Compared unpadded.
The unpadded narrow-halo ``dia_spmv_prepared_v3``, which nothing in
slepc_tpu calls, is held against the plain version in f32 and f64.
``DIAOperator`` rejects an x of the wrong length on every device.
Tolerances: f64 1e-13 relative (double-single arithmetic is ~2e-15), f32
1e-6 relative (single rounding of a 5-7 term sum).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slepc_tpu.mat.generators import laplacian_2d, laplacian_3d
from slepc_tpu.mat.linop import DIAOperator as JDIAOperator
from slepc_tpu.ops import dia_pallas as dp
from slepc_tpu_torch import interop
from slepc_tpu_torch.ops import dia

RB = 8  # block_rows of the padded operators (test scale)


def _operators(kind):
    if kind == "lap3":
        return laplacian_3d(7, 6, 5)
    if kind == "lap2":
        return laplacian_2d(24, 24)
    base = laplacian_3d(7, 6, 5) if kind == "rand3" else laplacian_2d(24, 24)
    rng = np.random.default_rng(11)
    return JDIAOperator(base.offsets,
                        rng.standard_normal(np.asarray(base.diags).shape))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("kind", ["lap3", "lap2", "rand3", "rand2"])
def test_f32_matches_padded_kernels(kind):
    A = _operators(kind)
    n = A.shape[0]
    A32 = JDIAOperator(A.offsets, np.asarray(A.diags, np.float32))
    jop = dp.DIAPaddedOperator.from_dia(A32, block_rows=RB)
    top = interop.dia_from_slepc_tpu(jop, device="cpu")
    assert top.dtype == torch.float32
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y = top.mult(torch.from_numpy(x)).numpy()
    xp = jop.pad2d(jnp.asarray(x))
    for fn in (dp.dia_spmv_padded, dp.dia_spmv_padded_v3):
        yp = fn(jop.offsets, jop.dp, xp, n, RB)
        assert _rel(y, np.asarray(jop.unpad(yp))) < 1e-6, fn.__name__
    assert _rel(y, np.asarray(jop.unpad(jop.mult2d(xp)))) < 1e-6


@pytest.mark.parametrize("kind", ["lap3", "lap2", "rand3", "rand2"])
def test_f64_matches_double_single_kernel(kind):
    A = _operators(kind)
    n = A.shape[0]
    jop = dp.DIAPaddedOperatorDS.from_dia(A, block_rows=RB)
    top = interop.dia_from_slepc_tpu(jop, device="cpu")
    assert top.dtype == torch.float64
    x = np.random.default_rng(2).standard_normal(n)
    y = top.mult(torch.from_numpy(x)).numpy()
    yj = np.asarray(jop.unpad(jop.mult2d(jop.pad2d(jnp.asarray(x)))))
    assert _rel(y, yj) < 1e-13
    # and against scipy in f64 (the port is native f64)
    ys = A.to_scipy() @ x if kind.startswith("lap") else None
    if ys is not None:
        assert _rel(y, ys) < 1e-15


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-13)])
@pytest.mark.parametrize("kind", ["lap3", "lap2", "rand3", "rand2"])
def test_plain_version_matches_narrow_halo_prepared_kernel(kind, dtype, tol):
    """dia_spmv_prepared_v3 (the unpadded narrow-halo kernel, no caller in
    slepc_tpu) computes K1's function: held here against the plain version
    on the same numpy diagonals, f32 and f64."""
    A = _operators(kind)
    n = A.shape[0]
    d = np.asarray(A.diags).astype(dtype)
    x = np.random.default_rng(5).standard_normal(n).astype(dtype)
    yj = dp.dia_spmv_prepared_v3(A.offsets, dp.prepare_diags(jnp.asarray(d), n, RB),
                                 jnp.asarray(x), n, RB)
    y = dia.dia_spmv(A.offsets, torch.from_numpy(d), torch.from_numpy(x))
    assert y.dtype == torch.from_numpy(d).dtype
    assert _rel(y.numpy(), np.asarray(yj)) < tol


def test_plain_version_handles_offsets_past_the_ends():
    offsets = (-9, -1, 0, 1, 9)
    rng = np.random.default_rng(3)
    d = rng.standard_normal((5, 7))
    x = rng.standard_normal(7)
    dense = np.zeros((7, 7))
    for k, off in enumerate(offsets):
        for i in range(7):
            if 0 <= i + off < 7:
                dense[i, i + off] = d[k, i]
    y = dia.dia_spmv(offsets, torch.from_numpy(d), torch.from_numpy(x)).numpy()
    assert np.abs(y - dense @ x).max() < 1e-14


@pytest.mark.parametrize("method", ["mult", "mult_h", "mult_block"])
def test_operator_rejects_x_of_the_wrong_length(method):
    # the kernels take n from x, so a short x would silently give the
    # product of A's leading block: the operator checks on every device
    top = interop.dia_from_slepc_tpu(laplacian_2d(6, 5), device="cpu")
    for wrong in (29, 31):
        x = torch.ones(wrong, dtype=torch.float64)
        with pytest.raises(ValueError, match="30 columns"):
            getattr(top, method)(x[None] if method == "mult_block" else x)
    x = torch.ones(30, dtype=torch.float64)
    assert getattr(top, method)(x[None] if method == "mult_block" else x) \
        .shape[-1] == 30


def test_wrapper_raises_off_the_cpu_and_cuda():
    d = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dia.dia_spmv((0,), d, torch.zeros(4, device="meta"))
    with pytest.raises(ValueError):
        dia.dia_spmv((0,), torch.zeros((1, 4)), torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="no kernel"):
        dia.dia_spmm((0,), d, torch.zeros((2, 4), device="meta"))
    with pytest.raises(ValueError):
        dia.dia_spmm((0,), torch.zeros((1, 4)), torch.zeros(4))  # not (b, n)
