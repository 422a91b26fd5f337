"""The stream yardstick K7 (slepc_tpu_torch/ops/stream.py) on the CPU.

The TPU kernel it replaces, ``_stream_kernel``, is a closure inside a stage
of the JAX package's ``bench.py`` (``stream_loop_impl``) and cannot be
imported, so the plain version is held against the function that kernel
computes, y = sum_k d_k * x, written in numpy on the same seeded inputs.
Tolerances: 1e-14 relative in f64 and 1e-6 in f32 (a sum of 7 products in
another order).  The kernel itself runs only on a card
(tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

import slepc_tpu_torch as tst
from slepc_tpu_torch.ops.stream import (stream_bandwidth, stream_sum,
                                        stream_sum_ref)


@pytest.mark.parametrize("np_dtype,tol", [(np.float64, 1e-14),
                                          (np.float32, 1e-6)])
@pytest.mark.parametrize("nd,n", [(7, 1000), (1, 17), (5, 513)])
def test_stream_sum_matches_numpy(np_dtype, tol, nd, n):
    rng = np.random.default_rng(nd * n)
    d = rng.standard_normal((nd, n)).astype(np_dtype)
    x = rng.standard_normal(n).astype(np_dtype)
    want = (d.astype(np.float64) * x.astype(np.float64)).sum(0)
    dt, xt = torch.from_numpy(d), torch.from_numpy(x)
    for got in (stream_sum(dt, xt), stream_sum_ref(dt, xt)):
        assert got.dtype == dt.dtype and got.shape == (n,)
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


def test_stream_sum_writes_into_out_and_counts_no_launch_on_cpu():
    tst.reset_launch_counts()
    d = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    x = torch.tensor([1.0, -1.0, 2.0, 0.5], dtype=torch.float64)
    out = torch.empty(4, dtype=torch.float64)
    y = stream_sum(d, x, out=out)
    assert y is out
    assert torch.equal(out, (d * x).sum(0))
    assert tst.launch_counts()["stream_sum_f64"] == 0


@pytest.mark.parametrize("d,x,match", [
    (torch.zeros(3, 4), torch.zeros(5), "not \\(nd, n\\)"),
    (torch.zeros(4), torch.zeros(4), "not \\(nd, n\\)"),
    (torch.zeros(3, 4), torch.zeros(4, dtype=torch.float64), "dtype or device"),
])
def test_stream_sum_rejects_mismatched_operands(d, x, match):
    with pytest.raises(ValueError, match=match):
        stream_sum(d, x)


def test_stream_bandwidth_is_a_device_measurement():
    with pytest.raises(RuntimeError, match="CUDA card"):
        stream_bandwidth(7, 100, torch.float64, device="cpu")
