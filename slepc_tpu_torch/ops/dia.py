"""DIA SpMV: kernels K1 (float32) and K2 (float64), ``csrc/dia_spmv.cu``.

``y[i] = sum_k diags[k, i] * x[i + offsets[k]]`` with ``x`` taken as zero
outside ``[0, n)`` -- the function of the Pallas kernels in
``slepc_tpu/ops/dia_pallas.py`` (``dia_spmv_prepared``, ``dia_spmv_padded``,
``dia_spmv_padded_v3`` and the double-single ``dia_spmv_padded_ds``), on flat
``(n,)`` vectors.

:func:`dia_spmv` runs the plain version :func:`dia_spmv_ref` for a tensor on
the CPU, launches the CUDA kernel for a tensor on a CUDA device, and raises
for anything else.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

launches = {"dia_spmv_f32": 0, "dia_spmv_f64": 0}


def dia_spmv_ref(offsets: Sequence[int], diags: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch DIA SpMV (the reference the kernel is held against)."""
    n = x.shape[0]
    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        if hi > lo:
            y[lo:hi] += diags[k, lo:hi] * x[lo + off:hi + off]
    return y


def dia_spmv(offsets: Sequence[int], diags: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A x for the DIA matrix ``(offsets, diags)``; diags is (nd, >= n)."""
    n = x.shape[0]
    if x.dim() != 1 or diags.dim() != 2 or diags.shape[0] != len(offsets) \
            or diags.shape[1] < n:
        raise ValueError(f"dia_spmv: x {tuple(x.shape)} does not match diags "
                         f"{tuple(diags.shape)} with {len(offsets)} offsets")
    if diags.dtype != x.dtype or diags.device != x.device:
        raise ValueError("dia_spmv: diags and x differ in dtype or device")
    if x.device.type == "cpu":
        return dia_spmv_ref(offsets, diags, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {x.device}")
    code = _build.dtype_code(x)
    if not x.is_contiguous() or diags.stride(1) != 1:
        raise ValueError("dia_spmv: x and the diagonal rows must be contiguous")
    lib = _build.load()
    if not 1 <= len(offsets) <= lib.slepc_dia_max_diags():
        raise ValueError(f"dia_spmv: {len(offsets)} diagonals is more than "
                         f"the kernel takes")
    y = torch.empty_like(x)
    offs = (ctypes.c_int64 * len(offsets))(*offsets)
    rc = lib.slepc_dia_spmv(code, diags.data_ptr(), diags.stride(0), offs,
                            len(offsets), x.data_ptr(), y.data_ptr(), n,
                            _build.stream_handle(x))
    _build.check(rc, "dia_spmv")
    launches["dia_spmv_f64" if code else "dia_spmv_f32"] += 1
    return y
