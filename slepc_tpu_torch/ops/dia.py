"""DIA SpMV and SpMM: kernels K1 (float32), K2 (float64) and K5 (block),
``csrc/dia_spmv.cu``.

``y[i] = sum_k diags[k, i] * x[i + offsets[k]]`` with ``x`` taken as zero
outside ``[0, n)`` -- the function of the Pallas kernels in
``slepc_tpu/ops/dia_pallas.py`` (``dia_spmv_prepared``, ``dia_spmv_padded``,
``dia_spmv_padded_v3`` and the double-single ``dia_spmv_padded_ds``), on flat
``(n,)`` vectors.  :func:`dia_spmm` applies the same operator to the b rows
of a ``(b, n)`` block, reading each diagonal once for all of them
(``dia_spmv_padded_block``).

Each wrapper runs its plain version (``*_ref``) for a tensor on the CPU,
launches the CUDA kernel for a tensor on a CUDA device, and raises for
anything else.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

launches = {"dia_spmv_f32": 0, "dia_spmv_f64": 0,
            "dia_spmm_f32": 0, "dia_spmm_f64": 0}


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


def dia_spmm_ref(offsets: Sequence[int], diags: torch.Tensor,
                 X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch block DIA SpMM: :func:`dia_spmv_ref`'s slice-adds
    broadcast over the b rows of X."""
    n = X.shape[1]
    Y = torch.zeros(X.shape, dtype=X.dtype, device=X.device)
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        if hi > lo:
            Y[:, lo:hi] += diags[k, lo:hi] * X[:, lo + off:hi + off]
    return Y


def _check(name, offsets, diags, x, dim):
    n = x.shape[-1]
    if x.dim() != dim or diags.dim() != 2 or diags.shape[0] != len(offsets) \
            or diags.shape[1] < n:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match diags "
                         f"{tuple(diags.shape)} with {len(offsets)} offsets")
    if diags.dtype != x.dtype or diags.device != x.device:
        raise ValueError(f"{name}: diags and x differ in dtype or device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def _kernel_args(name, offsets, diags, x):
    code = _build.dtype_code(x)
    if x.stride(-1) != 1 or diags.stride(1) != 1:
        raise ValueError(f"{name}: x and the diagonal rows must be contiguous")
    lib = _build.load()
    if not 1 <= len(offsets) <= lib.slepc_dia_max_diags():
        raise ValueError(f"{name}: {len(offsets)} diagonals is more than "
                         f"the kernel takes")
    return code, lib, (ctypes.c_int64 * len(offsets))(*offsets)


def dia_spmv(offsets: Sequence[int], diags: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A x for the DIA matrix ``(offsets, diags)``; diags is (nd, >= n)."""
    _check("dia_spmv", offsets, diags, x, 1)
    if x.device.type == "cpu":
        return dia_spmv_ref(offsets, diags, x)
    code, lib, offs = _kernel_args("dia_spmv", offsets, diags, x)
    y = torch.empty_like(x)
    rc = lib.slepc_dia_spmv(code, diags.data_ptr(), diags.stride(0), offs,
                            len(offsets), x.data_ptr(), y.data_ptr(),
                            x.shape[0], _build.stream_handle(x))
    _build.check(rc, "dia_spmv")
    launches["dia_spmv_f64" if code else "dia_spmv_f32"] += 1
    return y


def dia_spmm(offsets: Sequence[int], diags: torch.Tensor,
             X: torch.Tensor) -> torch.Tensor:
    """Y = (A X[m] for each row m): a new (b, n) tensor for X (b, n).  The
    rows of X must each be contiguous; their stride may be anything (a
    slice of a taller basis is taken as it is)."""
    _check("dia_spmm", offsets, diags, X, 2)
    if X.device.type == "cpu":
        return dia_spmm_ref(offsets, diags, X)
    code, lib, offs = _kernel_args("dia_spmm", offsets, diags, X)
    b, n = X.shape
    if not 1 <= b <= lib.slepc_dia_spmm_max_b():
        raise ValueError(f"dia_spmm: a block of {b} vectors is more than the "
                         f"kernel takes")
    Y = torch.empty((b, n), dtype=X.dtype, device=X.device)
    rc = lib.slepc_dia_spmm(code, diags.data_ptr(), diags.stride(0), offs,
                            len(offsets), X.data_ptr(), X.stride(0),
                            Y.data_ptr(), n, b, n, _build.stream_handle(X))
    _build.check(rc, "dia_spmm")
    launches["dia_spmm_f64" if code else "dia_spmm_f32"] += 1
    return Y
