"""DIA SpMV and SpMM: kernels K1 (float32), K2 (float64) and K5 (block;
K5c for a complex block), ``csrc/dia_spmv.cu``.

``y[i] = sum_k diags[k, i] * x[i + offsets[k]]`` with ``x`` taken as zero
outside ``[0, n)`` -- the function of the Pallas kernels in
``slepc_tpu/ops/dia_pallas.py`` (``dia_spmv_prepared``, ``dia_spmv_padded``,
``dia_spmv_padded_v3`` and the double-single ``dia_spmv_padded_ds``), on flat
``(n,)`` vectors; for complex64 / complex128 the same kernel's complex
instantiations K1c / K2c (the TPU ran a complex operator as split real
planes, ``slepc_tpu/ops/complex_split.py``).  :func:`dia_spmm` applies the
same operator to the b rows of a ``(b, n)`` block of any height, reading
each diagonal once for all the rows of a launch (``dia_spmv_padded_block``),
in launches of at most ``SPMM_MAX_B`` rows; a complex block runs K5's
complex instantiation K5c, in native complex arithmetic.
:func:`plan_spmm` tells K5 where each diagonal's X values come from: the
window of X each block stages in shared memory (near diagonals), or device
memory (far ones).

Each wrapper runs its plain version (``*_ref``) for a tensor on the CPU,
launches the CUDA kernel for a tensor on a CUDA device, and raises for
anything else.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from . import _build

launches = {"dia_spmv_f32": 0, "dia_spmv_f64": 0, "dia_spmv_c64": 0,
            "dia_spmv_c128": 0, "dia_spmm_f32": 0, "dia_spmm_f64": 0,
            "dia_spmm_c64": 0, "dia_spmm_c128": 0}

# K5: rows a block owns (the real ones the best of the tile sweep of
# ``chip_smoke.py --profile``, PERF.md; the complex ones not swept: c64 as
# f64, whose elements are as wide, and c128 half of it, so that a block
# stages as many bytes), threads a block, and the shared memory a block may
# stage so that two blocks fit on an SM (227 KB each)
SPMM_TILE = {torch.float64: 1024, torch.float32: 2048,
             torch.complex64: 1024, torch.complex128: 512}
SPMM_THREADS = 256
SPMM_SMEM_CAP = 112 * 1024
# K5: the most rows of X one launch takes (the kernel's kMaxB, which the
# card checks against ``slepc_dia_spmm_max_b``); :func:`dia_spmm` launches
# a taller block in chunks of at most this many rows
SPMM_MAX_B = 8
DIRECT, NEAR = 0, 1  # where K5 reads a diagonal's X values


@dataclass(frozen=True)
class SpmmPlan:
    """K5's launch: ``tile`` rows a block; diagonal k reads X from the
    window X[:, i0 - halo : i0 + tile + halo) a block stages (``where[k]
    == NEAR``) or from device memory (``DIRECT``)."""
    tile: int
    halo: int
    where: tuple
    smem: int  # bytes a block stages


def spmm_width(tile: int, halo: int, elem: int) -> int:
    """Elements a block stages per X row (the kernel's spmm_width): the
    window from the 16-byte-aligned start at or below i0 - halo."""
    vw = 16 // elem
    return -(-(tile + 2 * halo + vw - 1) // vw) * vw


def plan_spmm(offsets: Sequence[int], n: int, b: int, dtype: torch.dtype,
              tile: int | None = None) -> SpmmPlan:
    """Where K5 reads each diagonal's X values: the halo h is the largest
    |offset| (below n) whose window of b rows fits ``SPMM_SMEM_CAP``; the
    offsets with |offset| <= h are near, the others (and those past +-n,
    which read zeros) direct.  A tile whose own rows do not fit reads every
    diagonal directly."""
    elem = torch.empty((), dtype=dtype).element_size()
    tile = SPMM_TILE[dtype] if tile is None else int(tile)
    step = SPMM_THREADS * (16 // elem)
    if tile < step or tile % step:
        raise ValueError(f"plan_spmm: a tile of {tile} rows is not a "
                         f"multiple of {step}")
    halo = None
    for a in sorted({abs(int(o)) for o in offsets if abs(int(o)) < n}):
        if b * spmm_width(tile, a, elem) * elem <= SPMM_SMEM_CAP:
            halo = a
    if halo is None:
        return SpmmPlan(tile, 0, (DIRECT,) * len(offsets), 0)
    where = tuple(NEAR if abs(int(o)) <= halo else DIRECT for o in offsets)
    return SpmmPlan(tile, halo, where,
                    b * spmm_width(tile, halo, elem) * elem)


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
    launches["dia_spmv_" + _build.SUFFIX[code]] += 1
    return y


def dia_spmm(offsets: Sequence[int], diags: torch.Tensor,
             X: torch.Tensor, tile: int | None = None) -> torch.Tensor:
    """Y = (A X[m] for each row m): a new (b, n) tensor for X (b, n), b any
    height (on the card the rows go in chunks of at most ``SPMM_MAX_B``,
    one K5 launch each; K5c for complex64 / complex128).  The rows of X
    must each be contiguous; their stride may be anything (a slice of a
    taller basis is taken as it is).
    ``tile``: rows a kernel block owns (default ``SPMM_TILE``; see
    :func:`plan_spmm`)."""
    _check("dia_spmm", offsets, diags, X, 2)
    if X.device.type == "cpu":
        return dia_spmm_ref(offsets, diags, X)
    b, n = X.shape
    code, lib, offs = _kernel_args("dia_spmm", offsets, diags, X)
    if lib.slepc_dia_spmm_max_b() != SPMM_MAX_B:
        raise RuntimeError(f"dia_spmm: the kernel takes blocks of "
                           f"{lib.slepc_dia_spmm_max_b()} rows, SPMM_MAX_B "
                           f"says {SPMM_MAX_B}")
    Y = torch.empty((b, n), dtype=X.dtype, device=X.device)
    plans = {}
    for i in range(0, b, SPMM_MAX_B):
        m = min(SPMM_MAX_B, b - i)
        if m not in plans:
            plan = plan_spmm(offsets, n, m, X.dtype, tile)
            plans[m] = (plan, (ctypes.c_int * len(offsets))(*plan.where))
        plan, where = plans[m]
        rc = lib.slepc_dia_spmm(code, diags.data_ptr(), diags.stride(0), offs,
                                where, len(offsets), X[i].data_ptr(),
                                X.stride(0), Y[i].data_ptr(), n, m, n,
                                plan.tile, plan.halo, _build.stream_handle(X))
        _build.check(rc, "dia_spmm")
        launches["dia_spmm_" + _build.SUFFIX[code]] += 1
    return Y
