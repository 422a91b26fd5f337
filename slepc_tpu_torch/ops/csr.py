"""CSR SpMV: kernel K6 (float32 and float64), ``csrc/csr_spmv.cu``.

``y = A x`` for a CSR matrix ``(rowptr, cols, vals)``: rowptr int64 (m+1),
cols int32 (nnz) in [0, ncols), vals float32/float64 (nnz), x flat (ncols,) -- the
function of the Pallas kernel ``slepc_tpu/ops/ell_pallas.py``
``hyb_spmv_padded`` (general-sparsity SpMV), without its TPU packing: the
matrix stays plain CSR.

:func:`csr_spmv` runs the plain version :func:`csr_spmv_ref` for a tensor on
the CPU, launches the CUDA kernel for a tensor on a CUDA device, and raises
for anything else (x not of length ncols, non-contiguous arrays, another
dtype, nnz >= 2**31).
"""

from __future__ import annotations

import torch

from . import _build

launches = {"csr_spmv_f32": 0, "csr_spmv_f64": 0}

_INT32_LIMIT = 2 ** 31


def lanes_for(m: int, nnz: int) -> int:
    """Lanes per row: the power of two in [2, 32] at or above the mean row
    length (7 nonzeros per row -> 8 lanes)."""
    mean = nnz / max(m, 1)
    lanes = 2
    while lanes < 32 and lanes < mean:
        lanes *= 2
    return lanes


def row_of_entry(rowptr: torch.Tensor) -> torch.Tensor:
    """The row index (int64) of every stored entry."""
    m = rowptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(m, device=rowptr.device), rowptr.diff())


def csr_spmv_ref(rowptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor, rows: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch CSR SpMV (the reference the kernel is held against);
    ``rows`` is :func:`row_of_entry`, recomputed when not given."""
    if rows is None:
        rows = row_of_entry(rowptr)
    y = torch.zeros(rowptr.shape[0] - 1, dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, vals * x[cols])


def csr_spmv(rowptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, ncols: int) -> torch.Tensor:
    """y = A x for the CSR matrix ``(rowptr, cols, vals)`` with ``ncols``
    columns; ``x`` must hold exactly ``ncols`` entries (the kernel gathers
    ``x[cols]`` unchecked).  The kernel's lanes per row come from
    :func:`lanes_for`."""
    if x.dim() != 1 or rowptr.dim() != 1 or cols.dim() != 1 \
            or vals.shape != cols.shape or x.shape[0] != ncols:
        raise ValueError(f"csr_spmv: rowptr {tuple(rowptr.shape)}, cols "
                         f"{tuple(cols.shape)}, vals {tuple(vals.shape)} and "
                         f"x {tuple(x.shape)} do not form a CSR product with "
                         f"{ncols} columns")
    if rowptr.dtype != torch.int64 or cols.dtype != torch.int32:
        raise ValueError("csr_spmv: rowptr must be int64 and cols int32")
    if vals.dtype != x.dtype or len({t.device for t in (rowptr, cols, vals,
                                                         x)}) != 1:
        raise ValueError("csr_spmv: the arrays differ in dtype or device")
    if x.device.type == "cpu":
        return csr_spmv_ref(rowptr, cols, vals, x)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv: no kernel for device {x.device}")
    code = _build.dtype_code(x)
    if not all(t.is_contiguous() for t in (rowptr, cols, vals, x)):
        raise ValueError("csr_spmv: the CSR arrays and x must be contiguous")
    m, nnz = rowptr.shape[0] - 1, cols.shape[0]
    if nnz >= _INT32_LIMIT or m >= _INT32_LIMIT or ncols >= _INT32_LIMIT:
        raise ValueError(f"csr_spmv: {m} rows, {nnz} nonzeros or "
                         f"{ncols} columns is past the kernel's int32 range")
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    lib = _build.load()
    rc = lib.slepc_csr_spmv(code, lanes_for(m, nnz), rowptr.data_ptr(),
                            cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                            y.data_ptr(), m, _build.stream_handle(x))
    _build.check(rc, "csr_spmv")
    launches["csr_spmv_f64" if code else "csr_spmv_f32"] += 1
    return y
