"""CSR SpMV: kernel K6 (float32 and float64), ``csrc/csr_spmv.cu``.

``y = A x`` for a CSR matrix ``(rowptr, cols, vals)``: rowptr int64 (m+1),
cols int32 (nnz) in [0, ncols), vals float32/float64/complex64/complex128
(nnz; complex values run the kernel's complex instantiation K6c), x flat
(ncols,) -- the
function of the Pallas kernel ``slepc_tpu/ops/ell_pallas.py``
``hyb_spmv_padded`` (general-sparsity SpMV), without its TPU packing: the
matrix stays plain CSR.

The kernel walks a row-block plan (:func:`csr_row_blocks`): consecutive
rows grouped so that a block holds at most ``budget`` stored entries (a
longer row gets a block of its own) and at most ``CSR_MAX_ROWS`` rows; a
row longer than the budget is cut into chunks of ``CSR_CHUNKS * budget``
entries, one thread block each, whose partial sums the last of them adds
in chunk order.  The plan is a pure function of ``rowptr`` (and belongs to
it), built once per operator (``AIJOperator.row_plan``) and shared by every
matrix with the same ``rowptr`` (``vals.abs()`` in the Gershgorin bound).

:func:`csr_spmv` runs the plain version :func:`csr_spmv_ref` for a tensor on
the CPU, launches the CUDA kernel for a tensor on a CUDA device, and raises
for anything else (x not of length ncols, non-contiguous arrays, another
dtype, nnz >= 2**31, a plan for another row count).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build

launches = {"csr_spmv_f32": 0, "csr_spmv_f64": 0, "csr_spmv_c64": 0,
            "csr_spmv_c128": 0}

_INT32_LIMIT = 2 ** 31
# entries a row block holds, per dtype: the best of the budget sweep of
# ``chip_smoke.py --profile`` (PERF.md) for f32 / f64; complex64 starts at
# f64's budget (the same shared bytes a product) and complex128 at half of
# it (not swept)
CSR_BUDGET = {torch.float64: 2048, torch.float32: 4096,
              torch.complex64: 2048, torch.complex128: 1024}
CSR_MAX_ROWS = 1024  # rows a block holds (the kernel's kMaxRows)
CSR_MAX_BUDGET = 16384  # the kernel's kMaxBudget
CSR_CHUNKS = 4  # a long row's chunks hold CSR_CHUNKS * budget entries


@dataclass(frozen=True)
class CSRPlan:
    """Row blocks of a CSR matrix: block i is rows [starts[i], starts[i+1]);
    the rows longer than ``budget`` (``long_rows``) are cut into chunks of
    ``chunk`` entries: long row i has chunks [chunk_first[i],
    chunk_first[i+1]), and ``chunk_row`` maps a chunk to its long row."""
    starts: torch.Tensor  # int32 (nblocks + 1,), starts[0] = 0, starts[-1] = m
    budget: int
    m: int
    long_rows: torch.Tensor    # int32 (nlong,)
    chunk_first: torch.Tensor  # int32 (nlong + 1,)
    chunk_row: torch.Tensor    # int32 (nchunks,)
    chunk: int

    @property
    def nblocks(self) -> int:
        return int(self.starts.shape[0]) - 1

    @property
    def nchunks(self) -> int:
        return int(self.chunk_row.shape[0])


def csr_row_blocks(rowptr: torch.Tensor, budget: int,
                   max_rows: int = CSR_MAX_ROWS) -> torch.Tensor:
    """Greedy row blocks: from row r, the block takes the most consecutive
    rows whose entries total at most ``budget`` (at least one row, at most
    ``max_rows``).  Returns the block starts, int32 (nblocks + 1,), ending
    at m, on rowptr's device.  The greedy chain 0 -> f(0) -> f(f(0)) is
    followed by pointer doubling: log2(nblocks) gathers of length m."""
    m = rowptr.shape[0] - 1
    dev = rowptr.device
    if m <= 0:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    r = torch.arange(m + 1, device=dev)
    # last e with rowptr[e] <= rowptr[r] + budget: rows r..e-1 fit
    e = torch.searchsorted(rowptr, rowptr + budget, right=True) - 1
    nxt = torch.minimum(torch.maximum(e, r + 1),
                        torch.clamp(r + max_rows, max=m))
    nxt[m] = m
    chain = torch.zeros(1, dtype=torch.int64, device=dev)  # f^j(0), j < 2^k
    jump = nxt                                             # f^(2^k)
    while int(chain[-1]) < m:
        chain = torch.cat([chain, jump[chain]])
        jump = jump[jump]
    starts = torch.cat([chain[chain < m],
                        torch.full((1,), m, dtype=torch.int64, device=dev)])
    return starts.to(torch.int32)


def csr_plan(rowptr: torch.Tensor, budget: int) -> CSRPlan:
    """The kernel's plan for ``rowptr`` at ``budget`` entries a block
    (``CSR_BUDGET[dtype]`` for the kernel's values)."""
    if not 1 <= budget <= CSR_MAX_BUDGET:
        raise ValueError(f"csr_plan: budget {budget} is outside "
                         f"[1, {CSR_MAX_BUDGET}]")
    chunk = CSR_CHUNKS * int(budget)
    lens = rowptr.diff()
    long_rows = torch.nonzero(lens > budget).flatten()
    nch = (lens[long_rows] + chunk - 1) // chunk
    chunk_first = torch.zeros(long_rows.numel() + 1, dtype=torch.int64,
                              device=rowptr.device)
    torch.cumsum(nch, 0, out=chunk_first[1:])
    chunk_row = torch.repeat_interleave(
        torch.arange(long_rows.numel(), device=rowptr.device), nch)
    return CSRPlan(csr_row_blocks(rowptr, budget), int(budget),
                   int(rowptr.shape[0]) - 1, long_rows.to(torch.int32),
                   chunk_first.to(torch.int32), chunk_row.to(torch.int32),
                   chunk)


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
    if y.is_complex():  # the (re, im) pairs as rows of a real (m, 2) view
        torch.view_as_real(y).index_add_(0, rows,
                                         torch.view_as_real(vals * x[cols]))
        return y
    return y.index_add_(0, rows, vals * x[cols])


def csr_spmv(rowptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, ncols: int,
             plan: CSRPlan | None = None) -> torch.Tensor:
    """y = A x for the CSR matrix ``(rowptr, cols, vals)`` with ``ncols``
    columns; ``x`` must hold exactly ``ncols`` entries (the kernel gathers
    ``x[cols]`` unchecked).  ``plan``: the row blocks of ``rowptr``
    (:func:`csr_plan`), built here when not given."""
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
    m = rowptr.shape[0] - 1
    if plan is not None and (plan.m != m
                             or plan.starts.device != rowptr.device):
        raise ValueError(f"csr_spmv: a plan for {plan.m} rows on "
                         f"{plan.starts.device} does not fit {m} rows on "
                         f"{rowptr.device}")
    if x.device.type == "cpu":
        return csr_spmv_ref(rowptr, cols, vals, x)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv: no kernel for device {x.device}")
    code = _build.dtype_code(x)
    if not all(t.is_contiguous() for t in (rowptr, cols, vals, x)):
        raise ValueError("csr_spmv: the CSR arrays and x must be contiguous")
    nnz = cols.shape[0]
    if nnz >= _INT32_LIMIT or m >= _INT32_LIMIT or ncols >= _INT32_LIMIT:
        raise ValueError(f"csr_spmv: {m} rows, {nnz} nonzeros or "
                         f"{ncols} columns is past the kernel's int32 range")
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    if plan is None:
        plan = csr_plan(rowptr, CSR_BUDGET[x.dtype])
    lib = _build.load()
    partial = done = None
    if plan.nchunks:
        # the long rows' chunks: their partial sums, and per long row a
        # count of its chunks done (the last one adds the partial sums)
        partial = torch.empty(plan.nchunks, dtype=x.dtype, device=x.device)
        done = torch.zeros(plan.long_rows.numel(), dtype=torch.int32,
                           device=x.device)
    rc = lib.slepc_csr_spmv(
        code, rowptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
        x.data_ptr(), y.data_ptr(), plan.starts.data_ptr(), plan.nblocks,
        plan.budget, plan.long_rows.data_ptr(), plan.chunk_first.data_ptr(),
        plan.chunk_row.data_ptr(), plan.nchunks, plan.chunk,
        None if partial is None else partial.data_ptr(),
        None if done is None else done.data_ptr(), _build.stream_handle(x))
    _build.check(rc, "csr_spmv")
    launches["csr_spmv_" + _build.SUFFIX[code]] += 1
    return y
