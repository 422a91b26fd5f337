"""The yardstick: published peaks and the bytes and operations a kernel's
work needs, counted from the shapes the benchmark built.

A share of the roofline is the least time the card could take for the work
over the time measured: the least time is the larger of the bytes over the
peak bandwidth and the operations over the peak rate.  Bytes count each
stored entry and index once at its stored width, each input vector read once
and each output written once, whatever a kernel reads again; operations are
two per stored nonzero and column.
"""

from __future__ import annotations

# NVIDIA's data sheet (H100 SXM5 80 GB): HBM3 at 3.35 TB/s; float64 outside
# the tensor cores 34 TFLOP/s (a sparse product cannot use them); the rates
# assume the full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_f64": 34e12},
}


def peak(kind: str):
    """The published peaks of the card named ``kind``, or None when the
    table has no entry for it (a share is then not reported)."""
    return PEAKS.get(kind)


def stored_bytes(layout: dict) -> int:
    """Bytes of the operator as stored: DIA, ndiag x n values (the zeros
    past the grid's edge included, as the kernel reads them); CSR, nnz
    values and column indices and n + 1 row pointers."""
    if layout["format"] == "dia":
        return layout["ndiag"] * layout["n"] * layout["value_bytes"]
    if layout["format"] == "csr":
        return (layout["nnz"] * (layout["value_bytes"] + layout["index_bytes"])
                + (layout["n"] + 1) * layout["rowptr_bytes"])
    raise ValueError(f"no byte count for format {layout['format']!r}")


def nonzeros(layout: dict) -> int:
    if layout["format"] == "dia":
        return layout["ndiag"] * layout["n"]
    return layout["nnz"]


def spmv_work(layout: dict, b: int = 1):
    """(bytes, flops) of one product of the operator with b vectors: the
    operator once, x read once, y written once."""
    vec = layout["n"] * layout["value_bytes"] * b
    return stored_bytes(layout) + 2 * vec, 2 * nonzeros(layout) * b


def filter_work(layout: dict, degree: int, b: int = 1):
    """(bytes, flops) of one Chebyshev filter apply of ``degree`` steps on b
    vectors.  Step 1 (t_1 = b x - a A x) reads the operator and x and
    writes t_1; each later step t_{k+1} = 2b t_k - 2a A t_k - t_{k-1} reads
    the operator, t_k and t_{k-1} and writes t_{k+1}.  Operations: the
    product's two a nonzero plus three a row for the recurrence's update."""
    if degree <= 0:
        return 0, 0
    vec = layout["n"] * layout["value_bytes"] * b
    nbytes = degree * stored_bytes(layout) + (2 + 3 * (degree - 1)) * vec
    flops = degree * (2 * nonzeros(layout) + 3 * layout["n"]) * b
    return nbytes, flops


def least_seconds(nbytes: int, flops: int, peaks: dict) -> float:
    return max(nbytes / peaks["bytes_per_s"], flops / peaks["flops_f64"])


def share_pct(nbytes: int, flops: int, seconds: float, peaks: dict):
    """100 x least time / measured time, or None without a measured time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_seconds(nbytes, flops, peaks) / seconds
