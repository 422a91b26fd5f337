"""The yardstick's arithmetic on a small grid against hand-computed values,
and the trace's reduction on synthetic intervals."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import roofline, trace

N = 10 * 11 * 12  # 1,320 rows
DIA = {"format": "dia", "n": N, "ndiag": 7, "value_bytes": 8}
CSR = {"format": "csr", "n": N, "nnz": 8516, "value_bytes": 8,
       "index_bytes": 4, "rowptr_bytes": 8}
H100 = roofline.peak("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("layout, b, nbytes, flops", [
    # 7 diagonals of 1,320 f64 (73,920 B) + x and y (21,120 B)
    (DIA, 1, 95_040, 18_480),
    # the diagonals once, x and y of 4 rows (84,480 B)
    (DIA, 4, 158_400, 73_920),
    # 8,516 x (8 + 4) + 1,321 x 8 = 112,760 B, + x and y 21,120 B
    (CSR, 1, 133_880, 17_032),
])
def test_spmv_work(layout, b, nbytes, flops):
    assert roofline.spmv_work(layout, b) == (nbytes, flops)


def test_filter_work_counts_each_step_once():
    # degree 3 on DIA, b = 1: 3 x 73,920 stored + (2 + 3 x 2) x 10,560
    nbytes, flops = roofline.filter_work(DIA, 3)
    assert nbytes == 3 * 73_920 + 8 * 10_560 == 306_240
    assert flops == 3 * (2 * 9_240 + 3 * 1_320) == 67_320
    # b = 4 multiplies the vectors, not the operator
    nbytes4, _ = roofline.filter_work(DIA, 3, 4)
    assert nbytes4 == 3 * 73_920 + 8 * 4 * 10_560
    assert roofline.filter_work(DIA, 0) == (0, 0)


def test_roofline_shares():
    # the flagship's K2: 745.2 MB at 3.35 TB/s is 0.22245 ms; 0.2818 ms
    # measured reads 78.9%
    layout = dict(DIA, n=10_350_000)
    nbytes, flops = roofline.spmv_work(layout)
    assert nbytes == 745_200_000
    least = roofline.least_seconds(nbytes, flops, H100)
    assert least == pytest.approx(745.2e6 / 3.35e12)
    assert roofline.share_pct(nbytes, flops, 0.2818e-3, H100) == \
        pytest.approx(100 * 0.22244776 / 0.2818, rel=1e-6)
    # a made-up compute-bound case takes the operations' bound
    assert roofline.least_seconds(1, 34e12, H100) == pytest.approx(1.0)
    assert roofline.share_pct(nbytes, flops, 0.0, H100) is None
    assert roofline.peak("cpu") is None


def test_union_and_gaps():
    s = np.array([0, 5, 6, 20, 30], np.int64)
    e = np.array([10, 8, 12, 25, 31], np.int64)
    assert trace.union_ns(s, e) == 12 + 5 + 1
    assert trace.gaps(s, e, -5, 40) == [(-5, 0), (12, 20), (25, 30), (31, 40)]
    assert trace.union_ns(np.array([], np.int64), np.array([], np.int64)) == 0


def _events():
    span = (trace.SPAN, "user_annotation", 1_000, 10_000)
    return [span,
            ("k2", "kernel", 1_500, 3_000),          # 1,500-4,500
            ("k2", "kernel", 4_000, 1_000),          # overlaps: to 5,000
            ("memcpy", "gpu_memcpy", 8_000, 1_000),  # 8,000-9,000
            ("k9", "kernel", 10_500, 2_000),         # clipped to 11,000
            ("annot", "gpu_user_annotation", 1_000, 10_000),
            ("aten::eigh", "cpu_op", 5_000, 2_900),
            ("cudaMemcpyAsync", "cuda_runtime", 7_950, 100)]


def test_reduce_synthetic_trace():
    r = trace.reduce(_events())
    # busy: 1,500-5,000, 8,000-9,000 and 10,500-11,000 of the 10,000 span
    assert r["busy_s"] == pytest.approx(5_000e-9)
    assert r["window_s"] == pytest.approx(10_000e-9)
    assert r["device_ops"][0] == ["k2", pytest.approx(4_000e-9)]
    gaps = r["idle_gaps"]
    assert gaps[0] == ["aten::eigh", pytest.approx(3_000e-9)]
    assert [g[1] for g in gaps] == pytest.approx([3e-6, 1.5e-6, 0.5e-6])
    assert "host outside torch" in [g[0] for g in gaps]


def test_idle_pct_reader():
    from portbench.harness import spec

    read = spec.metric_reader("idle_pct")
    assert read({"trace": {"busy_s": 9.7, "window_s": 10.0}}) == \
        pytest.approx(3.0)
    assert read({"trace": None}) is None
    assert read({"trace": {"busy_s": 0.0, "window_s": 10.0}}) is None


class _OldEvent:
    """A profiler event as an older torch gives it: no activity type, times
    in microseconds."""

    def __init__(self, name, device, start_us, duration_us):
        self._n, self._d, self._s, self._l = name, device, start_us, \
            duration_us

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_us(self):
        return self._s

    def duration_us(self):
        return self._l


def test_raw_events_without_activity_types():
    ev = trace.raw_events([
        _OldEvent(trace.SPAN, "CPU", 1, 10),
        _OldEvent(trace.SPAN, "CUDA", 1, 10),   # the span's device row
        _OldEvent("aten::mul", "CPU", 2, 1),
        _OldEvent("dia_spmv_kernel", "CUDA", 3, 2)])
    assert [k for _, k, _, _ in ev] == ["user_annotation",
                                        "gpu_user_annotation", "cpu_op",
                                        "kernel"]
    r = trace.reduce(ev)
    assert r["busy_s"] == pytest.approx(2e-6)
    assert r["window_s"] == pytest.approx(10e-6)
