"""The join of the program's spans to a profiler trace (harness/spans.py) on
synthetic events, the span table's run on the CPU at a tiny grid, and on a
card (marker ``gpu``) the join of a full-size solve."""

from __future__ import annotations

import pytest

from conftest import CELLS, TINY_DEGREE
from portbench import spans_run
from portbench.harness import roofline, spans, trace

H100 = "NVIDIA H100 80GB HBM3"
DIA = {"format": "dia", "n": 1320, "ndiag": 7, "value_bytes": 8}


def _span(sid, name, parent, t0, t1, **counts):
    return {"name": name, "id": sid, "parent": parent, "solve": 1,
            "t0_ns": t0, "t1_ns": t1, "flops": 0.0, **counts}


# a solve [0, 1000) holding a cycle [100, 900) that holds one filter apply
# [120, 300), one basis sweep [500, 600) and a host-only projected solve
SPANS = [
    _span(1, "EPS_Solve", None, 0, 1000),
    _span(2, "EPS_KSCycle", 1, 100, 900, cols=1),
    _span(3, "ST_ChebApply", 2, 120, 300, degree=2, rows=1),
    _span(4, "BV_Orthogonalize", 2, 500, 600, bytes=67_000),
    _span(5, "DS_Solve", 2, 650, 700),
]
HOST = [(trace.SPAN, "user_annotation", 0, 1000)] + [
    (s["name"], "user_annotation", s["t0_ns"], s["t1_ns"] - s["t0_ns"])
    for s in SPANS]
LAUNCHES = [("cudaLaunchKernel", "cuda_runtime", 130, 2),
            ("cudaLaunchKernel", "cuda_runtime", 135, 2),
            ("cudaLaunchKernel", "cuda_runtime", 510, 2)]


def _untyped(events):
    """The events as trace.raw_events gives them from a torch whose events
    carry no activity type: every host event but the traced call's span is
    a cpu_op."""
    return [(n, "cpu_op" if k in ("user_annotation", "cuda_runtime")
             and n != trace.SPAN else k, s, d) for n, k, s, d in events]
KERNELS = [("k_spmv", "kernel", 150, 150), ("k_axpy", "kernel", 310, 190),
           ("k_dots", "kernel", 520, 60)]
DEV_ROWS = [("ST_ChebApply", "gpu_user_annotation", 150, 350),
            ("BV_Orthogonalize", "gpu_user_annotation", 520, 60)]


def _by_name(joined):
    return {s["name"]: s for s in joined["spans"]}


@pytest.mark.parametrize("typed", [True, False])
def test_join_nests_and_charges_idle_to_the_innermost_span(typed):
    """Device extents from the annotation rows, with activity types and
    without."""
    events = HOST + LAUNCHES + KERNELS + DEV_ROWS
    if not typed:
        events = _untyped(events)
    joined = spans.join(events, SPANS)
    got = _by_name(joined)
    assert got["ST_ChebApply"]["dev"] == (150, 500)
    assert got["ST_ChebApply"]["busy_ns"] == 340
    assert got["BV_Orthogonalize"]["dev"] == (520, 580)
    assert got["EPS_KSCycle"]["dev"] == (150, 580)  # its children's
    assert got["EPS_Solve"]["dev"] == (150, 580)
    assert got["DS_Solve"]["dev"] is None
    assert all(s["host"] is not None for s in joined["spans"])
    assert joined["host_offset_ns"] == 0
    # gaps: [0, 150) -> the solve; [300, 310) -> the cycle (a tie with the
    # solve, the shorter wins); [500, 520) -> the sweep; [580, 1000) -> the
    # solve, which covers 420 ns of it against the cycle's 320
    assert joined["idle_by_name"] == pytest.approx(
        {"EPS_Solve": 570e-9, "EPS_KSCycle": 10e-9,
         "BV_Orthogonalize": 20e-9})
    assert joined["idle_s"] == pytest.approx(1000e-9 - joined["busy_s"])
    assert joined["busy_s"] == pytest.approx(400e-9)
    table = {r[0]: r for r in spans.table(joined)}
    assert table["EPS_Solve"][2] == pytest.approx(200e-9)  # host self
    assert table["EPS_KSCycle"][2] == pytest.approx(800e-9 - 330e-9)

    peaks = roofline.peak(H100)
    least = roofline.least_seconds(*roofline.filter_work(DIA, 2, 1), peaks)
    assert spans.filter_solve_roofline(joined, DIA, H100) == \
        pytest.approx(100 * least / 350e-9)
    assert spans.basis_roofline(joined, H100) == \
        pytest.approx(100 * 67_000 / 3.35e12 / 60e-9)
    assert spans.outside_filter_pct(joined) == pytest.approx(65.0)


def test_readings_are_none_without_device_rows():
    joined = spans.join(HOST + LAUNCHES, SPANS)
    assert all(s["dev"] is None for s in joined["spans"])
    assert spans.filter_solve_roofline(joined, DIA, H100) is None
    assert spans.basis_roofline(joined, H100) is None
    assert spans.outside_filter_pct(joined) is None
    # the card's peaks are needed too
    joined = spans.join(HOST + LAUNCHES + KERNELS + DEV_ROWS, SPANS)
    assert spans.filter_solve_roofline(joined, DIA, "cpu") is None
    assert spans.basis_roofline(joined, "cpu") is None


def test_host_offset_and_ambiguous_rows():
    shifted = [dict(s, t0_ns=s["t0_ns"] + 7) for s in SPANS]
    joined = spans.join(HOST + LAUNCHES + KERNELS + DEV_ROWS, shifted)
    assert joined["host_offset_ns"] == 7
    # two rows for the one apply that launched work: no match, no reading
    extra = [("ST_ChebApply", "gpu_user_annotation", 600, 10)]
    joined = spans.join(HOST + LAUNCHES + KERNELS + DEV_ROWS + extra, SPANS)
    assert _by_name(joined)["ST_ChebApply"]["dev"] is None
    assert spans.outside_filter_pct(joined) is None


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[2]])
def test_span_table_runs_on_cpu(tiny_root, cell):
    out = spans_run.run(cell, 2 ** 31 + 11, 1, root=tiny_root, device="cpu",
                        log=lambda msg: None)
    assert out["nconv"] == 20 and out["spans"] > 0
    assert out["filter_steps"] == (out["cheb_cols"] - 32) * TINY_DEGREE
    assert out["spans_without_host_row"] == 0
    assert out["spans_outside_host_row"] == 0
    assert out["filter_solve_roofline"] is None
    assert out["basis_roofline"] is None
    assert out["outside_filter_pct"] is None


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_span_table_on_card(card, cell):
    """On a card, a full-size solve: every span lies inside its profiler
    row (the row is longer by the annotation's own enter and exit, tens of
    microseconds under the profiler; the median offset within 100 us),
    every filter apply has a device extent, the idle time charged adds up
    to the trace's, and the readings lie in (0, 100]."""
    out = spans_run.run(cell, 2 ** 31 + 11, 0, log=lambda msg: None)
    assert out["nconv"] == 20
    assert out["spans_without_host_row"] == 0
    assert out["spans_outside_host_row"] == 0
    assert out["host_offset_us_quartiles"][1] <= 100
    assert out["filter_applies_with_device_extent"] == out["filter_applies"]
    assert out["filter_steps"] == (out["cheb_cols"] - 32) * 450
    assert sum(out["idle_s_charged"].values()) == pytest.approx(
        out["trace_idle_s"], rel=0.01)
    for name in ("filter_solve_roofline", "basis_roofline",
                 "outside_filter_pct"):
        assert 0 < out[name] <= 100
