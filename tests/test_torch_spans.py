"""The span registry of slepc_tpu_torch (sys/events.py) and the spans of the
Chebyshev-filtered solve, on the CPU.

The solve is the tiny 3-D Laplacian (10 x 11 x 12) through
``-eps_cheb_degree 20``, with ``cheb_block`` 1 and 2:

* with logging off nothing is recorded and the eigenpairs are bitwise those
  of a logged run, and an event is a profiler annotation only while a
  profiler runs;
* every span lies inside its parent and carries its ``EPS_Solve``'s id;
* the filter's steps, sum of ``degree x rows`` over ``ST_ChebApply``, are
  the filtered columns (``cheb_stats['cols']`` less the probe's) times the
  degree;
* ``get_event`` and ``log_view`` are the sums over the spans.

The ``bytes`` of ``BV_Orthogonalize`` and ``BV_MultInPlace`` are held to a
hand count on one restart cycle of a small basis, single-column and
blocked.
"""

import threading

import numpy as np
import pytest
import torch

import slepc_tpu_torch as tst
from slepc_tpu_torch.eps.ks_jit import ks_hep_cycle, ks_hep_cycle_blocked
from slepc_tpu_torch.sys.events import get_event

DEGREE = 20
NCV = 16


def _solve(block: int, logged: bool):
    A = tst.laplacian_3d(10, 11, 12, dtype=torch.float64, device="cpu")
    eps = tst.EPS(A, problem_type="hep", which="smallest_real", nev=4,
                  tol=1e-8, options=tst.Options.from_cli(
                      f"-eps_ncv {NCV} -eps_cheb_degree {DEGREE}"))
    eps.cheb_block = block
    tst.log_end()
    if logged:
        tst.log_begin()
    try:
        eps.solve()
    finally:
        tst.log_end()
    return eps, tst.log_spans()


@pytest.fixture(autouse=True)
def _clean_log():
    yield
    tst.log_end()
    tst.log_reset()


@pytest.mark.parametrize("block", [1, 2])
def test_logging_off_records_nothing_and_changes_nothing(block):
    tst.log_reset()
    off, spans = _solve(block, logged=False)
    assert spans == [] and get_event("EPS_Solve") is None
    on, spans = _solve(block, logged=True)
    assert len(spans) > 0
    assert off.nconv == on.nconv >= 4
    assert np.array_equal(off.eigenvalues, on.eigenvalues)
    assert torch.equal(off.get_eigenvectors(), on.get_eigenvectors())
    assert off.cheb_stats["cols"] == on.cheb_stats["cols"]


@pytest.mark.parametrize("block", [1, 2])
def test_spans_nest_inside_their_solve(block):
    _, spans = _solve(block, logged=True)
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["name"] == "EPS_Solve"]
    assert len(roots) == 1 and roots[0]["parent"] is None
    root = roots[0]
    assert {s["solve"] for s in spans} == {root["id"]}
    for s in spans:
        assert s["t0_ns"] <= s["t1_ns"]
        if s is root:
            continue
        parent = by_id[s["parent"]]
        assert parent["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= parent["t1_ns"]
    names = {s["name"] for s in spans}
    assert {"EPS_ChebProbe", "EPS_KSCycle", "ST_ChebApply",
            "BV_Orthogonalize", "DS_Solve", "BV_MultInPlace",
            "EPS_ChebAdapt", "EPS_ChebCertify"} <= names
    # the filter runs inside a filtered cycle; the probe's columns inside
    # the probe
    for s in spans:
        if s["name"] == "ST_ChebApply":
            assert by_id[s["parent"]]["name"] == "EPS_KSCycle"
        if s["name"] == "BV_Orthogonalize":
            assert by_id[s["parent"]]["name"] in ("EPS_KSCycle",
                                                  "EPS_ChebProbe")


@pytest.mark.parametrize("block", [1, 2])
def test_filter_steps_are_the_filtered_columns(block):
    eps, spans = _solve(block, logged=True)
    probe = [s for s in spans if s["name"] == "EPS_ChebProbe"]
    assert len(probe) == 1 and probe[0]["cols"] == NCV
    steps = sum(s["degree"] * s["rows"] for s in spans
                if s["name"] == "ST_ChebApply")
    assert all(s["rows"] == block for s in spans
               if s["name"] == "ST_ChebApply")
    assert steps == (eps.cheb_stats["cols"] - probe[0]["cols"]) * DEGREE
    cycles = [s for s in spans if s["name"] == "EPS_KSCycle"]
    assert len(cycles) == eps.cheb_stats["cycles"]
    assert sum(s["cols"] for s in cycles) + NCV == eps.cheb_stats["cols"]
    cert = [s for s in spans if s["name"] == "EPS_ChebCertify"]
    assert len(cert) == eps.cheb_stats["certs"]
    assert sum(s["polish_rounds"] for s in cert) == \
        eps.cheb_stats.get("polish_rounds", 0)
    assert "wall_s" not in eps.cheb_stats


@pytest.mark.parametrize("block", [1, 2])
def test_event_table_sums_the_spans(block):
    _, spans = _solve(block, logged=True)
    table = tst.log_view()
    for name in {s["name"] for s in spans}:
        mine = [s for s in spans if s["name"] == name]
        ev = get_event(name)
        assert ev["count"] == len(mine)
        assert ev["time"] == pytest.approx(
            sum((s["t1_ns"] - s["t0_ns"]) / 1e9 for s in mine), rel=1e-12)
        assert ev["flops"] == sum(s["flops"] for s in mine)
        row = next(line for line in table.splitlines()
                   if line.split()[0] == name)
        assert int(row.split()[1]) == len(mine)
    assert all(s["flops"] == 9.0 * NCV ** 3 for s in spans
               if s["name"] == "DS_Solve")


def _start(n: int, rows: int):
    gen = torch.Generator().manual_seed(5)
    X = torch.randn((rows, n), generator=gen, dtype=torch.float64)
    return torch.linalg.qr(X.T)[0].T.contiguous()


def test_basis_bytes_match_a_hand_count():
    n, ncv = 300, 6
    row = n * 8  # bytes of one float64 basis row
    A = tst.laplacian_1d(n, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    V = torch.zeros((ncv + 1, n), dtype=torch.float64)
    V[0] = _start(n, 1)[0]
    H = np.zeros((ncv + 1, ncv))
    tst.log_begin()
    ks_hep_cycle(A, V, H, 0, 1e-30, gen, ncv=ncv, which="largest")
    tst.log_end()
    spans = tst.log_spans()
    # column j: CGS2 against K = j + 1 rows -- dots (K rows + w), update +
    # dots and update (K rows + w read, w written)
    assert [s["bytes"] for s in spans if s["name"] == "BV_Orthogonalize"] \
        == [(3 * (j + 1) + 5) * row for j in range(ncv)]
    # the restart rotation reads ncv rows and writes ncv
    assert [s["bytes"] for s in spans if s["name"] == "BV_MultInPlace"] \
        == [2 * ncv * row]

    b = 2
    V = torch.zeros((ncv + b, n), dtype=torch.float64)
    V[:b] = _start(n, b)
    H = np.zeros((ncv + b, ncv))
    tst.log_begin()
    ks_hep_cycle_blocked(A, V, H, 0, 1e-30, gen, ncv=ncv, b=b,
                         which="largest")
    tst.log_end()
    spans = tst.log_spans()
    # block step p against m = (p + 1) b rows: BCGS2 (m + b, m + 2b,
    # m + 2b), the Gram (2b), X = inv1 Wb (2b), one more pass (m + b,
    # m + 2b), the Gram (2b), X2 = inv2 X into V (2b)
    assert [s["bytes"] for s in spans if s["name"] == "BV_Orthogonalize"] \
        == [(5 * (p + 1) * b + 16 * b) * row for p in range(ncv // b)]
    assert [s["bytes"] for s in spans if s["name"] == "BV_MultInPlace"] \
        == [2 * ncv * row]


def test_spans_nest_per_thread_and_stop_at_log_end():
    tst.log_begin()
    seen = {}

    def work(tag):
        with tst.log_event("outer_" + tag):
            with tst.log_event("inner_" + tag, flops=2.0, rows=3) as span:
                seen[tag] = span

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    tst.log_end()
    with tst.log_event("after") as span:
        assert span is None
    spans = {s["name"]: s for s in tst.log_spans()}
    assert set(spans) == {"outer_a", "inner_a", "outer_b", "inner_b"}
    for tag in "ab":
        inner, outer = spans["inner_" + tag], spans["outer_" + tag]
        assert inner is seen[tag] and inner["rows"] == 3
        assert inner["parent"] == outer["id"] and outer["parent"] is None
        assert inner["solve"] is None
    assert get_event("inner_a")["flops"] == 2.0


def test_logging_off_annotates_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    tst.log_end()
    quiet = tst.log_event("untraced")
    with quiet as span:
        assert span is None
    # no profiler: the shared empty context, no annotation to enter
    assert tst.log_event("untraced_again") is quiet
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tst.log_event("traced_off") as span:
            assert span is None
            torch.ones(3).sum()
    assert "traced_off" in {e.name for e in prof.events()}
    assert tst.log_spans() == [] and get_event("traced_off") is None
