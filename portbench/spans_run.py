"""The span table of one cell's solve: the program's spans inside the solve
joined to a profiler trace of it, and what tracing costs.

    python3 portbench/spans_run.py --workload <cell> --seed <n> [--pairs 3]

From the root of a checkout, on a machine with the cell's cards.  After the
cell's set-up (as ``run.py`` makes it) it times ``--pairs`` pairs of whole
solves, one with the program's logging off and one with it on
(``slepc_tpu_torch.log_begin()`` / ``log_end()``), then one solve with
logging on under ``torch.profiler``.  It prints the span table on standard
error and one JSON object as the last line of standard output: the walls,
the three in-solve readings (``filter_solve_roofline``, ``basis_roofline``,
``outside_filter_pct``; null without device rows), the filter's steps
(sum of degree x rows over ``ST_ChebApply``), each span's offsets from its
profiler row, and the idle time charged to spans beside the trace's own.
Nothing here is a benchmark metric: ``run.py`` does not call it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.harness import runner, spans, spec, trace  # noqa: E402


def traced_solve(stt, op, req: dict, device, log) -> tuple:
    """(solve record, profiler events, spans): the traced run's one solve
    under the profiler (``runner.window``), with the program's logging on
    around it."""
    stt.log_begin()
    try:
        solves, failures, events = runner.window(stt, op, req, device, 0.0,
                                                 True, log)
    finally:
        stt.log_end()
    if failures:
        raise RuntimeError(f"the traced solve failed: {failures[0]}")
    return solves[0], events, stt.log_spans()


def run(cell_name: str, seed: int, pairs: int, *, root: Path = spec.ROOT,
        device=None, log=None) -> dict:
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = spec.benchmark(root)
    _, cfg, req, nchips = spec.load_cell(bench, cell_name, root)
    import torch

    device = runner.require_cards(nchips) if device is None \
        else torch.device(device)
    import slepc_tpu_torch as stt

    mk = spec.maker(cfg["maker"], root)
    op, layout = mk.build(cfg, seed, device,
                          mk.shared_inputs(cfg, Path(root) / "_cache"))
    runner.warm_up(stt, op, req, device)
    walls = {"off": [], "on": []}
    for i in range(2 * pairs):
        # alternate which side goes first in each pair
        logged = (i % 2 == 0) == (i // 2 % 2 == 1)
        if logged:
            stt.log_begin()
        try:
            rec = runner._solve(stt, op, req, device)
        finally:
            stt.log_end()
        walls["on" if logged else "off"].append(rec["wall_s"])
        log(f"solve logging {'on' if logged else 'off'}: {rec['wall_s']} s "
            f"cols {rec['stats'].get('cols')}")
    t0 = time.perf_counter()
    rec, events, sp = traced_solve(stt, op, req, device, log)
    log(f"traced solve: {rec['wall_s']} s, {len(events)} events, "
        f"{len(sp)} spans; read in {time.perf_counter() - t0} s")
    joined = spans.join(events, sp)
    log(spans.format_table(spans.table(joined)))
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    reduced = trace.reduce(events)
    matched = [s for s in joined["spans"] if s["host"] is not None]
    offsets = [s["host_offset_ns"] for s in matched]
    filt = [s for s in joined["spans"] if s["name"] == spans.FILTER]
    return {
        "cell": cell_name, "seed": seed, "device": kind,
        "solve_s_logging_off": walls["off"], "solve_s_logging_on": walls["on"],
        "traced_wall_s": rec["wall_s"], "cheb_cols": rec["stats"].get("cols"),
        "nconv": rec["nconv"], "spans": len(sp),
        "filter_steps": sum(s["degree"] * s["rows"] for s in filt),
        "filter_applies": len(filt),
        "filter_applies_with_device_extent": sum(
            s["dev"] is not None for s in filt),
        "host_offset_us": joined["host_offset_ns"] / 1e3,
        "host_offset_us_quartiles": [q / 1e3 for q in statistics.quantiles(
            offsets, n=4)] if len(offsets) > 1 else None,
        "spans_without_host_row": sum(s["host"] is None
                                      for s in joined["spans"]),
        # a shared clock puts each span inside its annotation's row, which
        # is longer by the annotation's own cost
        "spans_outside_host_row": sum(
            s["t0_ns"] < s["host"][0] or s["t1_ns"] > s["host"][1]
            for s in matched),
        "idle_s_charged": joined["idle_by_name"],
        "idle_s": joined["idle_s"],
        "trace_idle_s": (reduced["window_s"] - reduced["busy_s"]
                         if reduced else None),
        "filter_solve_roofline": spans.filter_solve_roofline(joined, layout,
                                                             kind),
        "basis_roofline": spans.basis_roofline(joined, kind),
        "outside_filter_pct": spans.outside_filter_pct(joined),
        "table": spans.table(joined),
        "offsets": [[s["name"], s["t0_ns"] - s["host"][0],
                     s["host"][1] - s["t1_ns"], s["t0_ns"]] for s in matched],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    try:
        out = run(args.workload, args.seed, args.pairs)
    except runner.NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
