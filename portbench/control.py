"""The control's readings: the plain reference put in the program's place
in float32 (``reference/control.py``), judged by the same numbers and
limits as a run of the cell, on each seed given.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--lo LO] [--hi HI] [--device cuda]

It needs no program: the eigenpairs are the reference's closed form in
float32 and the probes' products the reference's float32 stencil, on the
inputs a run of the same seed draws.  ``--lo`` / ``--hi`` give the filter
probe's window (a run's traced ``lo`` / ``hi``).  Each seed prints one JSON
line of numbers beside their limits; ``correct`` has to be false on every
one.  Benchmark runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.harness import runner, spec  # noqa: E402
from portbench.reference import checks, control  # noqa: E402


def probe_inputs(req: dict, n: int, seed: int, device, lo: float,
                 hi: float) -> dict:
    """The probes' inputs as a run of ``seed`` draws them."""
    x, x_filter = runner.probe_inputs(req, n, seed, device)
    return {"spmv": {"x": x},
            "filter": {"x": x_filter, "lo": lo, "hi": hi,
                       "degree": int(req["cheb_degree"])}}


def readings(cell_name: str, seed: int, device, lo: float, hi: float,
             root: Path = spec.ROOT) -> dict:
    cellspec, cfg, req, _ = spec.load_cell(spec.benchmark(root), cell_name,
                                           root)
    shared = spec.maker(cfg["maker"], root).shared_inputs(
        cfg, Path(root) / "_cache")
    ref = spec.reference(cfg["reference"], root).make(cfg, seed, device,
                                                      shared)
    nev = int(req["nev"])
    lam, X = control.solve_outputs(ref, nev)
    nums = checks.solve_numbers(ref, lam, X, nev)
    del X
    nums.update(checks.probe_numbers(ref, control.probe_outputs(
        ref, probe_inputs(req, ref.n, seed, device, lo, hi))))
    limits = runner.limits_of(cellspec, req)
    out = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    return {"cell": cell_name, "seed": seed,
            "correct": all(c["value"] <= c["limit"] for c in out.values()),
            "checks": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--lo", type=float, required=True)
    ap.add_argument("--hi", type=float, default=12.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed,
                                  torch.device(args.device), args.lo,
                                  args.hi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
