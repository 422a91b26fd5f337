"""Run one cell of the slepc_tpu_torch benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the ``slepc_tpu_torch`` package, on a machine with the cell's cards.
It builds the cell's operator on the card from the seed, warms the cell's
own shapes, times whole solves for ``--seconds``, judges every answer with
the plain reference, and prints one JSON object as the last line of its
standard output (with ``--trace 1`` the per-layer metrics, without it the
end-to-end ones).  Without the cards (or without the package) it exits
with a code other than 0 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
# compiled bytecode of every module the run imports (torch's thousands
# included) is kept in the checkout, so that only a checkout's first run
# compiles it: an environment that writes no bytecode beside read-only
# packages otherwise recompiles torch in every process (6-8 s, and the
# largest part of set-up's spread)
sys.pycache_prefix = str(REPO / "portbench" / "_cache" / "pycache")
sys.dont_write_bytecode = False

from portbench.harness import guard, runner  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi unavailable ({exc})"
    return out


def main(argv=None) -> int:
    args = parse(argv)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    try:
        result = runner.run(args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=T_START, log=log)
    except runner.NoCard as exc:
        log(f"no result: {exc}")
        return 2
    found = guard.banned_modules()
    if found:
        log(f"no result: the process holds {found} after the window")
        return 3
    print(f"card: {card_line()}", flush=True)
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
