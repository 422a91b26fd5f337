"""One run of one cell: set-up, the measured window of whole solves, the
traced run's layer probes, the reference's judgement and the result line.

The window's entry is ``slepc_tpu_torch.EPS(op, ...).solve()`` on the
operator the cell's maker built, ended by ``torch.cuda.synchronize()``;
each solve is a new EPS on the same operator.  A solve starts only while
the window has room for one as long as the longest so far; the first always
starts.  ``solve_s`` is the window's summed solve wall over the number of
solves.  ``setup_s`` runs from the process's start (``t_start``) to the
first timed solve.
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path

from . import roofline, spec, trace

PROBE_SEED = 0x5BD1E995  # the probes' inputs: the run's seed xor this
SPMV_REPS = 20    # products back to back in each of three timed groups
FILTER_REPS = 1   # filter applies in each of three timed groups


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def require_cards(count: int):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "measures the card and does not run on the CPU")
    have = torch.cuda.device_count()
    if have < count:
        raise NoCard(f"the cell asks for {count} cards; "
                     f"torch.cuda.device_count() is {have}")
    return torch.device("cuda", 0)


def new_eps(stt, op, req: dict):
    """The cell's solve: EPS with the request's problem, end, nev and tol,
    ncv and Chebyshev degree given as options, and the request's Chebyshev
    settings (and any further ``attrs``) set on it."""
    cli = f"-eps_ncv {req['ncv']} -eps_cheb_degree {req['cheb_degree']}"
    if req.get("options"):
        cli += " " + req["options"]
    eps = stt.EPS(op, problem_type=req["problem_type"], which=req["which"],
                  nev=req["nev"], tol=req["tol"],
                  options=stt.Options.from_cli(cli))
    eps.cheb_keep_den = req["cheb_keep_den"]
    eps.cheb_block = req["cheb_block"]
    for key, value in req.get("attrs", {}).items():
        setattr(eps, key, value)
    return eps


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(stt, op, req: dict, device):
    """Set-up's warm-up on the cell's own operator and widths: one product
    at the request's block width, one filter step pair there, and the
    request's solve cut off after its probe and one certification (a budget
    of 0 s), which loads the kernels, routes the operator (an AIJ matrix's
    routing and row plan are built here, once) and makes the library
    handles."""
    import torch

    b = int(req["cheb_block"])
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((b, op.shape[1]) if b > 1 else (op.shape[1],),
                    generator=gen, dtype=op.dtype, device=device)
    apply = op.mult_block if b > 1 else op.mult
    apply(x)
    cheb = stt.ChebAmplifyOperator(op, 1.0, 2.0, 2)
    (cheb.mult_block if b > 1 else cheb.mult)(x)
    eps = new_eps(stt, op, req)
    eps.cheb_budget_s = 0.0
    eps.solve()
    _sync(device)


def _solve(stt, op, req: dict, device) -> dict:
    before = stt.launch_counts()
    t0 = time.perf_counter()
    eps = new_eps(stt, op, req)
    eps.solve()
    _sync(device)
    wall = time.perf_counter() - t0
    after = stt.launch_counts()
    k = int(eps.nconv)
    X = eps.get_eigenvectors().T if k else None
    return {"wall_s": wall, "nconv": k,
            "lam": [float(v) for v in eps.eigenvalues[:k]], "X": X,
            "stats": dict(eps.cheb_stats or {}),
            "launches": {key: after[key] - before[key] for key in after
                         if after[key] != before[key]}}


def window(stt, op, req: dict, device, seconds: float, traced: bool, log):
    """The measured window: whole solves back to back.  In a traced run the
    first solve runs under the profiler.  Returns (solves, failures,
    profiler events or None)."""
    solves, failures, events = [], [], None
    w0 = time.perf_counter()
    longest = 0.0
    while not solves and not failures or (
            not failures and time.perf_counter() - w0 + longest <= seconds):
        started = trace.start(device.type == "cuda") if (
            traced and events is None) else None
        try:
            rec = _solve(stt, op, req, device)
        except Exception as exc:  # a solve that raises is a failed answer
            failures.append(f"{type(exc).__name__}: {exc}")
            log(f"solve {len(solves) + len(failures)} raised: "
                f"{failures[-1]}")
            break
        finally:
            if started is not None:
                events = trace.stop(started)
        solves.append(rec)
        longest = max(longest, rec["wall_s"])
        log(f"solve {len(solves)}: wall {rec['wall_s']} s nconv "
            f"{rec['nconv']} cols {rec['stats'].get('cols')} cycles "
            f"{rec['stats'].get('cycles')} lo {rec['stats'].get('lo')} hi "
            f"{rec['stats'].get('hi')} launches {rec['launches']}")
    return solves, failures, events


def probe_inputs(req: dict, n: int, seed: int, device):
    """The probes' float64 inputs, the product's and the filter's, drawn
    from the seed: (n,) vectors, or (b, n) blocks at the request's block
    width b."""
    import torch

    b = int(req["cheb_block"])
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) ^ PROBE_SEED) % 2 ** 64)
    shape = (b, n) if b > 1 else (n,)
    return tuple(torch.randn(shape, generator=gen, dtype=torch.float64,
                             device=device) for _ in range(2))


def probes(stt, op, req: dict, last_stats: dict, layout: dict, seed: int,
           device, log) -> dict:
    """The traced run's layer probes, on inputs drawn from the seed: one
    operator product at the request's block width and one Chebyshev filter
    apply at the request's degree and the last solve's window, each timed
    by CUDA events (:func:`_timed`).  Each keeps its input and one output
    for the reference."""
    b = int(req["cheb_block"])
    degree = int(req["cheb_degree"])
    x, x_filter = probe_inputs(req, op.shape[1], seed, device)
    out = {}
    ms, y = _timed(op.mult_block if b > 1 else op.mult, x, SPMV_REPS, device)
    nbytes, flops = roofline.spmv_work(layout, b)
    out["spmv"] = {"x": x, "y": y, "ms": ms, "bytes": nbytes, "flops": flops,
                   "b": b}
    lo, hi = last_stats.get("lo"), last_stats.get("hi")
    if lo is not None and hi is not None and degree > 0:
        cheb = stt.ChebAmplifyOperator(op, lo, hi, degree)
        ms, y = _timed(cheb.mult_block if b > 1 else cheb.mult, x_filter,
                       FILTER_REPS, device)
        nbytes, flops = roofline.filter_work(layout, degree, b)
        out["filter"] = {"x": x_filter, "y": y, "ms": ms, "bytes": nbytes,
                         "flops": flops, "b": b, "lo": float(lo),
                         "hi": float(hi), "degree": degree}
    for name, p in out.items():
        log(f"probe {name}: {p['ms']} ms, {p['bytes']} bytes, "
            f"{p['flops']} flops, b = {p['b']}")
    return out


def _timed(fn, x, reps: int, device, trials: int = 3):
    """(ms a call, the last call's output): ``reps`` calls back to back
    between two CUDA events, as a solve issues them (the host's launch
    time hidden behind the card's work), the median of ``trials`` such
    groups after one call to warm; the host clock elsewhere (a CPU time,
    never reported as a device number)."""
    import torch

    y = fn(x)
    times = []
    for _ in range(trials):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(reps):
                y = fn(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                y = fn(x)
            times.append(1e3 * (time.perf_counter() - t0) / reps)
    return sorted(times)[len(times) // 2], y


def yardsticks(n: int, device, log):
    """Earlier lines of a traced run on a card, no metrics: K7's rate (the
    port's stream kernel at 7 diagonals of n, its own median of 20) and a
    plain torch copy's rate of n float64 (:func:`_timed`, 20 a group)."""
    import torch
    from slepc_tpu_torch.ops.stream import stream_bandwidth

    log(f"yardstick K7 stream_sum (7, {n}) f64: "
        f"{stream_bandwidth(7, n, device=device)} GB/s")
    src = torch.ones(n, dtype=torch.float64, device=device)
    dst = torch.empty_like(src)
    ms, _ = _timed(dst.copy_, src, 20, device)
    log(f"yardstick torch copy of {n} f64: {2 * 8 * n / ms / 1e6} GB/s")


def judge(ref_mod, cfg: dict, limits: dict, nev: int, seed: int, device,
          shared, solves, failures, probe_out) -> tuple:
    """(checks, failed solves): every number compared, its worst over the
    window's solves, beside its limit; a solve fails when one of its
    numbers passes its limit."""
    from portbench.reference import checks as ref_checks

    ref = ref_mod.make(cfg, seed, device, shared)
    worst: dict = {}
    failed = len(failures)
    for rec in solves:
        nums = ref_checks.solve_numbers(ref, rec["lam"], rec["X"]
                                        if rec["X"] is not None else [], nev)
        failed += any(not nums[k] <= limits[k] for k in nums)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, -math.inf), v)
    if probe_out:
        worst.update(ref_checks.probe_numbers(ref, probe_out))
    # a number that could not be worked out (no pair returned, a product
    # that overflowed) is printed as null and fails its limit
    return {k: {"value": v if math.isfinite(v) else None,
                "limit": limits[k]} for k, v in worst.items()}, failed


def limits_of(cellspec: dict, req: dict) -> dict:
    """The cell's limits; ``resid`` is the request's tol, the residual the
    configuration states."""
    return dict(cellspec["limits"], resid=float(req["tol"]))


def run(cell_name: str, seed: int, seconds: float, traced: bool, *,
        root: Path = spec.ROOT, device=None, t_start: float | None = None,
        log=None) -> dict:
    """One run of ``cell_name``; returns the result line's object.  Without
    ``device`` it needs the cell's cards (``NoCard`` otherwise); a test
    passes ``device='cpu'`` to drive the same path through the program's
    plain versions, and such a run's times are CPU times."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = spec.benchmark(root)
    cellspec, cfg, req, nchips = spec.load_cell(bench, cell_name, root)
    marks = [("start", t_start)]

    def mark(name):
        marks.append((name, time.perf_counter()))
    import torch

    mark("import torch")
    device = require_cards(nchips) if device is None else torch.device(device)
    mark("cards")
    import slepc_tpu_torch as stt

    mark("import slepc_tpu_torch")
    on_card = device.type == "cuda"
    mk = spec.maker(cfg["maker"], root)
    shared = mk.shared_inputs(cfg, Path(root) / "_cache")
    mark("shared inputs")
    op, layout = mk.build(cfg, seed, device, shared)
    _sync(device)
    mark("build")
    warm_up(stt, op, req, device)
    mark("warm-up")
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s} s; layout {layout}")
    log("setup phases: " + ", ".join(
        f"{name} {t - marks[i][1]:.3f} s"
        for i, (name, t) in enumerate(marks[1:])))

    solves, failures, events = window(stt, op, req, device, seconds, traced,
                                      log)
    probe_out = None
    if traced and solves:
        probe_out = probes(stt, op, req, solves[-1]["stats"], layout, seed,
                           device, log)
        if on_card:
            yardsticks(op.shape[0], device, log)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # the program's state goes before the reference runs
    del op
    if on_card:
        torch.cuda.empty_cache()
    checks, failed = judge(spec.reference(cfg["reference"], root), cfg,
                           limits_of(cellspec, req), int(req["nev"]), seed,
                           device, shared, solves, failures, probe_out)
    correct = (bool(solves) and failed == 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))

    records = {"solves": [{k: v for k, v in s.items() if k != "X"}
                          for s in solves],
               "probes": {k: {q: v for q, v in p.items() if q not in ("x", "y")}
                          for k, p in (probe_out or {}).items()},
               "device": {"kind": (torch.cuda.get_device_name(device)
                                   if on_card else "cpu")}}
    t0 = time.perf_counter()
    reduced = trace.reduce(events) if events is not None else None
    if events is not None:
        log(f"trace: {len(events)} events reduced in "
            f"{time.perf_counter() - t0} s")
    records["trace"] = reduced
    if traced:
        metrics = {}
        for m in spec.per_layer(bench, cell_name):
            value = spec.metric_reader(m["name"], root)(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        walls = [s["wall_s"] for s in solves]
        measured = {"setup_s": setup_s,
                    "solve_s": sum(walls) / len(walls) if walls else None}
        metrics = {m["name"]: {"value": measured[m["name"]],
                               "unit": m["unit"]}
                   for m in spec.end_to_end(bench, cell_name)
                   if measured.get(m["name"]) is not None}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": records["device"]["kind"], "count": nchips,
                   "memory_peak_bytes": int(peak)}
    if traced and reduced is not None:
        device_info["busy_s"] = reduced["busy_s"]
        device_info["window_s"] = reduced["window_s"]
    result = {"correct": correct, "attempted": len(solves) + len(failures),
              "failed": failed, "metrics": metrics, "device": device_info}
    if traced and reduced is not None:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = checks
    return result
