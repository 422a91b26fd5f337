"""The traced run's reading of the device: ``torch.profiler`` over one call,
reduced to the device's busy time (the union of the intervals in which an
operation ran on the card), the traced window's length, the device
operations that took most time, and the longest idle gaps named by what
the host was doing in them.

The reduction reads the profiler's raw events (name, kind, start, length)
and nothing of the program under test.
"""

from __future__ import annotations

import numpy as np

# kinds of device events that are work on the card; the device-side rows of
# annotations only span the work and are left out
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# kinds of host events that say what the host was doing in a gap
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SPAN = "portbench.traced_call"
TOP = 10


def start(on_card: bool = True):
    """Start torch.profiler (host and, on a card, device activity) and open
    the traced span; hand the result to :func:`stop`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = profile(activities=activities)
    prof.__enter__()
    span = record_function(SPAN)
    span.__enter__()
    return prof, span, on_card


def stop(started) -> list:
    """Close the span after the card has finished, stop the profiler, and
    return its raw events as (name, kind, start ns, length ns)."""
    import torch

    prof, span, on_card = started
    if on_card:
        torch.cuda.synchronize()
    span.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    return raw_events(prof.profiler.kineto_results.events())


def raw_events(kineto) -> list:
    """(name, kind, start ns, length ns) of each event.  ``kind`` is the
    profiler's activity type where the event has one; where it has none
    (older torch), a device event whose name is also a host event's is an
    annotation's device row (a kernel's name never names a host event),
    every other device event is work, and a host event is an operation."""
    out, unknown = [], []
    for e in kineto:
        if hasattr(e, "start_ns"):
            t0, dt = e.start_ns(), e.duration_ns()
        else:
            t0, dt = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        on_device = str(e.device_type()).endswith("CUDA")
        if kind is None:
            unknown.append(len(out))
            kind = "device" if on_device else "host"
        out.append((e.name(), kind, t0, dt))
    if unknown:
        host_names = {out[i][0] for i in unknown if out[i][1] == "host"}
        for i in unknown:
            name, kind, t0, dt = out[i]
            if kind == "device":
                kind = "gpu_user_annotation" if name in host_names \
                    else "kernel"
            else:
                kind = "user_annotation" if name == SPAN else "cpu_op"
            out[i] = (name, kind, t0, dt)
    return out


def union_ns(starts: np.ndarray, ends: np.ndarray) -> int:
    """Length of the union of the intervals [starts, ends)."""
    if starts.size == 0:
        return 0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    # an interval opens a new run when it starts past every earlier end
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > reach[:-1]
    run_start = s[new]
    run_end = np.maximum.reduceat(e, np.flatnonzero(new))
    return int((run_end - run_start).sum())


def gaps(starts: np.ndarray, ends: np.ndarray, w0: int, w1: int):
    """[(start, end)] of the intervals of [w0, w1) that no interval covers."""
    if starts.size == 0:
        return [(w0, w1)] if w1 > w0 else []
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    holes = np.flatnonzero(s[1:] > e[:-1])
    out = [(w0, int(s[0]))] + [(int(e[i]), int(s[i + 1])) for i in holes] \
        + [(int(e[-1]), w1)]
    return [(a, b) for a, b in out if b > a]


def reduce(events) -> dict | None:
    """busy_s, window_s, device_ops and idle_gaps of the traced span, or
    None when the trace holds no span."""
    span = [(s, s + d) for n, k, s, d in events if n == SPAN
            and k == "user_annotation"]
    if not span:
        return None
    w0, w1 = span[0]
    dev = [(n, max(s, w0), min(s + d, w1)) for n, k, s, d in events
           if k in DEVICE_KINDS and d > 0 and s < w1 and s + d > w0]
    starts = np.array([s for _, s, _ in dev], np.int64)
    ends = np.array([e for _, _, e in dev], np.int64)
    busy = union_ns(starts, ends)
    by_name: dict = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0) + (e - s)
    device_ops = sorted(by_name.items(), key=lambda t: -t[1])[:TOP]
    host = [(n, s, s + d) for n, k, s, d in events
            if k in HOST_KINDS and n != SPAN and d > 0]
    hs = np.array([s for _, s, _ in host], np.int64)
    he = np.array([e for _, _, e in host], np.int64)
    longest = sorted(gaps(starts, ends, w0, w1), key=lambda g: g[0] - g[1])
    idle = []
    for a, b in longest[:TOP]:
        idle.append([_host_during(host, hs, he, a, b), (b - a) / 1e9])
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": [[n, ns / 1e9] for n, ns in device_ops],
            "idle_gaps": idle}


def _host_during(host, hs, he, a: int, b: int) -> str:
    """The host event that covers most of the gap [a, b) (the shortest among
    equals, the innermost), or 'host outside torch' when none does."""
    if hs.size == 0:
        return "host outside torch"
    overlap = np.minimum(he, b) - np.maximum(hs, a)
    best = overlap.max()
    if best <= 0:
        return "host outside torch"
    cand = np.flatnonzero(overlap == best)
    i = cand[np.argmin(he[cand] - hs[cand])]
    return host[i][0]
