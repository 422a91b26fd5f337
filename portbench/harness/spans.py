"""The program's spans (``slepc_tpu_torch.log_spans()``, recorded between
``log_begin()`` and ``log_end()`` around one traced solve) joined to the
profiler's trace of the same solve, and the three in-solve readings made
from them (``filter_solve_roofline``, ``basis_roofline``,
``outside_filter_pct``).

Each registry span is matched to the profiler's host row of the same name
and order (a ``user_annotation``, or a ``cpu_op`` where the trace's events
carry no activity type): both clocks are ``time.time_ns()``, and the
match's offset says how well they agree.  The span's device extent comes
from the ``gpu_user_annotation`` rows (the profiler gives one to each
annotation that was the innermost one at a launch; a span's extent takes
in its children's); a trace without them (a CPU run) gives no extent and
no reading.  A span's device busy time is the union of the kernel, copy
and set intervals inside its extent; each idle gap of the traced window
goes to the span whose host interval covers most of it, the innermost
among equals (the trace's rule for naming a gap, ``trace._host_during``),
or to ``outside`` when none does.

Reads the profiler's events and the spans' records, nothing else of the
program under test; the events are :func:`trace.raw_events`' tuples.
"""

from __future__ import annotations

import numpy as np

from . import roofline, trace

SOLVE = "EPS_Solve"
FILTER = "ST_ChebApply"
BASIS = ("BV_Orthogonalize", "BV_MultInPlace")
OUTSIDE = "outside"
# the host calls that queue device work (CUDA API events such as
# cudaLaunchKernel and cudaMemcpyAsync; a trace without activity types gives
# them as cpu_op); a span without one has no device row
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
# a span's host row: user_annotation, or cpu_op in a trace without activity
# types (trace.raw_events); no operator of torch bears a span's name
HOST_ROW_KINDS = ("user_annotation", "cpu_op")


def _is_launch(name: str, kind: str) -> bool:
    return kind in trace.HOST_KINDS and any(w in name for w in LAUNCH_WORDS)


def _rows(events, kinds, names=None) -> dict:
    """{name: [(start, end)] in start order} of the events of the given
    kinds (and names)."""
    out: dict = {}
    for n, k, s, d in events:
        if k in kinds and (names is None or n in names):
            out.setdefault(n, []).append((s, s + d))
    for rows in out.values():
        rows.sort()
    return out


def _launch_times(events) -> np.ndarray:
    return np.sort(np.array([s for n, k, s, _ in events
                             if _is_launch(n, k)], np.int64))


def join(events, spans) -> dict:
    """{"spans": [joined span], "window": (w0, w1), "busy_s", "idle_s",
    "idle_by_name": {name or 'outside': s}, "host_offset_ns" (the largest
    span's)}.  A joined span is the registry's record with ``host`` (its
    profiler row or None), ``host_offset_ns`` (the larger of its start's
    and its end's distance from the row's), ``dev`` ((start, end) or None),
    ``busy_ns`` and ``idle_ns`` added."""
    out = [dict(s) for s in spans if s.get("t1_ns") is not None]
    by_name: dict = {}
    for s in out:
        by_name.setdefault(s["name"], []).append(s)
    host_rows = _rows(events, HOST_ROW_KINDS, by_name)
    for name, mine in by_name.items():
        mine.sort(key=lambda s: s["t0_ns"])
        rows = host_rows.get(name, [])
        for s in mine:
            s["host"], s["host_offset_ns"] = None, None
        for s, row in zip(mine, rows):
            s["host"] = row
            s["host_offset_ns"] = max(abs(s["t0_ns"] - row[0]),
                                      abs(s["t1_ns"] - row[1]))
    _device_extents(events, out, by_name)

    dev = [(s, s + d) for n, k, s, d in events
           if k in trace.DEVICE_KINDS and d > 0]
    ds = np.array([a for a, _ in dev], np.int64)
    de = np.array([b for _, b in dev], np.int64)
    for s in out:
        s["busy_ns"] = _busy(ds, de, s["dev"]) if s["dev"] else 0
        s["idle_ns"] = 0
    window = _window(events, out)
    busy = idle = 0
    idle_by_name: dict = {}
    if window is not None:
        w0, w1 = window
        keep = (de > w0) & (ds < w1)
        cs, ce = np.maximum(ds[keep], w0), np.minimum(de[keep], w1)
        busy = trace.union_ns(cs, ce)
        owners = [(s,) for s in out]
        hs = np.array([s["t0_ns"] for s in out], np.int64)
        he = np.array([s["t1_ns"] for s in out], np.int64)
        for a, b in trace.gaps(cs, ce, w0, w1):
            idle += b - a
            # a span, or the trace's name for a gap no span covers
            owner = trace._host_during(owners, hs, he, a, b)
            name = OUTSIDE
            if isinstance(owner, dict):
                owner["idle_ns"] += b - a
                name = owner["name"]
            idle_by_name[name] = idle_by_name.get(name, 0) + (b - a)
    return {"spans": out, "window": window, "busy_s": busy / 1e9,
            "idle_s": idle / 1e9,
            "idle_by_name": {k: v / 1e9 for k, v in idle_by_name.items()},
            "host_offset_ns": max((s["host_offset_ns"] for s in out
                                   if s["host"] is not None), default=0)}


def _device_extents(events, out: list, by_name: dict) -> None:
    """Set each span's ``dev``, the first start to the last end of the
    device work launched inside its host interval (its children's
    included), or None.  From the gpu_user_annotation rows: the profiler
    gives a row to each annotation that was the innermost one at a launch,
    so a name's rows are matched in order to its spans that launched work
    outside their children, and a span's extent takes in its children's."""
    dev_rows = _rows(events, ("gpu_user_annotation",))
    for s in out:
        s["dev"] = None
    kids: dict = {}
    for s in out:
        kids.setdefault(s["parent"], []).append(s)
    lt = _launch_times(events)
    for name, mine in by_name.items():
        rows = dev_rows.get(name, [])
        launching = [s for s in mine
                     if _count(lt, s) > sum(_count(lt, c)
                                            for c in kids.get(s["id"], []))]
        if len(launching) != len(rows):
            continue  # an ambiguous match is no match
        for s, row in zip(launching, rows):
            s["dev"] = row
    for s in sorted(out, key=lambda s: -s["id"]):  # children first
        ext = [c["dev"] for c in kids.get(s["id"], []) if c["dev"]]
        if s["dev"]:
            ext.append(s["dev"])
        if ext:
            s["dev"] = (min(a for a, _ in ext), max(b for _, b in ext))


def _count(lt: np.ndarray, s: dict) -> int:
    """Launches inside the span's host interval."""
    return int(np.searchsorted(lt, s["t1_ns"], side="right")
               - np.searchsorted(lt, s["t0_ns"]))


def _busy(ds: np.ndarray, de: np.ndarray, ext) -> int:
    a, b = ext
    keep = (de > a) & (ds < b)
    return trace.union_ns(np.maximum(ds[keep], a), np.minimum(de[keep], b))


def _window(events, out):
    """The traced call's span when the trace has one, else the solve's."""
    for n, k, s, d in events:
        if n == trace.SPAN and k == "user_annotation":
            return s, s + d
    roots = [s for s in out if s["name"] == SOLVE]
    return (roots[0]["t0_ns"], roots[0]["t1_ns"]) if roots else None


def _self_ns(s: dict, children: list) -> int:
    return (s["t1_ns"] - s["t0_ns"]) - sum(c["t1_ns"] - c["t0_ns"]
                                           for c in children)


def table(joined: dict) -> list:
    """[(name, count, host self s, device extent s, device busy s, idle
    charged s)] per span name, by host self time, then 'outside'."""
    out = joined["spans"]
    kids: dict = {}
    for s in out:
        kids.setdefault(s["parent"], []).append(s)
    rows: dict = {}
    for s in out:
        r = rows.setdefault(s["name"], [0, 0, 0, 0, 0])
        r[0] += 1
        r[1] += _self_ns(s, kids.get(s["id"], []))
        r[2] += (s["dev"][1] - s["dev"][0]) if s["dev"] else 0
        r[3] += s["busy_ns"]
        r[4] += s["idle_ns"]
    lines = [(n, r[0], r[1] / 1e9, r[2] / 1e9, r[3] / 1e9, r[4] / 1e9)
             for n, r in sorted(rows.items(), key=lambda t: -t[1][1])]
    lines.append((OUTSIDE, 0, 0.0, 0.0, 0.0,
                  joined["idle_by_name"].get(OUTSIDE, 0.0)))
    return lines


def format_table(rows: list) -> str:
    head = (f"{'span':<18} {'count':>6} {'host self s':>12} "
            f"{'dev extent s':>13} {'dev busy s':>11} {'idle s':>9}")
    body = [f"{n:<18} {c:>6} {h:>12.6f} {x:>13.6f} {b:>11.6f} {i:>9.6f}"
            for n, c, h, x, b, i in rows]
    return "\n".join([head] + body)


def _named(joined: dict, names) -> list:
    return [s for s in joined["spans"] if s["name"] in names]


def filter_solve_roofline(joined: dict, layout: dict, kind: str):
    """The solve's filter applies, their least time on the card's published
    peaks (``roofline.filter_work`` of each apply's degree and rows) over
    their summed device extents, in %; None without a device extent for
    every apply, or without the card's peaks."""
    peaks = roofline.peak(kind)
    applies = _named(joined, (FILTER,))
    if peaks is None or not applies or any(s["dev"] is None
                                           for s in applies):
        return None
    least = sum(roofline.least_seconds(
        *roofline.filter_work(layout, s["degree"], s["rows"]), peaks)
        for s in applies)
    seconds = sum(s["dev"][1] - s["dev"][0] for s in applies) / 1e9
    return 100.0 * least / seconds if seconds > 0 else None


def basis_roofline(joined: dict, kind: str):
    """The basis sweeps and rotations (``BV_Orthogonalize``,
    ``BV_MultInPlace``): their ``bytes`` at the card's peak bandwidth over
    their summed device busy time, in %; None without device time or
    without the card's peaks."""
    peaks = roofline.peak(kind)
    spans = _named(joined, BASIS)
    busy = sum(s["busy_ns"] for s in spans) / 1e9
    if peaks is None or busy <= 0:
        return None
    return 100.0 * sum(s["bytes"] for s in spans) / peaks["bytes_per_s"] \
        / busy


def outside_filter_pct(joined: dict):
    """100 x (the solve's wall - the filter applies' summed device extents)
    / the solve's wall: the share of the solve a perfect filter would
    leave; None without a solve span or a device extent for every apply."""
    roots = _named(joined, (SOLVE,))
    applies = _named(joined, (FILTER,))
    if len(roots) != 1 or not applies or any(s["dev"] is None
                                             for s in applies):
        return None
    wall = roots[0]["t1_ns"] - roots[0]["t0_ns"]
    ext = sum(s["dev"][1] - s["dev"][0] for s in applies)
    return 100.0 * (wall - ext) / wall if wall > 0 else None
