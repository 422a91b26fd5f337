"""Named-event profiling registry (reference: PetscLog events; ``-log_view``
prints per-event time/flops/counts).

Host-side wall-clock accounting around solver phases, plus
``torch.profiler.record_function`` annotations so events show up in a
profiler trace.  Device work inside an event is awaited only when
``sync=True``: then the event ends with ``torch.cuda.synchronize()``, so its
time covers the kernels it queued (at the cost of pipelining).

Between :func:`log_begin` and :func:`log_end` every occurrence is also kept
as a span (:func:`log_spans`): its name, its id, the innermost span open
around it in the same thread (``parent``), the id of the outermost
``EPS_Solve`` span around it (``solve``, None outside a solve), its start
and end on ``time.time_ns()`` (``t0_ns`` / ``t1_ns``: the Unix clock on
which ``torch.profiler`` stamps host events, so a span lines up with its
annotation's row in a trace) and its work counts (``flops`` and whatever
counts the call site gives).  The per-name table (:func:`get_event`,
:func:`log_view`) sums the same records.  With logging off an event is its
profiler annotation alone while a profiler runs, and nothing otherwise: no
record, no clock read, no synchronization.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

_events: Dict[str, Dict[str, float]] = {}
_spans: List[dict] = []
_enabled = False
_ids = itertools.count(1)
_open = threading.local()  # .stack: the spans open in this thread


def log_begin() -> None:
    """Start collecting event timings and spans (≙ -log_view run); clears
    what an earlier run collected."""
    global _enabled
    _enabled = True
    _events.clear()
    _spans.clear()


def log_end() -> None:
    """Stop collecting.  What was collected stays readable until the next
    :func:`log_begin` or :func:`log_reset`."""
    global _enabled
    _enabled = False


def log_enabled() -> bool:
    return _enabled


def log_spans() -> List[dict]:
    """The spans collected since :func:`log_begin`, in the order they
    opened (module docstring); a span still open has ``t1_ns`` None."""
    return list(_spans)


_NO_EVENT = contextlib.nullcontext()


def log_event(name: str, flops: float = 0.0, sync: bool = False, **counts):
    """Context manager accounting one event occurrence.

    After log_begin() it records a span holding ``flops`` and the keyword
    ``counts`` (numbers of the work inside it), inside a profiler
    annotation, and yields the span, so that the call site can add a count
    it knows only at the end.  Otherwise it yields None: inside a profiler
    annotation while a profiler listens (``torch.autograd.
    _profiler_enabled()``), around nothing when none does, so that an
    untraced solve pays no annotation's host cost.
    """
    if _enabled:
        return _span(name, flops, sync, counts)
    if torch.autograd._profiler_enabled():
        return _annotation(name)
    return _NO_EVENT


@contextlib.contextmanager
def _annotation(name: str):
    with torch.profiler.record_function(name):
        yield None


@contextlib.contextmanager
def _span(name: str, flops: float, sync: bool, counts: dict):
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    parent = stack[-1] if stack else None
    sid = next(_ids)
    solve = parent["solve"] if parent is not None else None
    if solve is None and name == "EPS_Solve":
        solve = sid
    span = {"name": name, "id": sid,
            "parent": parent["id"] if parent is not None else None,
            "solve": solve, "t0_ns": None, "t1_ns": None, "flops": flops,
            **counts}
    _spans.append(span)
    stack.append(span)
    try:
        # the clock is read right inside the annotation, so that the span
        # and the annotation's profiler row differ by the annotation's own
        # cost alone
        with torch.profiler.record_function(name):
            span["t0_ns"] = time.time_ns()
            try:
                yield span
            finally:
                if sync and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                span["t1_ns"] = time.time_ns()
    finally:
        stack.pop()
        ev = _events.setdefault(name, {"count": 0, "time": 0.0,
                                       "flops": 0.0})
        ev["count"] += 1
        ev["time"] += (span["t1_ns"] - span["t0_ns"]) / 1e9
        ev["flops"] += span["flops"]


def log_event_end_sync(x):
    """Wait for the device work that produces ``x`` inside an event, so the
    event's time covers it (the reference's placeholder blocks on a JAX
    value): ``torch.cuda.synchronize()`` when ``x`` holds a tensor on a
    card.  Returns ``x``."""
    items = x if isinstance(x, (list, tuple)) else (x,)
    for t in items:
        if torch.is_tensor(t) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            break
    return x


def log_view(stream=None) -> str:
    """Render the event table (≙ PETSc -log_view summary)."""
    lines = ["Event                          Count      Time (s)     Mflops"]
    total = sum(ev["time"] for ev in _events.values())
    for name in sorted(_events, key=lambda k: -_events[k]["time"]):
        ev = _events[name]
        mf = ev["flops"] / ev["time"] / 1e6 if ev["time"] > 0 else 0.0
        lines.append(f"{name:<30} {ev['count']:>5} {ev['time']:>13.6f} "
                     f"{mf:>10.1f}")
    lines.append(f"{'total':<30} {'':>5} {total:>13.6f}")
    out = "\n".join(lines)
    if stream is not None:
        print(out, file=stream)
    return out


def log_reset() -> None:
    _events.clear()
    _spans.clear()


def get_event(name: str) -> Optional[Dict[str, float]]:
    return _events.get(name)
