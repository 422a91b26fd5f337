"""Named-event profiling registry (reference: PetscLog events; ``-log_view``
prints per-event time/flops/counts).

Host-side wall-clock accounting around solver phases, plus
``torch.profiler.record_function`` annotations so events show up in a
profiler trace.  Device work inside an event is awaited only when
``sync=True``: then the event ends with ``torch.cuda.synchronize()``, so its
time covers the kernels it queued (at the cost of pipelining).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

_events: Dict[str, Dict[str, float]] = {}
_enabled = False


def log_begin() -> None:
    """Start collecting event timings (≙ -log_view run)."""
    global _enabled
    _enabled = True
    _events.clear()


def log_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def log_event(name: str, flops: float = 0.0, sync: bool = False):
    """Context manager accounting one event occurrence.

    Always emits a profiler annotation; accumulates wall time/count/flops in
    the registry only when log_begin() was called.
    """
    with torch.profiler.record_function(name):
        if not _enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            ev = _events.setdefault(name, {"count": 0, "time": 0.0, "flops": 0.0})
            ev["count"] += 1
            ev["time"] += dt
            ev["flops"] += flops


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


def get_event(name: str) -> Optional[Dict[str, float]]:
    return _events.get(name)
