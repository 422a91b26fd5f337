"""Per-iteration monitors (reference: src/eps/interface/epsmon.c).

A monitor is a callable invoked once per outer iteration with
``(solver, its, nconv, eigs, errests)``.  Built-ins mirror the reference's
first/all/conv ASCII monitors (-eps_monitor, -eps_monitor_all,
-eps_monitor_conv; reference: src/eps/interface/epsregis.c:119-131).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np

MonitorFn = Callable[..., None]


class Monitor:
    """A list of monitor callbacks, invoked each outer iteration."""

    def __init__(self):
        self._fns: List[MonitorFn] = []

    def add(self, fn: MonitorFn) -> None:
        self._fns.append(fn)

    def clear(self) -> None:
        self._fns.clear()

    def __call__(self, solver, its, nconv, eigs, errests) -> None:
        for fn in self._fns:
            fn(solver, its, nconv, eigs, errests)

    def __len__(self):
        return len(self._fns)


def monitor_first(solver, its, nconv, eigs, errests):
    """Print the first unconverged approximation (≙ -eps_monitor)."""
    eigs = np.asarray(eigs)
    errests = np.asarray(errests)
    j = min(nconv, len(eigs) - 1)
    print(f"{its:3d} {type(solver).__name__} nconv={nconv} "
          f"first unconverged value (error) {_fmt(eigs[j])} ({errests[j]:.8e})")


def monitor_all(solver, its, nconv, eigs, errests):
    """Print every approximation (≙ -eps_monitor_all)."""
    eigs = np.asarray(eigs)
    errests = np.asarray(errests)
    vals = " ".join(f"{_fmt(e)} ({r:.2e})" for e, r in zip(eigs, errests))
    print(f"{its:3d} {type(solver).__name__} nconv={nconv} values: {vals}")


class ConvMonitor:
    """Print each newly converged pair (≙ -eps_monitor_conv)."""

    def __init__(self):
        self._seen = 0

    def __call__(self, solver, its, nconv, eigs, errests):
        eigs = np.asarray(eigs)
        errests = np.asarray(errests)
        for j in range(self._seen, nconv):
            print(f"{its:3d} {type(solver).__name__} converged value #{j}: "
                  f"{_fmt(eigs[j])} (error {errests[j]:.8e})")
        self._seen = max(self._seen, nconv)


def _fmt(v) -> str:
    v = complex(v)
    if v.imag == 0:
        return f"{v.real:.9f}"
    sign = "+" if v.imag >= 0 else "-"
    return f"{v.real:.9f}{sign}{abs(v.imag):.9f}i"
