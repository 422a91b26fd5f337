"""The control: the plain reference put in the program's place and computed
in float32, the precision below the configurations' float64.

It hands over what a solve and the layer probes would hand over: the nev
smallest eigenpairs (closed-form eigenvectors evaluated in float32, their
Rayleigh quotients on the float32 stencil) and the operator's and the
filter's products on the probes' inputs in float32.  ``correct`` has to
come out false for it; ``portbench/control.py`` reads its numbers on the
card and the CPU tests at a small grid.
"""

from __future__ import annotations

import torch

from . import checks


def solve_outputs(ref, nev: int, dtype=torch.float32):
    """(eigenvalues, (nev, n) eigenvectors) of the reference in ``dtype``."""
    X = ref.eigvecs(nev, dtype)
    AX = ref.apply(X)
    lam = (X * AX).sum(dim=1) / (X * X).sum(dim=1)
    return lam.double().cpu().numpy(), X


def probe_outputs(ref, probes: dict, dtype=torch.float32) -> dict:
    """The probes' outputs of the reference in ``dtype``, on the probes'
    own inputs (and, for the filter, its window and degree)."""
    out = {}
    if "spmv" in probes:
        x = probes["spmv"]["x"].to(dtype)
        out["spmv"] = dict(probes["spmv"], y=ref.apply(x))
    if "filter" in probes:
        fl = probes["filter"]
        y = checks.cheb_filter(ref.apply, fl["x"].to(dtype), fl["lo"],
                               fl["hi"], fl["degree"])
        out["filter"] = dict(fl, y=y)
    return out
