"""The numbers that decide ``correct``, worked out by the plain reference.

Each function takes what the program returned and a reference operator
(``apply(X)`` in the stored order, ``exact_eigs(k)``) and returns numbers
that are compared with the cell's limits; it reads the program's outputs
only to judge them.  Everything runs in float64 on the outputs' device, in
blocks of a few rows, after the program's own state is freed.
"""

from __future__ import annotations

import numpy as np
import torch

# rows of an (k, n) block the reference applies its stencil to at once
ROWS = 4


def solve_numbers(ref, lam, X, nev: int) -> dict:
    """One solve's numbers: ``missing`` pairs (nev - nconv), ``eig_err`` (the
    largest |lambda_i - exact_i| / |exact_i|, both ascending), ``resid``
    (the largest ||Op x - lambda x|| / (|lambda| ||x||) over the returned
    pairs) and ``orth`` (the largest entry of |X X^T - I|)."""
    lam = np.asarray(lam, np.float64).reshape(-1)
    k = min(lam.size, nev)
    out = {"missing": float(nev - lam.size)}
    if k == 0:
        return dict(out, eig_err=float("inf"), resid=float("inf"),
                    orth=float("inf"))
    exact = ref.exact_eigs(nev)[:k]
    out["eig_err"] = float((np.abs(np.sort(lam[:k]) - exact)
                            / np.abs(exact)).max())
    X = torch.as_tensor(X)[:k].to(torch.float64)
    worst = 0.0
    for i in range(0, k, ROWS):
        B = X[i:i + ROWS]
        L = torch.as_tensor(lam[i:i + ROWS], dtype=torch.float64,
                            device=B.device)
        R = ref.apply(B) - L[:, None] * B
        rel = (torch.linalg.vector_norm(R, dim=1)
               / (L.abs() * torch.linalg.vector_norm(B, dim=1)))
        worst = max(worst, float(rel.max()))
    out["resid"] = worst if np.isfinite(worst) else float("inf")
    G = X @ X.T
    G -= torch.eye(k, dtype=G.dtype, device=G.device)
    out["orth"] = float(G.abs().max())
    return out


def rel_err(y, y_ref) -> float:
    """max |y - y_ref| / max |y_ref| in float64."""
    y = torch.as_tensor(y).to(torch.float64)
    y_ref = torch.as_tensor(y_ref).to(torch.float64)
    if y.shape != y_ref.shape:
        return float("inf")
    scale = float(y_ref.abs().max())
    err = float((y - y_ref).abs().max())
    return err / scale if scale > 0 and np.isfinite(err) else float("inf")


def cheb_filter(apply, X, lo: float, hi: float, degree: int):
    """T_degree((hi + lo - 2 A) / (hi - lo)) X by the three-term recurrence
    t_{k+1} = 2 L(t_k) - t_{k-1}, L(t) = b t - a A t, a = 2 / (hi - lo),
    b = (hi + lo) / (hi - lo), t_0 = X, t_1 = L(X), in X's dtype."""
    a = 2.0 / (hi - lo)
    b = (hi + lo) / (hi - lo)
    if degree <= 0:
        return X.clone()
    prev, cur = X, b * X - a * apply(X)
    for _ in range(1, degree):
        prev, cur = cur, 2.0 * b * cur - 2.0 * a * apply(cur) - prev
    return cur


def probe_numbers(ref, probes: dict) -> dict:
    """The layer probes' numbers: ``spmv_err`` of one operator apply and
    ``filter_err`` of one filtered apply, each against the reference's own
    product on the same input."""
    out = {}
    sp = probes.get("spmv")
    if sp is not None:
        out["spmv_err"] = rel_err(sp["y"], ref.apply(sp["x"].to(torch.float64)))
    fl = probes.get("filter")
    if fl is not None:
        y_ref = cheb_filter(ref.apply, fl["x"].to(torch.float64), fl["lo"],
                            fl["hi"], fl["degree"])
        out["filter_err"] = rel_err(fl["y"], y_ref)
    return out
