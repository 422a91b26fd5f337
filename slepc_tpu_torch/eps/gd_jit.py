"""The Generalized-Davidson restart cycle for standard Hermitian problems
with a Jacobi (or identity) preconditioner (``slepc_tpu/eps/gd_jit.py``).

Reference semantics: the GD branch of the Davidson framework
(src/eps/impls/davidson/davidson.c harness; gd/gd.c) -- expand the search
space with the preconditioned residual of the best unconverged Ritz pair,
Rayleigh-Ritz every step, thick restart with the best Ritz vectors.  The
reference fuses a whole subspace fill into one XLA program; PyTorch runs
eagerly, so here the cycle is host-orchestrated, like the Krylov-Schur
cycle of ``eps/ks_jit.py``, and every product over the basis runs on the
port's kernels:

  * V (ncv, n), the row-major search basis, and W = A V beside it, both
    updated in place on the operator's device; G = V A V^T, the small
    projected matrix, on the host;
  * step j: the eigh of G's active j x j block on the host (LAPACK, the
    reference's ``eigh_small``), the target Ritz vector u = V^T y and its
    residual r = W^T y - theta u (kernel K4 at (j, 1)), the Jacobi
    correction t = dinv r, CGS2 of t against V[:j] (kernel K3), the new
    row w = A v (kernel K2 on DIA, K6 on CSR) and G's new row and column
    (K3's dots): one host read per step (the residual norm, the CGS
    coefficients' norm, ||t|| and G's new column);
  * soft locking: converged leading pairs stay in the basis; the expansion
    target walks forward when its residual passes tol, and the host counts
    the converged pairs after each cycle;
  * restart: rotate V and W in place by the eigenvectors of G (K4 at
    (ncv, ncv)), keep kl = k2 + (ncv - k2)/2 rows, and G becomes
    diag(theta).

A breakdown (the correction in the span of V) refills the new row with a
random direction from a seeded ``torch.Generator`` orthogonalized twice
against V; the reference draws from ``jax.random.fold_in(PRNGKey(777), j)``,
so the two trajectories differ after a breakdown (ROADMAP.md queue 3).
The eigh of the active block stands in for the reference's masked eigh of
the whole G (inactive diagonal pushed to +-1/eps): the same values, with
eigenvectors that may differ in sign, and the same spans.

The JD correction equation keeps the host path (projected GMRES with
adaptive tolerances, ``eps/davidson.py``); only the GD improver has a
cycle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bv import panel_dots
from ..ops.rotate import rotate
from ..parallel.tasks import _op_diag
from .ks_jit import _host, _mat, _np_dtype, _orth_sweeps, _prepare_fast_operator


def _ritz(G: np.ndarray, m: int, which: str):
    """Eigenpairs of G's active m x m block, wanted end first."""
    Gm = G[:m, :m]
    theta, Y = np.linalg.eigh(0.5 * (Gm + Gm.conj().T))
    if which == "largest":
        theta, Y = theta[::-1].copy(), Y[:, ::-1].copy()
    return theta, Y


def _new_row(op, V, W, j: int, t: torch.Tensor, tn) -> torch.Tensor:
    """V[j] = t / tn, W[j] = A V[j]; returns G's new column, the dots of
    V[:j+1] with W[j] (a (j+1, 1) tensor)."""
    torch.div(t, torch.where(tn > 0, tn, torch.ones_like(tn)), out=V[j])
    W[j] = op.mult(V[j])
    return panel_dots(V[: j + 1], W[j][None])


def _gd_cycle_body(op, dinv, V, W, G, j0: int, tgt: int, tol: float, gen, *,
                   ncv: int, which: str):
    eps_mach = float(torch.finfo(V.dtype).eps)
    big = 1.0 / eps_mach
    sign = -1.0 if which == "largest" else 1.0
    for j in range(j0, ncv):
        theta, Y = _ritz(G, j, which)
        # the target Ritz pair; past the active block (tgt >= j, only at a
        # cycle's first step after everything kept converged) the
        # reference's masked eigh gives a zero vector at +-1/eps
        y = Y[:, tgt: tgt + 1] if tgt < j else np.zeros((j, 1), G.dtype)
        th = float(theta[tgt]) if tgt < j else sign * big
        u = rotate(_mat(y, V), V[:j])[0]
        r = rotate(_mat(y, V), W[:j])[0] - th * u
        rn = torch.linalg.vector_norm(r)
        t, c = _orth_sweeps(V[:j], dinv * r, 2)
        tn = torch.linalg.vector_norm(t)
        g = _new_row(op, V, W, j, t, tn)
        host = _host(rn, torch.linalg.vector_norm(c), tn, g)
        rn, cn, tn_h = (float(a) for a in host[:3].real)
        # walk the target forward when the current pair converged
        if rn / max(abs(th), 1e-300) < tol:
            tgt = min(tgt + 1, ncv - 1)
        if tn_h < eps_mach * (cn + 1.0):
            # breakdown: a random direction, orthogonalized twice
            rnd = torch.randn(V.shape[1], generator=gen, dtype=V.dtype,
                              device=V.device)
            rnd = _orth_sweeps(V[:j], rnd, 2)[0]
            g = _new_row(op, V, W, j, rnd, torch.linalg.vector_norm(rnd))
            host = np.concatenate([host[:3], _host(g)])
        g = host[3:].astype(G.dtype)
        G[:, j] = 0
        G[: j + 1, j] = g
        G[j, :] = 0
        G[j, : j + 1] = g.conj()

    # cycle-end Rayleigh-Ritz and restart
    theta, Y = _ritz(G, ncv, which)
    Q = _mat(np.ascontiguousarray(Y), V)
    rotate(Q, V, out=V)
    rotate(Q, W, out=W)
    th_d = torch.from_numpy(theta.copy()).to(V.device, V.dtype)
    resid = _host(torch.linalg.vector_norm(W - th_d[:, None] * V, dim=1)).real
    errest = resid / np.maximum(np.abs(theta), 1e-300)
    k2 = int(np.sum(np.cumprod((errest < tol).astype(np.int64))))
    l = max(1, (ncv - k2) // 2)
    l = min(l, max(ncv - k2 - 1, 0))
    kl = min(k2 + l, ncv - 1)
    keep = (np.arange(ncv) < kl).astype(G.dtype)
    G = np.diag((theta * keep).astype(G.dtype))
    return V, W, G, kl, k2, theta, errest


def get_gd_hep_cycle(op, dinv, gen, ncv: int, which: str = "smallest"):
    """The GD cycle bound to (op, dinv); call as
    ``cycle(V, W, G, j0, tgt, tol)``.  Returns (V, W, G, j0_new, k2, theta,
    errest): V and W rotated in place, G the new host matrix, theta and
    errest (ncv,) numpy arrays in wanted-first order, k2 the count of
    leading converged pairs."""

    def cycle(V, W, G, j0, tgt, tol):
        return _gd_cycle_body(op, dinv, V, W, G, int(j0), int(tgt),
                              float(tol), gen, ncv=ncv, which=which)

    return cycle


def gd_hep_solve(eps, op, which: str) -> bool:
    """The GD cycles' host loop (standard HEP, Jacobi preconditioner from
    the operator's diagonal minus the target, whatever the ST, as in the
    reference).  Returns True when it ran; False sends the solve to the
    host loop (a complex operator, a ``which`` other than the ends)."""
    if which not in ("smallest", "largest"):
        return False
    if eps.A.dtype.is_complex:
        return False
    op = _prepare_fast_operator(op)
    dtype, device, n = eps.A.dtype, op.device, eps.n
    ncv = min(eps.ncv, n - 1)

    # Jacobi preconditioner diagonal 1/(diag(A) - sigma); ones for an
    # operator that has no diagonal to read
    sigma = float(np.real(eps.target)) if eps.target is not None else 0.0
    dvec = _op_diag(eps.A, n)
    if not bool((dvec != 0).any()):
        dinv = torch.ones(n, dtype=dtype, device=device)
    else:
        d = dvec.to(dtype) - sigma
        dinv = torch.where(d.abs() > 1e-12, 1.0 / d, torch.ones_like(d))

    rng = np.random.default_rng(0)
    v0 = rng.standard_normal(n)
    if eps.initial_space is not None:
        v0 = np.asarray(eps.initial_space[:, 0])
    np_dtype = _np_dtype(dtype)
    v0 = torch.from_numpy(v0.astype(np_dtype)).to(device)
    V = torch.zeros((ncv, n), dtype=dtype, device=device)
    W = torch.zeros_like(V)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    W[0] = op.mult(V[0])
    G = np.zeros((ncv, ncv), np_dtype)
    G[0, 0] = _host(torch.vdot(V[0], W[0]))[0].real

    gen = torch.Generator(device=device).manual_seed(777)
    cycle = get_gd_hep_cycle(op, dinv, gen, ncv, which)
    j0, k2 = 1, 0
    theta = errest = None
    while eps.its < eps.max_it:
        eps.its += 1
        eps.expansions += ncv - j0  # basis-growth steps of this cycle
        V, W, G, j0, k2, theta, errest = cycle(V, W, G, j0, k2, eps.tol)
        if len(eps.monitor):
            eps.monitor(eps, eps.its, k2, theta, errest)
        if eps.stopping is not None and eps.stopping(eps, eps.its, k2,
                                                     eps.nev):
            break
        if k2 >= eps.nev:
            break
    eps.nconv = k2
    lam = np.asarray(eps.st.back_transform(theta[:k2].astype(complex)))
    eps.eigenvalues = np.real(lam) if np.all(np.abs(np.imag(lam)) < 1e-13) \
        else np.real_if_close(lam)
    eps.errests = errest[:k2].copy()
    eps._eigenvectors = V[:k2].clone()
    eps.V = None
    return True
