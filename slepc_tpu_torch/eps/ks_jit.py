"""Krylov-Schur restart cycle for Hermitian problems
(``slepc_tpu/eps/ks_jit.py``).

One restart cycle = basis extension (SpMV + CGS2 per column), projected
eigh, convergence count, restart rotation.  PyTorch runs eagerly, so the
cycle is host-orchestrated: the SpMV (DIA kernel K1/K2 or CSR kernel K6,
or a shell operator's own ``mult``), the CGS2 sweeps (panel kernel K3) and
the rotation (kernel K4) run on the basis' device, and the host reads back one small vector per column (the projection
coefficients and the new column's norm) and solves the ncv x ncv projected
problem with LAPACK.

Layout: the basis is the row-major ``(ncv+1, n)`` tensor V, row k is basis
vector k, so every row is contiguous and the leading rows V[:j+1] that a
column is orthogonalized against are one contiguous prefix (the transposed
basis of the reference, ks_jit.py:26-30).  V is updated in place; the
projected matrix H is a host numpy array.

Restart (thick restart): keep kl = k2 + (ncv - k2)/keep_den leading Ritz
vectors, arrow row beta * Q[last, :] -- the reference's DSTruncate +
BVMultInPlace.  Soft locking by construction: locked Ritz pairs stay in the
projected matrix with zero residual coupling.

Ported: full reorthogonalization (CGS2) and the exact f64/f32 rotation; the
reference's ``rot_mode`` "exact" and "ds" are the same native-precision K4
path here.  The partial/selective/periodic reorthogonalization modes, the
blocked cycle and the mixed/hybrid rotations are still to be ported and
raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mat.linop import AIJOperator
from ..ops.bv import panel_dots, panel_update, panel_update_dots
from ..ops.rotate import rotate
from ..sys.events import log_event

_TODO_REORTH = ("reorth={!r} is not ported yet; only 'full' (CGS2) is "
                "(ROADMAP.md, queue 1, 'Krylov-Schur cycle remainder')")
_TODO_ROT = ("rot_mode={!r} is not ported (f32-plane rotations); every "
             "rotation of the port is the native-precision kernel K4, "
             "rot_mode 'exact' or 'ds' (ROADMAP.md, queue 1, 'Krylov-Schur "
             "cycle remainder')")
_TODO_BLOCK = ("the blocked Krylov-Schur cycle is not ported yet (ROADMAP.md, "
               "queue 2, K5)")


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _check_modes(reorth: str, rot_mode: str) -> None:
    if reorth not in ("full", "delayed"):
        raise NotImplementedError(_TODO_REORTH.format(reorth))
    if rot_mode not in ("exact", "ds"):
        raise NotImplementedError(_TODO_ROT.format(rot_mode))


def _orth_sweeps(Vact, w, passes: int):
    """CGS with ``passes`` sweeps against the rows of Vact: dots, then
    (passes - 1) fused update+dots, then the last update -- three basis
    reads per CGS2 column (bvorthog.c:91-132 single-reduction semantics).
    Returns (w orthogonalized, summed coefficients)."""
    wp = w[None]
    c = panel_dots(Vact, wp)
    c_tot = c.clone()
    for _ in range(passes - 1):
        wp, c = panel_update_dots(Vact, c, wp)
        c_tot += c
    wp = panel_update(Vact, c, wp)
    return wp[0], c_tot[:, 0]


def _hep_extend_body(op, V, H, j0: int, jend: int, gen, *, ncv: int,
                     passes: int = 2):
    """Extend columns [j0, jend) with full CGS2 (in place on V and H)."""
    rdtype = V.dtype
    eps_mach = float(torch.finfo(rdtype).eps)
    for j in range(j0, jend):
        w = op.mult(V[j])
        Vact = V[: j + 1]
        w, c_tot = _orth_sweeps(Vact, w, passes)
        # one host read per column: coefficients and the new column norm
        host = torch.cat([c_tot, torch.linalg.vector_norm(w)[None]]).cpu() \
            .numpy().astype(np.float64)
        c_np, beta = host[:-1], float(host[-1])
        is_brk = beta < eps_mach ** 0.75 * (float(np.linalg.norm(c_np))
                                            + eps_mach)
        beta_eff = beta
        if is_brk:
            # breakdown -> deterministic random restart direction
            # (krylovschur.c:298-307 role), orthogonalized twice
            rnd = torch.randn(V.shape[1], generator=gen, dtype=rdtype,
                              device=V.device)
            for _ in range(2):
                rnd = panel_update(Vact, panel_dots(Vact, rnd[None]),
                                   rnd[None])[0]
            w = rnd
            beta_eff = float(torch.linalg.vector_norm(w))
        torch.div(w, beta_eff if beta_eff > 0 else 1.0, out=V[j + 1])
        H[:, j] = 0
        H[: j + 1, j] = c_np
        H[j + 1, j] = 0.0 if is_brk else beta
    return V, H


def _projected_solve(H, ncv: int, which: str):
    beta = float(abs(H[ncv, ncv - 1]))
    S = H[:ncv, :ncv]
    S = 0.5 * (S + S.T)
    theta, Q = np.linalg.eigh(S)  # LAPACK, ascending (the eigh_small role)
    if which == "largest":
        theta, Q = theta[::-1], Q[:, ::-1]
    elif which == "largest_magnitude":
        order = np.argsort(-np.abs(theta))
        theta, Q = theta[order], Q[:, order]
    return theta, Q, beta


def _restart_sizes(k2: int, ncv: int, keep_den: int, nrot: int):
    nro = nrot if (nrot and nrot < ncv) else ncv
    k2 = min(k2, nro - 1)
    l = max(1, (ncv - k2) // keep_den)
    l = min(l, max(ncv - k2 - 1, 0))
    kl = min(k2 + l, nro - 1)
    return k2, kl, nro


def _hep_rotate_body(V, Q: np.ndarray, kl: int, *, ncv: int):
    """Restart rotation V[:P] = Q^T V[:ncv] (kernel K4 into a separate
    buffer, then copied back) and the residual-row move V[kl] = V[ncv]."""
    Qt = torch.from_numpy(np.ascontiguousarray(Q)).to(V.device, V.dtype)
    Vrot = rotate(Qt, V[:ncv])
    V[: Q.shape[1]].copy_(Vrot)
    del Vrot
    V[kl].copy_(V[ncv])
    return V


def _hep_finish_body(V, H, tol: float, *, ncv: int, which: str,
                     keep_den: int = 2, nrot: int = 0):
    """Projected solve + convergence + restart rotation + H rebuild."""
    theta, Q, beta = _projected_solve(H, ncv, which)
    last = Q[ncv - 1, :]
    errest = beta * np.abs(last) / np.maximum(np.abs(theta), 1e-300)
    conv = errest < tol
    k2 = int(np.sum(np.cumprod(conv.astype(np.int64))))
    k2, kl, nro = _restart_sizes(k2, ncv, keep_den, nrot)
    V = _hep_rotate_body(V, Q[:, :nro], kl, ncv=ncv)
    keep = (np.arange(ncv) < kl).astype(H.dtype)
    Hnew = np.zeros_like(H)
    Hnew[np.arange(ncv), np.arange(ncv)] = theta.astype(H.dtype) * keep
    Hnew[kl, :] = (beta * last).astype(H.dtype) * keep
    return V, Hnew, kl, k2, theta, errest, beta


def _hep_cycle_body(op, V, H, j0: int, tol: float, gen, *, ncv: int,
                    which: str, passes: int = 2, keep_den: int = 2,
                    nrot: int = 0):
    V, H = _hep_extend_body(op, V, H, j0, ncv, gen, ncv=ncv, passes=passes)
    return _hep_finish_body(V, H, tol, ncv=ncv, which=which,
                            keep_den=keep_den, nrot=nrot)


def ks_hep_cycle(op, V, H, j0, tol, gen, ncv: int, which: str = "smallest",
                 passes: int = 2, reorth: str = "full",
                 keep_den: int = 2, rot_mode: str = "exact", nrot: int = 0):
    """One Krylov-Schur(HEP) restart cycle.

    Args:
      op:  Hermitian operator with ``mult`` on V's device.
      V:   (ncv+1, n) row-major basis, updated in place; rows [0, j0)
           orthonormal, row j0 = start vector (normalized).
      H:   (ncv+1, ncv) host numpy projected coefficients (diag + arrow
           after restart).
      j0:  extension starts here.
      tol: relative tolerance.
      gen: ``torch.Generator`` on V's device for breakdown restarts.
      which: 'smallest' | 'largest' | 'largest_magnitude'.
    Returns:
      (V, H, j0_new, k2, theta, errest, beta); theta and errest are (ncv,)
      numpy arrays in wanted-first order, k2 the count of leading converged
      Ritz pairs.
    """
    _check_modes(reorth, rot_mode)
    return _hep_cycle_body(op, V, H, int(j0), float(tol), gen,
                           ncv=ncv, which=which, passes=passes,
                           keep_den=keep_den, nrot=nrot)


def get_ks_hep_cycle(op, gen, ncv: int, which: str = "smallest",
                     passes: int = 2, reorth: str = "full",
                     keep_den: int = 2, rot_mode: str = "exact",
                     nrot: int = 0):
    """Restart cycle bound to ``op``; call as ``cycle(V, H, j0, tol)``."""
    _check_modes(reorth, rot_mode)

    def cycle(V, H, j0, tol):
        return ks_hep_cycle(op, V, H, j0, tol, gen, ncv=ncv, which=which,
                            passes=passes, reorth=reorth,
                            keep_den=keep_den, rot_mode=rot_mode, nrot=nrot)

    return cycle


def _prepare_fast_operator(op):
    """The operator form the cycle runs (reference ``_prepare_fast_operator``,
    ks_jit.py:1042-1115): an AIJ operator goes to its routed form (a DIA
    operator on K1/K2 when it is a few dense diagonals, else CSR on K6);
    a DIA operator, or any other operator with a ``mult`` on its device,
    runs as it is.  Vectors stay flat (n,): there is no padded layout."""
    if isinstance(op, AIJOperator):
        return op.fast_form()
    return op


def ks_hep_solve(eps, op, which: str) -> None:
    """Host loop over restart cycles; fills the EPS result fields."""
    ncv = eps.ncv
    op = _prepare_fast_operator(op)
    dtype = op.dtype
    if int(eps.block_size) > 1:
        raise NotImplementedError(_TODO_BLOCK)

    # Chebyshev-amplified smallest-end path (eps.cheb_degree > 0): the
    # monotone low-end filter turns badly-separated smallest eigenvalues
    # into well-separated largest ones (eps/cheb_accel.py)
    cheb_deg = int(eps.cheb_degree or 0)
    if cheb_deg > 0 and which == "smallest":
        from .cheb_accel import ks_cheb_smallest

        if int(eps.cheb_block) > 1:
            raise NotImplementedError(_TODO_BLOCK)
        res = ks_cheb_smallest(
            op, nev=eps.nev, tol=eps.tol, ncv=ncv, degree=cheb_deg,
            reorth=eps.cheb_reorth, rot_mode=eps.cheb_rot_mode,
            keep_den=int(eps.cheb_keep_den), budget_s=eps.cheb_budget_s)
        k = int(res["nconv"])
        eps.nconv = k
        eps.its = res["stats"]["cycles"]
        eps.cheb_stats = res["stats"]
        eps.eigenvalues = np.array(res["lam"][:k], copy=True)
        eps.errests = np.array(res["resid"][:k], copy=True)
        eps._eigenvectors = res["X"][:k]
        return

    rmode = eps.reorth
    _check_modes(rmode, eps.rot_mode)
    # start vector: seeded numpy normal, normalized by a host QR
    # (identical to the reference's _init_rows, so both packages start the
    # plain cycle from the same vector)
    c = np.random.default_rng(0).standard_normal(eps.n)
    Qm, _ = np.linalg.qr(c[:, None].astype(_np_dtype(dtype)))
    V = torch.zeros((ncv + 1, eps.n), dtype=dtype, device=op.device)
    V[0] = torch.from_numpy(np.ascontiguousarray(Qm[:, 0])).to(op.device)
    H = np.zeros((ncv + 1, ncv), dtype=_np_dtype(dtype))
    gen = torch.Generator(device=op.device).manual_seed(12345)
    cycle_fn = get_ks_hep_cycle(op, gen, ncv, which, reorth=rmode,
                                rot_mode=eps.rot_mode)
    j0, k2 = 0, 0
    theta = errest = None
    n = eps.n
    while eps.its < eps.max_it:
        eps.its += 1
        with log_event("EPS_KSCycle",
                       flops=ncv * (2.0 * op.nnz + 8.0 * n * ncv)):
            V, H, j0, k2, theta, errest, beta = cycle_fn(V, H, j0, eps.tol)
        if len(eps.monitor):
            eps.monitor(eps, eps.its, k2, theta, errest)
        if eps.stopping is not None and eps.stopping(eps, eps.its, k2,
                                                     eps.nev):
            break
        if k2 >= eps.nev:
            break
    eps.nconv = k2
    eps.eigenvalues = eps.st.back_transform(theta[:k2].astype(np.float64))
    eps.errests = errest[:k2].copy()
    eps._eigenvectors = V[:k2].clone()
