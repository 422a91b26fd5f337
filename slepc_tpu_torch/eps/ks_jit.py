"""Krylov-Schur restart cycle for Hermitian problems
(``slepc_tpu/eps/ks_jit.py``).

One restart cycle = basis extension (SpMV + orthogonalization per column),
projected eigh, convergence count, restart rotation.  PyTorch runs eagerly,
so the cycle is host-orchestrated: the SpMV (DIA kernel K1/K2 or CSR kernel
K6, or a shell operator's own ``mult``), the CGS panel sweeps (kernel K3)
and the rotation (kernel K4) run on the basis' device, and the host reads
back one small vector per column (the projection coefficients and the new
column's norm) and solves the ncv x ncv projected problem with LAPACK.

Layout: the basis is the row-major ``(ncv+1, n)`` tensor V, row k is basis
vector k, so every row is contiguous and the leading rows V[:j+1] that a
column is orthogonalized against are one contiguous prefix (the transposed
basis of the reference, ks_jit.py:26-30).  V is updated in place; the
projected matrix H is a host numpy array.

Restart (thick restart): keep kl = k2 + (ncv - k2)/keep_den leading Ritz
vectors, arrow row beta * Q[last, :] -- the reference's DSTruncate +
BVMultInPlace.  Soft locking by construction: locked Ritz pairs stay in the
projected matrix with zero residual coupling.

Orthogonalization of the single-column extension (``reorth``):
  * "full": CGS2 against every basis row, every column;
  * "partial": Simon's omega monitor -- a local CGS2 against the two
    previous rows, and a full CGS2 only when the omega recurrence (run on
    the host from H) estimates that the new column has drifted past
    sqrt(eps)/sqrt(ncv), when the previous column tripped, or at the first
    column of the cycle; a second host read only when a full sweep fires;
  * "selective" (with ``nsel`` > 0): the local rows plus the leading
    locked rows;
  * ``reorth_period`` > 1: a full sweep every period-th column, local
    otherwise.

The blocked cycle (:func:`ks_hep_cycle_blocked`, block size b): b columns
per step through the block SpMV (``mult_block``, kernel K5 for a DIA
operator), branch-free BCGS2 (three K3 sweeps at panel width b), and an
SVQB^2 orthonormalization of the b new columns whose two factors come from
the b x b Gram matrix on the host; the combine runs on K4.

The reference's ``rot_mode`` "exact" and "ds" are the same native-precision
K4 path here; "mixed"/"hybrid" (f32-plane rotations) are not ported.

On a row mesh (``sys/mesh.py``) the basis rows are each rank's slab rows
(``parallel/halo.py``) and every reduction over them -- each CGS2 sweep's
coefficients, each norm, the blocked step's Gram matrices -- goes through
``mesh.allreduce``: three all-reduces per column of the plain cycle (the
two sweeps' coefficients and the norm), five per block step.  The host
then reads the same reduced numbers on every rank, so every rank takes the
same decisions.  Without a mesh the helper is the identity.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mat.linop import AIJOperator, DIAOperator, LinearOperator
from ..ops.bv import panel_dots, panel_update, panel_update_dots
from ..ops.rotate import rotate
from ..sys.events import log_event
from ..sys.mesh import (allreduce, clear_halos, combine_norms, get_mesh,
                        reduces_over_op, shard_operator,
                        vector_norm)

_TODO_ROT = ("rot_mode={!r} is not ported (f32-plane rotations); every "
             "rotation of the port is the native-precision kernel K4, "
             "rot_mode 'exact' or 'ds' (ROADMAP.md, queue 1, 'Krylov-Schur "
             "cycle remainder')")


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _check_rot_mode(rot_mode: str) -> None:
    if rot_mode not in ("exact", "ds"):
        raise NotImplementedError(_TODO_ROT.format(rot_mode))


def _host(*tensors) -> np.ndarray:
    """One device-to-host read of several small tensors, flattened, f64 (or
    complex128 when one of them is complex: the CGS2 coefficients of a
    complex basis keep their imaginary parts)."""
    a = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def _mat(M, V):
    """A host matrix as the Q argument of :func:`rotate` on V's device."""
    return torch.from_numpy(np.ascontiguousarray(M)).to(V.device, V.dtype)


def _sweep_bytes(Vact, b: int, writes: bool) -> int:
    """Bytes of one K3 sweep of b rows against the rows of Vact, as the
    ``bytes`` count of a ``BV_Orthogonalize`` span has them: the basis rows
    and the b rows read once, and the b output rows written once (an update;
    the dots write only their small coefficients)."""
    rows = Vact.shape[0] + (2 * b if writes else b)
    return rows * Vact.shape[1] * Vact.element_size()


def _rotate_bytes(Q, V) -> int:
    """Bytes of one K4 call out = Q^T V (Q a host or device matrix): the
    rows of V read once and the Q.shape[1] output rows written once."""
    return (V.shape[0] + Q.shape[1]) * V.shape[1] * V.element_size()


def _orth_sweeps(Vact, w, passes: int, span=None):
    """CGS with ``passes`` sweeps against the rows of Vact: dots, then
    (passes - 1) fused update+dots, then the last update -- three basis
    reads per CGS2 column (bvorthog.c:91-132 single-reduction semantics).
    Their bytes go to ``span``'s count.  Returns (w orthogonalized, summed
    coefficients)."""
    if span is not None:  # logging on
        span["bytes"] += (_sweep_bytes(Vact, 1, False)
                          + passes * _sweep_bytes(Vact, 1, True))
    wp = w[None]
    c = allreduce(panel_dots(Vact, wp))
    c_tot = c.clone()
    for _ in range(passes - 1):
        wp, c = panel_update_dots(Vact, c, wp)
        c = allreduce(c)
        c_tot += c
    wp = panel_update(Vact, c, wp)
    return wp[0], c_tot[:, 0]


class _OmegaMonitor:
    """Simon's omega recurrence (reference ks_jit.py:461-518), on the host.

    ``cur[k]`` estimates |v_j . v_k|; one step predicts the drift of the new
    column v_{j+1} from H's alpha/beta entries and says whether a full
    sweep must fire.  Computed in H's dtype, as the reference does."""

    def __init__(self, ncv: int, dtype, eps_mach: float):
        dtype = np.finfo(dtype).dtype  # the real type of a complex H
        self.dtype = dtype
        self.eps = eps_mach
        sq0 = np.sqrt(eps_mach)  # the restarted block's pairwise drift
        self.prev = np.full(ncv + 1, sq0, dtype)
        self.cur = self.prev.copy()
        self.force = False
        self.thresh = np.sqrt(eps_mach) / np.sqrt(ncv)

    def need_full(self, H, j: int, j0: int, alpha_j: float,
                  beta_loc: float) -> bool:
        dt = self.dtype
        ncv = H.shape[1]
        ar = np.arange(ncv)
        # the diagonal and off-diagonal taken real, as the reference does
        # for a complex H (slepc_tpu/eps/ks_jit.py:464-466)
        alpha = H[ar, ar].real
        betav = H[ar + 1, ar].real
        alpha_j, beta_loc = dt.type(np.real(alpha_j)), dt.type(beta_loc)
        beta_jm1 = betav[j - 1] if j > 0 else dt.type(0)
        anorm = max(np.abs(alpha).max(), abs(alpha_j)) \
            + 2 * max(betav.max(), beta_loc)
        bsafe = beta_loc if beta_loc > 0 else dt.type(1)
        # roundoff term in omega units (eps * anorm enters before the
        # division by beta)
        psi = dt.type(self.eps) * anorm / bsafe
        z = np.zeros(1, dt)
        om = self.cur
        nxt = (np.concatenate([betav, z]) * np.concatenate([om[1:], z])
               + (np.concatenate([alpha, z]) - alpha_j) * om
               + np.concatenate([z, betav]) * np.concatenate([z, om[:-1]])
               - beta_jm1 * self.prev) / bsafe
        nxt = np.minimum(np.abs(nxt) + psi, dt.type(1))
        kmask = (np.arange(ncv + 1) < j).astype(dt)
        nxt = nxt * kmask
        psi_c = min(psi, dt.type(1))
        nxt[j] = psi_c
        tripped = bool(nxt.max() > self.thresh)
        need = tripped or self.force or j == j0
        if need:  # the new column is orthogonal to eps level after a sweep
            nxt = psi_c * kmask
            nxt[j] = psi_c
        self.prev, self.cur, self.force = self.cur, nxt, tripped
        return need


def _finish_column(V, H, j: int, w, c_np: np.ndarray, beta: float, gen,
                   eps_mach: float) -> None:
    """Breakdown check, V[j+1] = w / beta and H column j."""
    is_brk = beta < eps_mach ** 0.75 * (float(np.linalg.norm(c_np))
                                        + eps_mach)
    beta_eff = beta
    if is_brk:
        # breakdown -> deterministic random restart direction
        # (krylovschur.c:298-307 role), orthogonalized twice
        Vact = V[: j + 1]
        rnd = clear_halos(torch.randn(V.shape[1], generator=gen,
                                      dtype=V.dtype, device=V.device))
        for _ in range(2):
            rnd = panel_update(Vact, allreduce(panel_dots(Vact, rnd[None])),
                               rnd[None])[0]
        w = rnd
        beta_eff = float(vector_norm(w))
    torch.div(w, beta_eff if beta_eff > 0 else 1.0, out=V[j + 1])
    H[:, j] = 0
    H[: j + 1, j] = c_np
    H[j + 1, j] = 0.0 if is_brk else beta


def _hep_extend_body(op, V, H, j0: int, jend: int, gen, *, ncv: int,
                     passes: int = 2, reorth: str = "full",
                     reorth_period: int = 1, nsel: int = 0, nlock: int = 0):
    """Extend columns [j0, jend) (in place on V and H), orthogonalizing
    each new column as ``reorth`` says (module docstring)."""
    eps_mach = float(torch.finfo(V.dtype).eps)
    monitor = _OmegaMonitor(ncv, H.dtype, eps_mach) \
        if reorth == "partial" else None
    selective = reorth == "selective" and nsel > 0
    for j in range(j0, jend):
        w = op.mult(V[j])
        lo = max(j - 1, 0)
        Vloc = V[lo: j + 1]  # the local rows v_{j-1}, v_j
        c_np = np.zeros(j + 1, H.dtype)
        # the column's sweeps and host reads (bytes: _sweep_bytes)
        with log_event("BV_Orthogonalize", bytes=0) as span:
            if monitor is not None:
                w, cl = _orth_sweeps(Vloc, w, 2, span)
                host = _host(cl, vector_norm(w))
                c_np[lo:], beta = host[:-1], float(host[-1].real)
                if monitor.need_full(H, j, j0, c_np[j], beta):
                    w, cf = _orth_sweeps(V[: j + 1], w, passes, span)
                    host = _host(cf, vector_norm(w))
                    c_np += host[:-1]
                    beta = float(host[-1].real)
            elif selective:
                # local rows, then the locked rows below them, twice
                # (reference ks_jit.py:529-553)
                nsl = min(nsel, nlock, max(j - 1, 0))
                cl_tot = torch.zeros(j + 1 - lo, dtype=V.dtype,
                                     device=V.device)
                cs_tot = torch.zeros(nsl, dtype=V.dtype, device=V.device)
                for _ in range(2):
                    if span is not None:
                        span["bytes"] += (_sweep_bytes(Vloc, 1, False)
                                          + _sweep_bytes(Vloc, 1, True))
                    cl = allreduce(panel_dots(Vloc, w[None]))
                    w = panel_update(Vloc, cl, w[None])[0]
                    cl_tot += cl[:, 0]
                    if nsl:
                        if span is not None:
                            span["bytes"] += (
                                _sweep_bytes(V[:nsl], 1, False)
                                + _sweep_bytes(V[:nsl], 1, True))
                        cs = allreduce(panel_dots(V[:nsl], w[None]))
                        w = panel_update(V[:nsl], cs, w[None])[0]
                        cs_tot += cs[:, 0]
                host = _host(cl_tot, cs_tot, vector_norm(w))
                c_np[lo:] = host[: j + 1 - lo]
                c_np[:nsl] += host[j + 1 - lo: -1]
                beta = float(host[-1].real)
            else:
                local = (reorth_period > 1 and j % reorth_period != 0
                         and j != j0)
                w, ct = _orth_sweeps(Vloc if local else V[: j + 1], w,
                                     2 if local else passes, span)
                host = _host(ct, vector_norm(w))
                c_np[lo if local else 0:] = host[:-1]
                beta = float(host[-1].real)
        _finish_column(V, H, j, w, c_np, beta, gen, eps_mach)
    return V, H


def _projected_solve(H, ncv: int, which: str):
    beta = float(abs(H[ncv, ncv - 1]))
    S = H[:ncv, :ncv]
    S = 0.5 * (S + S.conj().T)
    with log_event("DS_Solve", flops=9.0 * ncv ** 3):
        theta, Q = np.linalg.eigh(S)  # LAPACK, ascending (eigh_small role)
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


def _hep_rotate_body(V, Q: np.ndarray, kl: int, *, ncv: int, nres: int = 1):
    """Restart rotation V[:P] = Q^T V[:ncv] (kernel K4, in place: a block
    reads all ncv rows of its columns before it stores any) and the
    residual-row move V[kl:kl+nres] = V[ncv:ncv+nres] (nres = b rows in the
    blocked cycle); the rotation is the span ``BV_MultInPlace`` (bytes:
    :func:`_rotate_bytes`)."""
    with log_event("BV_MultInPlace") as span:
        if span is not None:
            span["bytes"] = _rotate_bytes(Q, V[:ncv])
        rotate(_mat(Q, V), V[:ncv], out=V[: Q.shape[1]])
    V[kl: kl + nres].copy_(V[ncv: ncv + nres])
    return V


def _hep_finish_body(V, H, tol: float, *, ncv: int, which: str,
                     keep_den: int = 2, nrot: int = 0, confirm=None):
    """Projected solve + convergence + restart rotation + H rebuild.
    ``confirm(V, Q, theta, errest, tol)``: the leading candidates' errest
    replaced by a residual on the original problem
    (:func:`_true_residual_confirm`)."""
    theta, Q, beta = _projected_solve(H, ncv, which)
    last = Q[ncv - 1, :]
    errest = beta * np.abs(last) / np.maximum(np.abs(theta), 1e-300)
    if confirm is not None:
        errest = confirm(V, Q, theta, errest, tol)
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
                    nrot: int = 0, reorth: str = "full",
                    reorth_period: int = 1, nsel: int = 0, nlock: int = 0,
                    confirm=None):
    V, H = _hep_extend_body(op, V, H, j0, ncv, gen, ncv=ncv, passes=passes,
                            reorth=reorth, reorth_period=reorth_period,
                            nsel=nsel, nlock=nlock)
    return _hep_finish_body(V, H, tol, ncv=ncv, which=which,
                            keep_den=keep_den, nrot=nrot, confirm=confirm)


@reduces_over_op
def ks_hep_cycle(op, V, H, j0, tol, gen, ncv: int, which: str = "smallest",
                 passes: int = 2, reorth: str = "full",
                 keep_den: int = 2, rot_mode: str = "exact", nrot: int = 0,
                 reorth_period: int = 1, nlock: int = 0, nsel: int = 0,
                 confirm=None):
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
      reorth, reorth_period, nsel, nlock: the extension's orthogonalization
           (module docstring); nlock = count of locked leading rows.
      confirm: None, or the true-residual check of the candidates
           (:func:`_true_residual_confirm`).
    Returns:
      (V, H, j0_new, k2, theta, errest, beta); theta and errest are (ncv,)
      numpy arrays in wanted-first order, k2 the count of leading converged
      Ritz pairs.
    """
    _check_rot_mode(rot_mode)
    return _hep_cycle_body(op, V, H, int(j0), float(tol), gen,
                           ncv=ncv, which=which, passes=passes,
                           keep_den=keep_den, nrot=nrot, reorth=reorth,
                           reorth_period=reorth_period, nsel=nsel,
                           nlock=int(nlock), confirm=confirm)


def get_ks_hep_cycle(op, gen, ncv: int, which: str = "smallest",
                     passes: int = 2, reorth: str = "full",
                     keep_den: int = 2, rot_mode: str = "exact",
                     nrot: int = 0, reorth_period: int = 1, nsel: int = 0,
                     confirm=None):
    """Restart cycle bound to ``op``; call as
    ``cycle(V, H, j0, tol, nlock=0)``."""
    _check_rot_mode(rot_mode)

    def cycle(V, H, j0, tol, nlock=0):
        return ks_hep_cycle(op, V, H, j0, tol, gen, ncv=ncv, which=which,
                            passes=passes, reorth=reorth,
                            keep_den=keep_den, rot_mode=rot_mode, nrot=nrot,
                            reorth_period=reorth_period, nlock=nlock,
                            nsel=nsel, confirm=confirm)

    return cycle


# ---- the blocked cycle (reference ks_jit.py:811-1030) --------------------

def _svqb(G, eps_mach: float):
    """Clamped SVQB factors of the Gram matrix G[r, i] = <W[r], W[i]> of b
    rows W (Hermitian for a complex basis), with the diagonal scaling of
    SLEPc's SVQB (bvorthog.c): (inv, half) with X = inv W orthonormal and
    W = half X exactly.  With Gs = G / (g g^T) = U diag(lam) U^H, inv =
    (U lam^-1/2 U^H)^T diag(1/g) and half its inverse, both written as
    conj(U) f(lam) U^T, which is the real formula for a real U.  The
    scaling keeps the factors accurate when the rows of W differ in norm by
    many orders (a filtered block does: converged rows leave residuals near
    1 beside others near 1e6)."""
    g = np.sqrt(np.maximum(np.real(np.diag(G)), 0.0))
    g[g == 0] = 1.0
    lam, U = _gram_eigh(G / np.outer(g, g))
    lam_c = np.maximum(lam, eps_mach ** 2 * max(lam[-1], eps_mach))
    inv = (U.conj() * lam_c ** -0.5) @ U.T / g[None, :]
    half = g[:, None] * ((U.conj() * lam_c ** 0.5) @ U.T)
    return inv, half


def _gram_eigh(G):
    return np.linalg.eigh(0.5 * (G + G.conj().T))


def _block_step(op_blk, V, H, p: int, b: int, gen, eps_mach: float) -> None:
    """Block step p (in place on V and H): the b columns V[p*b:(p+1)*b]
    through the block SpMV, branch-free BCGS2 against Vact = V[:(p+1)*b]
    (three K3 sweeps), then SVQB^2 of the result into V[(p+1)*b:(p+2)*b].

    SVQB^2, as the reference (ks_jit.py:964-980) with three repairs that a
    filtered block at high degree needs (its rows span ~1e12 in norm):
      X1 = inv1 Wb from the diagonally scaled Gram of Wb, so Wb = half1 X1
      exactly;
      X1 -= P^T Vact, one more CGS pass against the basis (inv1 amplifies
      the rounding that BCGS2 left along Vact in Wb's weak directions);
      X2 = inv2 X1 from the Gram of that X1, measured on the device (the
      reference computed it as inv1 G inv1, which cannot see the rounding
      the first factor amplified).  A direction that collapses there (a
      rank-deficient block) is refilled with a random direction
      orthogonalized against Vact; its coupling is at rounding level.
    The H column block is [C + P half1^T; (half1 half2)^T], from
    Wb = (C + P half1^T)^T Vact + (half1 half2) X2 (the reference stores
    half1 half2 untransposed).  Two host reads per step.

    A complex basis (a complex Hermitian operator) runs the same step: K3c's
    dots conjugate the basis (C[k, i] = <Vact[k], Wb[i]>), the Gram matrices
    are Hermitian, K4c applies inv^T unconjugated (out[p] = sum_k Q[k, p]
    V[k]), and H is Hermitian with the same plain transposes."""
    m = (p + 1) * b
    Vact = V[:m]
    Wb = op_blk(V[p * b: m])
    # BCGS2 + SVQB^2 of the block product (bytes: _sweep_bytes and
    # _rotate_bytes of each K3 and K4 call)
    with log_event("BV_Orthogonalize", bytes=0) as span:
        # BCGS2: dots, update+dots, update; then Wb's Gram
        if span is not None:
            span["bytes"] += (_sweep_bytes(Vact, b, False)
                              + 2 * _sweep_bytes(Vact, b, True)
                              + _sweep_bytes(Wb, b, False))
        C1 = allreduce(panel_dots(Vact, Wb))
        Wb, C2 = panel_update_dots(Vact, C1, Wb)
        Wb = panel_update(Vact, allreduce(C2), Wb)
        host = _host(C1 + C2, allreduce(panel_dots(Wb, Wb)))
        C, G = host[: m * b].reshape(m, b), host[m * b:].reshape(b, b)
        inv1, half1 = _svqb(G, eps_mach)
        # X = inv1 Wb, one more CGS pass, X's Gram
        if span is not None:
            span["bytes"] += (_rotate_bytes(inv1.T, Wb)
                              + _sweep_bytes(Vact, b, False)
                              + _sweep_bytes(Vact, b, True)
                              + _sweep_bytes(Wb, b, False))
        X = rotate(_mat(inv1.T, V), Wb)
        P = allreduce(panel_dots(Vact, X))
        X = panel_update(Vact, P, X)
        host = _host(P, allreduce(panel_dots(X, X)))
        P, G1 = host[: m * b].reshape(m, b), host[m * b:].reshape(b, b)
        lam1, U1 = _gram_eigh(G1)
        dead = lam1 < 1e-2  # live directions of X have norms near 1
        if dead.any():
            # complex normals from the seeded generator for a complex basis;
            # the refill X += R z^H along each dead direction z of G1
            R = clear_halos(torch.randn((int(dead.sum()), V.shape[1]),
                                        generator=gen, dtype=V.dtype,
                                        device=V.device))
            R /= vector_norm(R, dim=1)[:, None]
            if span is not None:
                span["bytes"] += (_rotate_bytes(U1[:, dead].conj().T, R)
                                  + 2 * (_sweep_bytes(Vact, b, False)
                                         + _sweep_bytes(Vact, b, True))
                                  + _sweep_bytes(X, b, False))
            X += rotate(_mat(U1[:, dead].conj().T, V), R)
            for _ in range(2):
                X = panel_update(Vact, allreduce(panel_dots(Vact, X)), X)
            G1 = _host(allreduce(panel_dots(X, X))).reshape(b, b)
        inv2, half2 = _svqb(G1, eps_mach)
        if span is not None:
            span["bytes"] += _rotate_bytes(inv2.T, X)
        rotate(_mat(inv2.T, V), X, out=V[m: m + b])
    H[:, p * b: m] = 0
    H[:m, p * b: m] = C + P @ half1.T
    # Wb = (half1 half2) X2 + ..., so H[m + r, p*b + i] = <X2[r], Wb[i]> =
    # (half1 half2)[i, r]: a plain transpose for a complex basis too, since
    # H[k, j] = <V[k], A V[j]> holds the coefficients of A V[j]
    H[m: m + b, p * b: m] = (half1 @ half2).T


def _hep_cycle_blocked_body(op, V, H, jb0: int, tol: float, gen, *,
                            ncv: int, b: int, which: str, confirm=None):
    if ncv % b:
        raise ValueError(f"ncv={ncv} must be a multiple of the block {b}")
    eps_mach = float(torch.finfo(V.dtype).eps)
    op_blk = LinearOperator.block_of(op)
    for p in range(jb0, ncv // b):
        _block_step(op_blk, V, H, p, b, gen, eps_mach)

    theta, Q, _ = _projected_solve(H, ncv, which)
    # convergence: residual of Ritz pair p = ||B_last Q[ncv-b:, p]||
    Blast = H[ncv: ncv + b, ncv - b: ncv]
    Rq = Blast @ Q[ncv - b:, :]
    errest = np.linalg.norm(Rq, axis=0) / np.maximum(np.abs(theta), 1e-300)
    if confirm is not None:
        errest = confirm(V, Q, theta, errest, tol)
    k2 = int(np.sum(np.cumprod((errest < tol).astype(np.int64))))
    # restart: keep kl rows, block aligned
    kl = k2 + max(1, (ncv - k2) // 2)
    kl = max(min(-(-kl // b) * b, ncv - b), b)
    V = _hep_rotate_body(V, Q, kl, ncv=ncv, nres=b)
    keep = (np.arange(ncv) < kl).astype(H.dtype)
    Hnew = np.zeros_like(H)
    Hnew[np.arange(ncv), np.arange(ncv)] = theta.astype(H.dtype) * keep
    Hnew[kl: kl + b, :] = Rq.astype(H.dtype) * keep[None, :]
    return V, Hnew, kl // b, k2, theta, errest, float(np.linalg.norm(Blast))


@reduces_over_op
def ks_hep_cycle_blocked(op, V, H, jb0, tol, gen, ncv: int, b: int,
                         which: str = "smallest", confirm=None):
    """One BLOCK Krylov-Schur(HEP) restart cycle (thick-restart block
    Lanczos, block size b <= 8): per block step the basis is read three
    times for all b new columns instead of three times per column.

    V is (ncv+b, n), ncv % b == 0, updated in place; H is the host
    (ncv+b, ncv) projected matrix plus the trailing block-coupling rows;
    extension starts at block jb0, whose rows [jb0*b, jb0*b+b) must hold
    an orthonormal block.  Returns (V, H, jb_new, k2, theta, errest, beta)
    with jb_new in block units and beta = ||B_last||_F."""
    return _hep_cycle_blocked_body(op, V, H, int(jb0), float(tol), gen,
                                   ncv=ncv, b=b, which=which, confirm=confirm)


def get_ks_hep_cycle_blocked(op, gen, ncv: int, b: int,
                             which: str = "smallest", confirm=None):
    """Blocked restart cycle bound to ``op``; call as
    ``cycle(V, H, jb0, tol)``."""

    def cycle(V, H, jb0, tol):
        return ks_hep_cycle_blocked(op, V, H, jb0, tol, gen, ncv=ncv, b=b,
                                    which=which, confirm=confirm)

    return cycle


def _prepare_fast_operator(op):
    """The operator form the cycle runs (reference ``_prepare_fast_operator``,
    ks_jit.py:1042-1115): an AIJ operator goes to its routed form (a DIA
    operator on K1/K2/K5 when it is a few dense diagonals, else CSR on K6);
    a DIA operator, the device shift-and-invert operator
    (``SinvertCGOperator``), or any other operator with a ``mult`` on its
    device, runs as it is.  Vectors stay flat (n,): there is no padded layout.

    With a row mesh set (``sys/mesh.py`` ``set_mesh``) a square DIA
    operator goes to its partitioned form (``parallel/halo.py``
    ``HaloDIAOperator``: K1/K2/K5 on each rank's slab) and a CSR operator
    of at least 4,096 rows to ``parallel/halo_pallas.py``
    ``ShardedGELLPaddedOperator`` (K6 on the slab); a reach past the
    nearest neighbour takes ``shard_operator``'s form (whole vectors, one
    all-gather a product), as the reference's ``try`` leaves it to GSPMD
    (``:1098-1104``).  Unlike the reference (world > 1), a mesh of one rank
    routes too, so the partitioned path runs on one card."""
    mesh = get_mesh()
    if isinstance(op, AIJOperator):
        if (mesh is not None and op.shape[0] >= 4096
                and op.fast_form() is op):
            from ..parallel.halo_pallas import ShardedGELLPaddedOperator

            try:
                return ShardedGELLPaddedOperator(op, mesh)
            except ValueError:
                return shard_operator(op, mesh)
        op = op.fast_form()
    if (mesh is not None and isinstance(op, DIAOperator)
            and op.shape[0] == op.shape[1]):
        from ..parallel.halo import HaloDIAOperator

        try:
            return HaloDIAOperator.from_dia(op, mesh)
        except ValueError:
            return shard_operator(op, mesh)
    return op


def _init_rows(n: int, nrows: int, np_dtype, initial_space=None) -> np.ndarray:
    """nrows start vectors: the columns of ``initial_space`` first, then
    seeded numpy normals (Re + i Im for a complex dtype, drawn in that
    order), orthonormalized by a host QR -- the reference's ``_init_rows``
    (slepc_tpu/eps/ks_jit.py:1169-1185), so both packages start from the
    same block.  Returns (nrows, n)."""
    rng0 = np.random.default_rng(0)
    cols = [] if initial_space is None else \
        [initial_space[:, j] for j in range(min(initial_space.shape[1], nrows))]
    while len(cols) < nrows:
        c = rng0.standard_normal(n)
        if np.issubdtype(np_dtype, np.complexfloating):
            c = c + 1j * rng0.standard_normal(n)
        cols.append(c)
    M = np.stack(cols, axis=1)
    Qm, _ = np.linalg.qr(M.astype(np_dtype))
    return np.ascontiguousarray(Qm.T)


def _true_residual_confirm(eps, op):
    """The fast path's true-residual test (the general loop's, eps/
    krylovschur.py): each leading candidate whose estimate passes ``tol``
    is formed (one K4 rotation), taken back to the original space
    (``op.postprocess_vec``: the device sinvert's x = D^-1/2 u) and counts
    only if ||A x - lambda B x|| / ||x|| on the original pencil, measured by
    ``eps.conv_measure``, passes too.  The reference's fast path tests the
    transformed estimate alone (slepc_tpu/eps/ks_jit.py:591, 739), which
    for shift-and-invert lets the pencil's residual sit up to
    ||A|| / |lambda| times above tol: a deliberate divergence."""
    post = getattr(op, "postprocess_vec", None)
    A, B, st = eps.A, eps.B, eps.st
    if op.mesh is not None:  # a partitioned A: its slab rows
        A, B = op, None

    def confirm(V, Q, theta, errest, tol):
        errest = errest.copy()
        ncv = Q.shape[0]
        i = 0
        while i < errest.size and errest[i] < tol:
            u = rotate(_mat(Q[:, i: i + 1], V), V[:ncv])[0]
            x = post(u) if post is not None else u
            bx = B.mult(x) if B is not None else x
            ax = A.mult(x)
            if st.requires_rayleigh:  # a filter: p(A)'s theta is not lambda
                num, den = _host(allreduce(torch.stack(
                    [torch.vdot(x, ax), torch.vdot(x, bx)])))
                lam = float((num / den).real)
            else:
                lam = float(np.asarray(st.back_transform(
                    np.array([theta[i]], np.float64)))[0])
            r = ax - lam * bx
            rn, xn = _host(combine_norms(torch.stack(
                [torch.linalg.vector_norm(r),
                 torch.linalg.vector_norm(x)]))).real
            errest[i] = eps.conv_measure(lam, rn / max(xn, 1e-300))
            i += 1
        return errest

    return confirm


def ks_hep_solve(eps, op, which: str) -> None:
    """Host loop over restart cycles; fills the EPS result fields.  On a
    row mesh the eigenvalues are the same on every rank and the
    eigenvectors are each rank's own rows (``RowMesh.gather_rows``
    assembles them)."""
    _ks_hep_solve(_prepare_fast_operator(op), eps, which)


@reduces_over_op
def _ks_hep_solve(op, eps, which: str) -> None:
    ncv = eps.ncv
    dtype = op.dtype

    # Chebyshev-amplified smallest-end path (eps.cheb_degree > 0): the
    # monotone low-end filter turns badly-separated smallest eigenvalues
    # into well-separated largest ones (eps/cheb_accel.py)
    cheb_deg = int(eps.cheb_degree or 0)
    # a complex operator runs the plain cycle, as the reference's fast path
    # does (slepc_tpu/eps/ks_jit.py:1133-1136)
    if cheb_deg > 0 and which == "smallest" and not dtype.is_complex:
        from .cheb_accel import ks_cheb_smallest

        cheb_blk = int(eps.cheb_block or 1)
        if cheb_blk > 1:
            ncv = -(-ncv // cheb_blk) * cheb_blk  # block-aligned basis
        res = ks_cheb_smallest(
            op, nev=eps.nev, tol=eps.tol, ncv=ncv, degree=cheb_deg,
            block=cheb_blk, reorth=eps.cheb_reorth,
            rot_mode=eps.cheb_rot_mode, keep_den=int(eps.cheb_keep_den),
            budget_s=eps.cheb_budget_s)
        k = int(res["nconv"])
        eps.nconv = k
        eps.its = res["stats"]["cycles"]
        eps.cheb_stats = res["stats"]
        eps.eigenvalues = np.array(res["lam"][:k], copy=True)
        eps.errests = np.array(res["resid"][:k], copy=True)
        eps._eigenvectors = op.interior(res["X"][:k])
        return

    bsize = int(eps.block_size or 1)
    if bsize > 1:
        ncv = -(-ncv // bsize) * bsize  # block-aligned basis
    nrow0 = max(bsize, 1)
    # a partitioned operator's rows are its slab's: the global start block
    # cut to this rank's rows, so the solve starts where the one-card one does
    rows0 = torch.from_numpy(_init_rows(eps.n, nrow0, _np_dtype(dtype),
                                        eps.initial_space))
    rows0 = op.local_rows(rows0)
    V = torch.zeros((ncv + nrow0, rows0.shape[1]), dtype=dtype,
                    device=op.device)
    V[:nrow0] = rows0.to(op.device)
    H = np.zeros((ncv + nrow0, ncv), dtype=_np_dtype(dtype))
    gen = torch.Generator(device=op.device).manual_seed(12345)
    confirm = _true_residual_confirm(eps, op) if (
        eps.true_residual or hasattr(op, "postprocess_vec")) else None
    if bsize > 1:
        cycle_fn = get_ks_hep_cycle_blocked(op, gen, ncv, bsize, which,
                                            confirm=confirm)
    else:
        # 'delayed' hides reduction latency, which the fused sweeps already
        # do: it is 'full'.  Selective and periodic belong to explicit
        # Lanczos; Krylov-Schur's light policy is the monitored 'partial'
        # (reference ks_jit.py:1220-1235)
        rmode = {"delayed": "full", "selective": "partial",
                 "periodic": "partial"}.get(eps.reorth, eps.reorth)
        cycle_fn = get_ks_hep_cycle(op, gen, ncv, which, reorth=rmode,
                                    reorth_period=eps.reorth_period,
                                    rot_mode=eps.rot_mode, confirm=confirm)
    j0, k2 = 0, 0
    theta = errest = None
    n = eps.n
    filtered = eps.st.requires_rayleigh
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
        if filtered:
            # count the converged pairs on the filter plateau (p ~ 1): the
            # neighbours outside the interval converge too but do not count
            if int(np.sum(theta[:k2] > 0.5)) >= eps.nev or k2 >= ncv - 1:
                break
        elif k2 >= eps.nev:
            break
    eps.nconv = k2
    eps.eigenvalues = np.asarray(
        eps.st.back_transform(theta[:k2].astype(np.float64)))
    eps.errests = errest[:k2].copy()
    X = op.interior(V[:k2]).clone()  # this rank's own rows
    if filtered and k2 > 0:
        _filtered_finish(eps, X)
        return
    post = getattr(op, "postprocess_vec", None)
    if post is not None and k2 > 0:
        # transformed-space -> original-space vectors (the device
        # shift-invert symmetrization's x = D^{-1/2} u), renormalized
        X = torch.stack([post(X[i]) for i in range(k2)])
        nrm = torch.linalg.vector_norm(X, dim=1, keepdim=True)
        X /= torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    eps._eigenvectors = X


def _filtered_finish(eps, X: torch.Tensor) -> None:
    """A filtered run's results (the reference's ks_hep_solve tail): the
    Rayleigh quotients of the converged rows on the original A, their true
    residuals ||A x - lambda x|| / |lambda| (A on the whole block at once),
    and only the pairs inside the filter's interval whose residual is below
    max(100 tol, 1e-6), in ascending order."""
    AX = LinearOperator.block_of(eps.A)(X)
    lam_d = ((X.conj() * AX).sum(dim=1) / (X.abs() ** 2).sum(dim=1)).real
    res = torch.linalg.vector_norm(AX - lam_d[:, None] * X, dim=1)
    lam, res = _host(lam_d), _host(res)
    errs = res / np.maximum(np.abs(lam), 1e-300)
    a, b = eps.st.interval
    sel = (lam >= a) & (lam <= b) & (errs < max(eps.tol * 100, 1e-6))
    idx = np.flatnonzero(sel)
    idx = idx[np.argsort(lam[idx], kind="stable")]
    eps.nconv = len(idx)
    eps.eigenvalues = lam[idx].copy()
    eps.errests = errs[idx].copy()
    eps._eigenvectors = X[torch.from_numpy(idx).to(X.device)]
