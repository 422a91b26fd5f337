"""EPS Davidson-type solvers: GD (generalized Davidson) and JD
(Jacobi-Davidson) (``slepc_tpu/eps/davidson.py``).

Reference: src/eps/impls/davidson/ (4,335 LoC framework: davidson.c +
dvdcalcpairs/dvdimprovex/dvdupdatev/dvdschm) with thin wrappers gd/gd.c and
jd/jd.c.  The composable sub-scheme structure collapses into one host loop
with a pluggable *improver*:

  GD: expand with the preconditioned residual t = K^-1 r.
  JD: expand with an approximate solution of the projected correction
      equation  (I - Q Q^H)(A - sigma B)(I - Q Q^H) t = -r  where Q spans
      the locked vectors plus the current Ritz vector -- solved by
      right-preconditioned projected GMRES with the reference's adaptive
      controls (dvdimprovex.c:625-673,931-971):
        * shift fix rule: sigma = target while ||r|| > fix (avoids early
          misconvergence), sigma = theta (RQI regime) once below
          (EPSJDSetFix, default 0.01);
        * dynamic inner tolerance 0.5^j for the j-th attempt on the
          current pair (Fokkema-Sleijpen), floored at eps.tol.

Block expansion (``davidson_bs`` > 1): the bs best unconverged Ritz pairs
each contribute a correction per outer iteration.  Restart keeps the best
``minv`` Ritz vectors plus ``davidson_plusk`` previous corrections
(dvdupdatev.c role).  Converged pairs are locked and deflated.  A standard
Hermitian GD solve at an end of the spectrum with one correction a step
runs the cycle of ``eps/gd_jit.py`` instead (``eps.gd_fused = False``
keeps the host loop); it preconditions with the operator's diagonal
whatever the ST, the host loop only under ``STPrecond``, as in the
reference.

Layout and kernels: the search basis is the row-major (m, n) tensor V
(row k = basis vector k).  Its products with the operator go through
``mult_block`` (kernel K5 for a DIA operator), the single vectors' through
``mult`` (K2 / K1 on DIA, K6 on CSR); the projected matrices are K3's dots
(``bv/orthog.py`` ``gram``), the Ritz vectors and restarts K4 rotations,
the correction's CGS2 K3's sweeps; the small dense eigenproblems are
LAPACK on the host.  Start vectors are drawn with numpy's
``default_rng(0)``, as the reference draws them.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..bv.orthog import cholqr2, gram, orthogonalize_vec
from ..st.st import STPrecond
from ..sys.sort import Which
from .base import EPS, EPSSolver, basis_combine, op_mult, op_mult_block


def _real_cols(C, cplx: bool):
    """Eigenvector columns for a REAL search space: complex harmonic pairs
    contribute their real and imaginary parts as separate directions
    (avoids the silent complex->real cast)."""
    if cplx or not np.iscomplexobj(C):
        return C
    if np.abs(C.imag).max() < 1e-12 * max(np.abs(C).max(), 1e-300):
        return np.ascontiguousarray(C.real)
    cols = []
    j = 0
    while j < C.shape[1]:
        c = C[:, j]
        if np.abs(c.imag).max() < 1e-12 * max(np.abs(c).max(), 1e-300):
            cols.append(c.real)
            j += 1
        else:
            cols.append(c.real)
            cols.append(c.imag)
            j += 2
    M = np.stack(cols[: C.shape[1]], axis=1)
    return np.ascontiguousarray(M)


def _gmres_projected(apply_op, apply_pc, b, rtol: float, maxiter: int):
    """Right-preconditioned GMRES (one cycle, m = maxiter) for the
    projected correction equation: modified Gram-Schmidt on the device, the
    small Hessenberg least-squares on the host, one host read per step."""
    m = maxiter
    cplx = b.is_complex()
    bn = float(torch.linalg.vector_norm(b))
    if bn == 0.0:
        return torch.zeros_like(b)
    Vs = [b / bn]
    Hm = np.zeros((m + 1, m), dtype=complex)
    for j in range(m):
        w = apply_op(apply_pc(Vs[j]))
        hs = []
        for i in range(j + 1):
            hij = torch.vdot(Vs[i], w)  # stays in the operand dtype
            w = w - hij * Vs[i]
            hs.append(hij)
        host = torch.stack(hs + [torch.linalg.vector_norm(w).to(hs[0].dtype)])
        host = host.cpu().numpy().astype(complex)
        Hm[: j + 1, j] = host[:-1]
        hn = float(host[-1].real)
        Hm[j + 1, j] = hn
        # the small least-squares for the residual estimate
        e1 = np.zeros(j + 2, dtype=complex)
        e1[0] = bn
        y, *_ = np.linalg.lstsq(Hm[: j + 2, : j + 1], e1, rcond=None)
        rres = float(np.linalg.norm(Hm[: j + 2, : j + 1] @ y - e1)) / bn
        if hn < 1e-14 or rres < rtol or j == m - 1:
            yc = y if cplx else y.real
            Vm = torch.stack(Vs[: j + 1])
            t = torch.from_numpy(np.ascontiguousarray(yc)).to(
                Vm.device, Vm.dtype) @ Vm
            return apply_pc(t)
        Vs.append(w / hn)
    return apply_pc(Vs[0] * bn)  # unreachable


def _deflate_block(V: torch.Tensor, locked) -> torch.Tensor:
    """The rows of V with each locked vector projected out in turn."""
    for x in locked:
        x = x.to(V.dtype)
        V = V - torch.outer(V @ x.conj(), x)
    return V


def _jd_correct(A, B, u, sigma, r, precond, locked, rtol: float,
                maxiter: int):
    """JD correction equation via projected right-preconditioned GMRES:
    (I - Q Q^H)(A - sigma B)(I - Q Q^H) t = -r, Q = [locked, u]
    (reference dvdimprovex.c inner KSP).  Returns (t, matvec_count)."""
    Q = list(locked) + [u]
    mv = [0]

    def proj(v):
        for q in Q:
            v = v - q * torch.vdot(q, v)
        return v

    def apply_op(v):
        v = proj(v)
        Av = op_mult(A, v)
        Bv = op_mult(B, v) if B is not None else v
        mv[0] += 2 if B is not None else 1
        return proj(Av - sigma * Bv)

    def apply_pc(v):
        return proj(precond(v))

    t = _gmres_projected(apply_op, apply_pc, -proj(r), rtol, maxiter)
    return proj(t), mv[0]


def _vec(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device,
                                                        like.dtype)


class _Davidson(EPSSolver):
    jd_correction = False

    def _fused(self, eps: EPS) -> bool:
        """The GD cycle (eps/gd_jit.py): standard HEP, Ritz extraction, one
        correction a step, smallest or largest real."""
        if (self.jd_correction or not getattr(eps, "gd_fused", True)
                or eps.B is not None or not eps.is_hermitian
                or getattr(eps, "extraction", None) not in (None, "", "ritz")
                or max(1, int(getattr(eps, "davidson_bs", 1) or 1)) != 1):
            return False
        w = {Which.SMALLEST_REAL: "smallest",
             Which.LARGEST_REAL: "largest"}.get(eps.which)
        if w is None:
            return False
        from .gd_jit import gd_hep_solve

        return gd_hep_solve(eps, eps.A, w)

    def solve(self, eps: EPS) -> None:
        if self._fused(eps):
            return
        st = eps.st
        A, B = eps.A, eps.B
        n, ncv = eps.n, eps.ncv
        minv = max(eps.nev, min(6, ncv // 2))
        plusk = int(getattr(eps, "davidson_plusk", 1) or 0)
        bs = max(1, int(getattr(eps, "davidson_bs", 1) or 1))
        fix = float(getattr(eps, "jd_fix", 0.01) or 0.01)
        dtype, device = A.dtype, A.device
        cplx = dtype.is_complex
        hermitian = eps.is_hermitian
        sc = eps.sort_criterion()

        precond = (st.preconditioner() if isinstance(st, STPrecond)
                   else (lambda r: r))

        def bmult_block(X):
            return op_mult_block(B, X) if B is not None else X

        def rayleigh(ub):
            """(theta, r) of the unit vector ub: two products."""
            Aub = op_mult(A, ub)
            Bub = op_mult(B, ub) if B is not None else ub
            eps.matvecs += 2 if B is not None else 1
            th = complex(torch.vdot(ub, Aub) / torch.vdot(ub, Bub))
            if hermitian and not cplx:
                th = th.real
            return th, Aub - th * Bub

        rng = np.random.default_rng(0)
        v0 = rng.standard_normal((n, max(bs, 1)))
        if cplx:
            v0 = v0 + 1j * rng.standard_normal(v0.shape)
        if eps.initial_space is not None:
            k0 = min(eps.initial_space.shape[1], bs)
            v0[:, :k0] = np.asarray(eps.initial_space[:, :k0]).reshape(n, k0)
        Vj, _ = cholqr2(torch.from_numpy(np.ascontiguousarray(v0.T)).to(
            device, dtype))

        locked_X: list[torch.Tensor] = []
        locked_lam: list[complex] = []
        locked_err: list[float] = []
        prev_t: list[torch.Tensor] = []  # plusk retained corrections
        inner_j = 0  # attempts on the current leading pair
        eps.matvecs = 0

        while eps.its < eps.max_it and len(locked_lam) < eps.nev:
            eps.its += 1
            m = Vj.shape[0]
            AV = op_mult_block(A, Vj)
            BV = bmult_block(Vj)
            eps.matvecs += m * (2 if B is not None else 1)

            if eps.extraction == "harmonic" and eps.target is not None:
                # harmonic Rayleigh-Ritz (reference: the Davidson
                # EPS_HARMONIC route, dvdcalcpairs.c): with
                # W = (A - tau B) V, solve W^H W c = xi W^H B V c;
                # theta = tau + xi selects interior pairs reliably
                tau = complex(eps.target)
                Wv = AV - (tau if cplx else tau.real) * BV
                G1 = gram(Wv, Wv).cpu().numpy()
                M1 = gram(Wv, BV).cpu().numpy()
                xi, C = sla.eig(G1, M1)
                fin = np.isfinite(xi)
                xi, C = xi[fin], C[:, fin]
                w = tau + xi
            else:
                G = gram(Vj, AV).cpu().numpy()
                M = gram(Vj, BV).cpu().numpy()
                if hermitian:
                    Ms = 0.5 * (M + M.conj().T)
                    try:
                        w, C = sla.eigh(0.5 * (G + G.conj().T), Ms)
                    except sla.LinAlgError:
                        # basis drift in single precision can push the Gram
                        # indefinite at tight subspaces: ridge it back to
                        # SPD instead of ending the solve
                        ridge = 1e-6 * max(np.trace(Ms).real
                                           / max(len(Ms), 1), 1e-30)
                        w, C = sla.eigh(0.5 * (G + G.conj().T),
                                        Ms + ridge * np.eye(len(Ms)))
                    w = w.astype(complex)
                else:
                    w, C = sla.eig(G, M)
            order = np.argsort(sc.keys(w), kind="stable")
            w, C = w[order], C[:, order]
            Cr = _real_cols(C, cplx)

            # leading Ritz pair
            u = basis_combine(Vj, Cr[:, :1])[0]
            u = u / torch.linalg.vector_norm(u)
            theta, r = rayleigh(u)
            err = eps.conv_measure(theta, float(torch.linalg.vector_norm(r)))
            eps.monitor(eps, eps.its, len(locked_lam),
                        np.concatenate([np.asarray(locked_lam, complex),
                                        w[:1]]),
                        np.concatenate([locked_err, [err]]))

            if err < eps.tol:
                locked_X.append(u)
                locked_lam.append(theta)
                locked_err.append(err)
                inner_j = 0
                # deflate: remove u from V, continue with the next Ritz
                # vectors
                keep = min(minv, m - 1) if m > 1 else 1
                if m > 1 and Cr[:, 1: keep + 1].shape[1] > 0:
                    Vj = basis_combine(Vj, Cr[:, 1: keep + 1])
                else:
                    Vj = _vec(rng.standard_normal(n), u)[None]
                Vj, _ = cholqr2(_deflate_block(Vj, locked_X))
                continue

            inner_j += 1
            # improver: bs corrections from the bs best unconverged pairs
            new_dirs: list[torch.Tensor] = []
            for ib in range(min(bs, Cr.shape[1])):
                if ib == 0:
                    ub, thb, rb = u, theta, r
                else:
                    ub = basis_combine(Vj, Cr[:, ib: ib + 1])[0]
                    ub = ub / torch.linalg.vector_norm(ub)
                    thb, rb = rayleigh(ub)
                if self.jd_correction:
                    # shift fix rule (EPSJDSetFix): the target until the
                    # residual is small, then the Rayleigh quotient
                    sigma = (complex(eps.target)
                             if (eps.target is not None and err > fix)
                             else thb)
                    if not cplx:
                        sigma = np.real(sigma)
                    rtol_in = max(float(eps.tol), 0.5 ** inner_j)
                    maxit_in = int(getattr(eps, "jd_inner_maxit", 24) or 24)
                    t, mv = _jd_correct(A, B, ub, sigma, rb, precond,
                                        locked_X, rtol_in, maxit_in)
                    eps.matvecs += mv
                else:
                    t = precond(rb)
                if t.is_complex() and not Vj.is_complex():
                    # a real non-Hermitian problem's complex Rayleigh
                    # quotient: the basis goes complex, as the reference's
                    Vj = Vj.to(t.dtype)
                t = _deflate_block(t[None], locked_X)[0]
                t = orthogonalize_vec(Vj, t)[0]  # CGS2 against the basis
                for d in new_dirs:
                    t = t - d * torch.vdot(d, t)
                tn = torch.linalg.vector_norm(t)
                if float(tn) < 1e-13:
                    t = _vec(rng.standard_normal(n), u)
                    t = t - (Vj.conj() @ t) @ Vj
                    tn = torch.linalg.vector_norm(t)
                new_dirs.append(t / tn)
            eps.expansions += len(new_dirs)

            if m + len(new_dirs) > ncv:
                # restart: the best minv Ritz vectors + plusk prior
                # corrections
                Vnew = basis_combine(Vj, Cr[:, :minv])
                for pt in prev_t[-plusk:]:
                    pt = pt - (Vnew.conj() @ pt) @ Vnew
                    ptn = float(torch.linalg.vector_norm(pt))
                    if ptn > 1e-10:
                        Vnew = torch.cat([Vnew, (pt / ptn)[None]])
                Vj, _ = cholqr2(Vnew)
            prev_t = (prev_t + new_dirs)[-max(plusk, 1):]
            Vj = torch.cat([Vj, torch.stack(new_dirs)])

        k = len(locked_lam)
        eps.nconv = k
        eps.eigenvalues = np.array(locked_lam, dtype=complex)
        if k and np.all(np.abs(np.imag(eps.eigenvalues)) < 1e-14):
            eps.eigenvalues = eps.eigenvalues.real
        eps.errests = np.array(locked_err)
        if locked_X:
            xdt = Vj.dtype if Vj.is_complex() else dtype
            eps._eigenvectors = torch.stack([x.to(xdt) for x in locked_X])
        else:
            eps._eigenvectors = torch.zeros((0, n), dtype=dtype,
                                            device=device)


class GD(_Davidson):
    """Generalized Davidson (reference gd/gd.c)."""

    jd_correction = False


class JD(_Davidson):
    """Jacobi-Davidson (reference jd/jd.c)."""

    jd_correction = True


EPS.register("gd", GD)
EPS.register("jd", JD)
