"""EPS BSE -- the structure-preserving Bethe-Salpeter eigensolver
(``slepc_tpu/eps/bse.py``).

H = [R C; -C^H -R^T] (``mat/structured.py`` :class:`MatBSE`) has its
eigenvalues in +-lambda pairs; the solvers work on n-size blocks or on a
definite metric instead of the 2n non-Hermitian H.  ``eps.bse_variant``:

  * ``auto`` with real R, C (R +- C SPD): the Shao reduction.  With u = x +
    y, v = x - y: (R + C) u = lambda v, (R - C) v = lambda u, so (R - C)(R +
    C) u = lambda^2 u, self-adjoint in the (R + C) inner product: a GHEP
    through the general Krylov-Schur loop with R + C as the metric only (no
    B-solve).  v = (R + C) u / lambda, x = (u + v) / 2, y = (u - v) / 2.
  * ``auto`` with complex blocks: H = J M with J = diag(I, -I) and M = [R
    C; conj(C) conj(R)] Hermitian positive definite, so H is self-adjoint
    in the M inner product.  The smallest positive pairs come from H^{-1} =
    M^{-1} J with M as the metric (one solve with M a step; M x is H x with
    its lower half negated), the largest from H itself.  M is factored
    once: for dense blocks on the device (``ksp/direct.py``'s dense LU, no
    host copy of the 2n x 2n matrix; the reference assembles a scipy CSR
    and factors it on the host), otherwise as the reference does.
  * ``projected``: Lanczos on half-size blocks with two coupled bases X, Y
    (rows, on the device) and the pseudo-inner-product orthogonalization
    c1 = X^H hx - Y^H hy, c2 = -Y^T hx + X^T hy, hx <- hx - X c1 - conj(Y)
    c2 (hy = conj(hx)), which projects H to a real symmetric tridiagonal in
    lambda^2, thick-restarted in compact arrow form (``ds/compact.py``).
    With p = Y^H conj(hx) and q = X^H hx, c1 = q - p and c2 = conj(c1), so
    the full sweep is two K3c dots sweeps (X against hx, Y against
    conj(hx)) and two K3c updates (hx - X^T c1, then conj(conj(hx) - Y^T
    c1)); the restart rotations X[:kl] = Q^T X[:nv] are K4 on the real
    view (Q is real).  Only coefficients and norms go to the host.

The eigenvectors are the rows of a (nconv, 2n) tensor on the operator's
device; the values come back ascending (the smallest excitation energies)
unless ``which`` is ``largest_real``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mat.linop import (AIJOperator, DenseOperator, ProductOperator,
                         ShellOperator, SumOperator)
from ..mat.structured import MatBSE, _conj
from ..ops.bv import panel_dots, panel_update
from ..ops.rotate import rotate
from ..st.st import STShift
from ..sys.options import Options
from ..sys.sort import Which
from .base import (EPS, EPSSolver, ProblemType, normalize_rows, op_mult,
                   op_mult_block)


class _MetricOnlyShift(STShift):
    """The operator itself, with B left to the basis as its metric (no
    B-solve)."""

    def _compute_operator(self):
        return self.A


def _inner(eps: EPS, op, B, which, nev, ncv) -> EPS:
    inner = EPS(op, B, problem_type=ProblemType.GHEP, which=which, nev=nev,
                ncv=ncv, tol=eps.tol, max_it=eps.max_it, options=Options())
    inner.set_st(_MetricOnlyShift([op]))
    inner.solve()
    eps.its = inner.its
    return inner


def _residuals(H: MatBSE, Z: torch.Tensor, lam: np.ndarray) -> np.ndarray:
    """||H z - lam z|| / |lam| of each row of Z (unit rows)."""
    HZ = op_mult_block(H, Z)
    lam_t = torch.from_numpy(np.asarray(lam, dtype=float)).to(Z.device)
    res = torch.linalg.vector_norm(HZ - lam_t[:, None] * Z, dim=1)
    return res.cpu().numpy() / np.maximum(np.abs(lam), 1e-300)


class KrylovSchurBSE(EPSSolver):
    def solve(self, eps: EPS) -> None:
        # the smallest positive excitation energies, ascending, unless the
        # top of the spectrum was asked for explicitly
        if eps.which not in (Which.LARGEST_REAL,):
            eps.which = Which.SMALLEST_REAL
        H = eps.A
        if not isinstance(H, MatBSE):
            raise ValueError("bse solver requires a MatBSE operator "
                             "(create_bse)")
        variant = str(eps.bse_variant or "auto").lower()
        if variant == "projected":
            return self._solve_projected(eps, H)
        if H.R.dtype.is_complex or H.C.dtype.is_complex:
            return self._solve_complex(eps, H)
        self._solve_shao(eps, H)

    def _solve_shao(self, eps: EPS, H: MatBSE) -> None:
        R, C = H.R, H.C
        ApB = SumOperator((R, C), (1.0, 1.0))  # R + C
        AmB = SumOperator((R, C), (1.0, -1.0))  # R - C
        op = ProductOperator((AmB, ApB))  # self-adjoint in (R + C)
        inner = _inner(eps, op, ApB, Which.SMALLEST_REAL, eps.nev, eps.ncv)
        k = inner.nconv
        lam2 = np.real(inner.eigenvalues[:k])
        pos = lam2 > 0
        lam = np.sqrt(lam2[pos])
        U = inner._eigenvectors[:k][torch.from_numpy(pos).to(H.device)]
        if U.is_complex():
            U = U.real  # the pairs of the real reduced problem are real
        lam_t = torch.from_numpy(lam).to(U.device, U.dtype)
        Vv = op_mult_block(ApB, U) / lam_t[:, None]
        Z = normalize_rows(torch.cat([0.5 * (U + Vv), 0.5 * (U - Vv)], dim=1))
        order = np.argsort(lam)
        eps.nconv = len(lam)
        eps.eigenvalues = lam[order]
        eps.errests = inner.errests[:k][pos][order] \
            if len(inner.errests) >= k else np.zeros(len(lam))
        eps._eigenvectors = Z[torch.from_numpy(order).to(Z.device)]

    def _solve_complex(self, eps: EPS, H: MatBSE) -> None:
        from ..ksp.ksp import KSP

        R, C = H.R, H.C
        n = R.shape[0]

        def m_mult(x):
            y = H.mult(x)
            return torch.cat([y[:n], -y[n:]])

        Mop = ShellOperator((2 * n, 2 * n), H.dtype, m_mult, m_mult,
                            nnz=H.nnz, device=H.device)
        want_largest = eps.which == Which.LARGEST_REAL
        if want_largest:
            op = H
        else:
            ksp = KSP(self._assembled_m(R, C), method="direct")

            def hinv_mult(x):
                return ksp.solve(torch.cat([x[:n], -x[n:]]))

            op = ShellOperator((2 * n, 2 * n), H.dtype, hinv_mult,
                               nnz=H.nnz, device=H.device)
        inner = _inner(eps, op, Mop, Which.LARGEST_MAGNITUDE, 2 * eps.nev,
                       eps.ncv and 2 * eps.ncv)
        k = inner.nconv
        mu = np.real(inner.eigenvalues[:k])
        pos = mu > 0
        lam = mu[pos] if want_largest else 1.0 / mu[pos]
        Z = inner._eigenvectors[:k][torch.from_numpy(pos).to(H.device)]
        order = np.argsort(-lam if want_largest else lam)[: eps.nev]
        lam = lam[order]
        Z = normalize_rows(Z[torch.from_numpy(order).to(Z.device)])
        eps.nconv = len(lam)
        eps.eigenvalues = lam
        eps.errests = _residuals(H, Z, lam)
        eps._eigenvectors = Z

    @staticmethod
    def _assembled_m(R, C):
        """M = [R C; conj(C) conj(R)] as an operator the direct KSP
        factors: dense on the blocks' device for dense blocks (the dense LU
        of ``ksp/direct.py``), else the host CSR assembly."""
        if isinstance(R, DenseOperator) and isinstance(C, DenseOperator):
            dt = torch.promote_types(R.dtype, C.dtype)
            Rd, Cd = R.A.to(dt), C.A.to(dt)
            return DenseOperator(torch.cat([
                torch.cat([Rd, Cd], dim=1),
                torch.cat([_conj(Cd), _conj(Rd)], dim=1)]))
        import scipy.sparse as sp

        Rs = sp.csr_matrix(R.to_scipy())
        Cs = sp.csr_matrix(C.to_scipy())
        return AIJOperator.from_scipy(
            sp.bmat([[Rs, Cs], [Cs.conj(), Rs.conj()]], format="csr"),
            device=R.device)

    def _solve_projected(self, eps: EPS, H: MatBSE) -> None:
        from ..ds.compact import solve_arrow_hep

        R, C = H.R, H.C
        n = R.shape[0]
        nev, tol = eps.nev, eps.tol
        ncv = min(eps.ncv or max(2 * nev, nev + 15), n - 1)
        max_it = eps.max_it or max(100, 2 * n // ncv)
        device = H.device
        cdtype = torch.complex64 if H.dtype in (
            torch.float32, torch.complex64) else torch.complex128

        def hm(z, s):  # R z + s C conj(z)
            return op_mult(R, z) + s * op_mult(C, _conj(z))

        def host(*ts):  # one read of a few 0-d / 1-d device values
            return torch.cat([t.reshape(-1).to(cdtype) for t in ts]
                             ).cpu().numpy()

        def on_device(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device,
                                                                cdtype)

        def sweep(Xa, Ya, hx, c):
            # hx - Xa^T c - conj(Ya)^T conj(c): two K3c updates
            hx = panel_update(Xa, c, hx[None])[0]
            return _conj(panel_update(Ya, c, _conj(hx)[None])[0])

        X = torch.zeros((ncv + 1, n), dtype=cdtype, device=device)
        Y = torch.zeros((ncv + 1, n), dtype=cdtype, device=device)
        a = np.zeros(ncv)
        b = np.zeros(ncv + 1)
        rng = np.random.default_rng(0)
        u = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        if eps.initial_space is not None:
            u = np.asarray(eps.initial_space[:n, 0]).astype(complex)
        u = on_device(u / np.linalg.norm(u))
        v = hm(u, 1.0)
        nrm = np.sqrt(max(float(torch.vdot(u, v).real), 1e-300))
        u, v = u / (2 * nrm), v / (2 * nrm)
        X[0] = u + v
        Y[0] = _conj(u - v)

        fill = 0  # locked + kept rows (the restart boundary)
        k2 = 0
        lam = None
        eps.its = 0
        while eps.its < max_it:
            eps.its += 1
            nv = ncv
            brk = False
            for j in range(fill, nv):
                uj = hm(v, -1.0)
                hx = uj + v
                hy = _conj(uj - v)
                ncols = j + 1
                lloc = 0 if j == fill else j - 1
                araw = complex(host(torch.vdot(X[j], hx)
                                    - torch.vdot(Y[j], hy))[0])
                h1 = np.zeros(ncols, complex)
                h1[lloc:j] = b[lloc:j]
                h1[j] = araw
                h2 = h1.copy()
                h2[j] = araw - 1.0
                # the local three-term step: hx - X h1 - conj(Y) h2
                hx = panel_update(X[lloc:ncols], on_device(h1[lloc:, None]),
                                  hx[None])[0]
                hx = _conj(panel_update(Y[lloc:ncols],
                                        on_device(np.conj(h2[lloc:, None])),
                                        _conj(hx)[None])[0])
                # the full pseudo-orthogonalization: c1 = q - p, c2 =
                # conj(c1)
                Xa, Ya = X[:ncols], Y[:ncols]
                c = panel_dots(Xa, hx[None]) - panel_dots(Ya, _conj(hx)[None])
                hx = sweep(Xa, Ya, hx, c)
                v = hm(hx, 1.0)
                vals = host(c[j, 0], torch.vdot(hx, v))
                h1[j] += vals[0]
                a[j] = 2.0 * (h1[j].real - 0.5)
                g = vals[1].real
                if g < -1e-10 * max(1.0, abs(a[j])):
                    # the pseudo-inner product went negative: the BSE
                    # pencil is not definite (the reference's hard error)
                    raise ValueError(
                        "projected BSE: indefinite pencil (u^H H u < 0); "
                        "the BSE structure requires a definite M")
                b[j] = 2.0 * np.sqrt(max(g, 0.0))
                if b[j] < 1e-14 * max(1.0, abs(a[j])):
                    brk = True
                    nv = j + 1
                    break
                u2 = hx / b[j]
                v = v / b[j]
                X[j + 1] = u2 + v
                Y[j + 1] = _conj(u2 - v)

            w, Q = solve_arrow_hep(a[:nv], b[:nv - 1], fill)  # lambda^2, asc
            lam_all = np.sqrt(np.maximum(w, 0.0))
            beta_nv = b[nv - 1]
            last = Q[nv - 1, :]
            errest = beta_nv * np.abs(last) / np.maximum(lam_all, 1e-300)
            k2 = 0
            while k2 < nv and errest[k2] < tol:
                k2 += 1
            lam = lam_all
            if len(eps.monitor):
                eps.monitor(eps, eps.its, k2, lam_all, errest)
            done = k2 >= nev or eps.its >= max_it or brk
            l = 0 if done else min(max(1, (nv - k2) // 2),
                                   max(nv - k2 - 1, 0))
            kl = min(k2 + l, nv - 1)
            Qk = torch.from_numpy(np.ascontiguousarray(Q[:, :kl])).to(
                device, X.real.dtype)
            rotate(Qk, X[:nv], out=X[:kl])  # K4 on the real view
            rotate(Qk, Y[:nv], out=Y[:kl])
            X[kl] = X[nv]
            Y[kl] = Y[nv]
            a[:kl] = w[:kl]
            b[:kl] = beta_nv * last[:kl]
            fill = kl
            if done:
                break

        k2 = min(k2, nev)
        eps.nconv = k2
        if k2 == 0:
            eps.eigenvalues = np.array([])
            eps.errests = np.array([])
            eps._eigenvectors = torch.zeros((0, 2 * n), dtype=cdtype,
                                            device=device)
            return
        lamk = lam[:k2]
        # the eigenvectors [d1 x + d2 conj(y); d1 y + d2 conj(x)], d1 =
        # lambda + 1, d2 = lambda - 1, and their true residuals
        d1 = torch.from_numpy(lamk + 1.0).to(device, cdtype)[:, None]
        d2 = torch.from_numpy(lamk - 1.0).to(device, cdtype)[:, None]
        Xk, Yk = X[:k2], Y[:k2]
        Z = normalize_rows(torch.cat([d1 * Xk + d2 * _conj(Yk),
                                      d1 * Yk + d2 * _conj(Xk)], dim=1))
        eps.eigenvalues = lamk
        eps.errests = _residuals(H, Z, lamk)
        eps._eigenvectors = Z


EPS.register("bse", KrylovSchurBSE)
