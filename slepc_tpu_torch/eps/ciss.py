"""EPS CISS -- contour integral spectral slicing (Sakurai-Sugiura)
(``slepc_tpu/eps/ciss.py``).

Reference: src/eps/impls/ciss/ciss.c (1,474 LoC): quadrature over an RG
contour; the subspace of S_k = (1/2 pi i) oint z^k (zB - A)^{-1} B V dz;
Rayleigh-Ritz (or block-Hankel) extraction; per-integration-point linear
solves parallelized over subcommunicators (SlepcContourData,
src/sys/slepccontour.c).  Refinement iterations reuse the extracted vectors
as the next probing block (reference -eps_ciss_refine_inner).

Point solves (``eps.ciss_solver``):

  * ``"batched"``: every point's shifted system in batches on the device
    (``parallel/tasks.py``): Jacobi-preconditioned BiCGStab with adaptive
    per-point tolerances in cost buckets (``eps.ciss_adaptive``; False
    keeps one bucket at the fixed tolerance).  The moments S are
    accumulated on the device bucket by bucket, so no (points, L, n) block
    of solutions is kept.  Each point's residual is checked, and a point
    whose residual stalled above 1e3 times the inner tolerance is solved
    again by a host sparse LU (the reference's per-point KSP is direct by
    default, ciss.c:283-316): ``eps.ciss_refactored_points`` lists them.
    A real operator meets the complex blocks as their real and imaginary
    rows (kernel K5 for a DIA operator, ``mat/linop.py``
    ``apply_by_parts``).
  * ``"factorized"``: one host LU per point on a thread pool
    (``thread_map``): the reference's per-subcommunicator KSP, host code
    by design.
  * ``"auto"``: ``batched`` when the operators are DIA, CSR or dense on a
    CUDA device, else ``factorized``.  (The reference picks ``batched``
    only on a TPU backend.)

The extraction runs on the operator's device: the moments' basis by a QR
and the SVD of its small triangle, the products with A and B through
``mult_block``; the small projected eigenproblems are LAPACK on the host.
A task mesh over the points (``eps.ciss_task_mesh``) is ROADMAP.md queue 1
item 16 and raises.  The probing block is drawn with numpy's
``default_rng(0)``, as the reference draws it.

Outputs beside the eigenpairs: ``ciss_inner_iters`` (the batched solves'
points x iterations, summed over buckets), ``ciss_inner_buckets``,
``ciss_point_residuals`` and ``ciss_refactored_points``.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..mat.linop import AIJOperator, DenseOperator, DIAOperator
from ..parallel.tasks import (_block_mult, batched_shifted_solves_adaptive,
                              solve_dtype, thread_map)
from ..rg.rg import RGEllipse
from .base import EPS, EPSSolver, op_mult_block

_TODO_MESH = ("EPS ciss: a task mesh over the contour points "
              "(ciss_task_mesh) is still to be ported (ROADMAP.md, queue 1, "
              "item 16)")
_KINDS = (AIJOperator, DenseOperator, DIAOperator)


def _mode(eps, A, B) -> str:
    mode = getattr(eps, "ciss_solver", "auto")
    if mode != "auto":
        return mode
    kinds = isinstance(A, _KINDS) and (B is None or isinstance(B, _KINDS))
    return "batched" if kinds and A.device.type == "cuda" else "factorized"


def _cols_mult(op, X: torch.Tensor) -> torch.Tensor:
    """op on the columns of the (n, k) tensor X."""
    return op_mult_block(op, X.T.contiguous()).T


def _thin_svd(M: torch.Tensor):
    """SVD of a tall (N, k) tensor: a QR, then the SVD of its k x k
    triangle.  Returns (U (N, k), s (host), Vh (host))."""
    Q, R = torch.linalg.qr(M)
    Ur, s, Vh = np.linalg.svd(R.cpu().numpy())
    return Q @ torch.from_numpy(Ur).to(Q.device, Q.dtype), s, Vh


def _rank(s: np.ndarray) -> int:
    return max(int(np.sum(s > 1e-11 * max(s[0] if s.size else 0.0,
                                           1e-300))), 1)


class _HostPencil:
    """z B - A on the host (scipy sparse or dense), for the per-point LU."""

    def __init__(self, A, B):
        import scipy.sparse as sp

        self.As = A.to_scipy()
        self.Bs = B.to_scipy() if B is not None else None
        self.sparse = sp.issparse(self.As)
        if self.sparse and self.Bs is not None and not sp.issparse(self.Bs):
            self.Bs = sp.csr_matrix(self.Bs)

    def solve(self, z: complex, R: np.ndarray) -> np.ndarray:
        n = self.As.shape[0]
        if self.sparse:
            import scipy.sparse as sp
            import scipy.sparse.linalg as spla

            Mz = (z * (self.Bs if self.Bs is not None
                       else sp.eye(n, format="csr")) - self.As).tocsc()
            return spla.splu(Mz.astype(complex)).solve(R.astype(complex))
        Mz = z * (np.asarray(self.Bs) if self.Bs is not None
                  else np.eye(n)) - np.asarray(self.As)
        return np.linalg.solve(Mz.astype(complex), R.astype(complex))


class CISS(EPSSolver):
    npoints = 32  # quadrature points (reference -eps_ciss_integration_points)
    blocksize = 16  # L (reference -eps_ciss_blocksize)
    moments = 4  # M (reference -eps_ciss_moments)
    refine = 2  # refinement iterations
    extraction = "rr"  # 'rr' (Rayleigh-Ritz) | 'hankel' (Beyn block-Hankel)

    def solve(self, eps: EPS) -> None:
        if getattr(eps, "ciss_task_mesh", None) is not None:
            raise NotImplementedError(_TODO_MESH)
        rg = eps.rg
        if rg is None:
            if eps.interval is not None:
                a, b = eps.interval
                rg = RGEllipse(center=0.5 * (a + b), radius=0.5 * (b - a),
                               vscale=0.1)
            else:
                raise ValueError("ciss requires a region (set_rg) or interval")
        A, B = eps.A, eps.B
        n = eps.n
        L = min(self.blocksize, n)
        M = max(1, min(self.moments, n // max(L, 1)))
        npt = self.npoints
        real_op = not A.dtype.is_complex
        cdt, device = solve_dtype(A, B), A.device
        mode = _mode(eps, A, B)
        if mode == "batched" and isinstance(A, AIJOperator):
            A = A.fast_form()  # a few dense diagonals run on the DIA kernels

        z, w = rg.contour(npt)
        rng = np.random.default_rng(0)
        V = torch.from_numpy(rng.standard_normal((n, L))).to(device)
        host = None  # the host pencil, built when a point needs an LU

        for it in range(self.refine + 1):
            eps.its = it + 1
            Vr = V.T.contiguous().to(cdt if V.is_complex() else A.dtype)
            BV = (op_mult_block(B, Vr) if B is not None else Vr).to(cdt)
            if mode == "batched":
                S, host = self._batched_moments(eps, A, B, z, w, BV, M, host)
            else:
                if host is None:
                    host = _HostPencil(A, B)
                BVh = BV.cpu().numpy().T

                def point_solve(j):
                    # (z_j B - A) Y = B V: one factorization a point (the
                    # reference's per-subcommunicator KSP, ciss.c:283-316)
                    return host.solve(z[j], BVh)

                Ys = thread_map(point_solve, range(npt))
                Sh = np.zeros((n, M * L), dtype=complex)
                for j in range(npt):
                    zk = 1.0
                    for k in range(M):
                        Sh[:, k * L: (k + 1) * L] += (w[j] * zk) * Ys[j]
                        zk *= z[j]
                S = torch.from_numpy(np.ascontiguousarray(Sh.T)).to(device,
                                                                    cdt)
            # S rows: block k (L rows) is S_k^T; columns from here on
            Sc = S.T
            extraction = getattr(eps, "ciss_extraction", self.extraction)
            if extraction == "hankel":
                lam, X, errs = self._hankel(A, B, Sc, L, M, n, rg)
            else:
                lam, X, errs = self._rayleigh_ritz(A, B, Sc, rg)
            eps.monitor(eps, eps.its, int(np.sum(errs < eps.tol)), lam, errs)
            if lam.size and np.max(errs) < eps.tol:
                break
            # refinement: the next probing block from the current vectors
            if extraction == "hankel":
                V = X.real if real_op else X
                V = self._fill(V, L, n, rng)
            elif lam.size:
                if real_op:
                    sgn = np.sign(rng.standard_normal(X.shape[1]))
                    V = (X * torch.from_numpy(sgn).to(device, X.real.dtype)
                         [None, :]).real
                else:
                    V = X
                V = self._fill(V, L, n, rng)
            else:
                V = torch.from_numpy(rng.standard_normal((n, L))).to(device)

        # the pairs whose residual passes 100 tol, in real order (the
        # reference counts them but returns the first nconv in real order,
        # converged or not: a spurious Hankel value inside the region then
        # displaces a converged one; ROADMAP.md queue 3)
        conv = np.flatnonzero(errs < eps.tol * 100)
        eps.nconv = int(conv.size)
        lam, errs = lam[conv], errs[conv]
        if eps.is_hermitian and np.all(np.abs(lam.imag) < 1e-10):
            lam = lam.real
        eps.eigenvalues = lam
        eps.errests = errs
        eps._eigenvectors = X[:, torch.from_numpy(conv).to(device)].T \
            .contiguous()

    @staticmethod
    def _fill(V: torch.Tensor, L: int, n: int, rng) -> torch.Tensor:
        """The first L columns of V, padded with seeded normals to L."""
        if V.shape[1] < L:
            pad = torch.from_numpy(rng.standard_normal((n, L - V.shape[1])))
            return torch.cat([V, pad.to(V.device, V.dtype)], dim=1)
        return V[:, :L]

    def _batched_moments(self, eps, A, B, z, w, BV, M: int, host):
        """S (M L, n) accumulated on the device from the batched solves,
        with the stall check and the host re-solve of stalled points."""
        L, n = BV.shape
        npt = len(z)
        tol_in = max(eps.tol * 1e-2, 1e-12)
        if getattr(eps, "ciss_adaptive", True):
            # point j's solve error enters the moments as w_j z_j^k E_j, so
            # points with small |w_j z_j^k| may be solved proportionally
            # looser without moving S_k (the contour machinery's role,
            # slepccontour.c:22-118); buckets make that fewer products
            zmag = np.maximum(np.abs(z), 1.0) ** max(M - 1, 0)
            contrib = np.abs(w) * zmag
            contrib = np.maximum(contrib, contrib.max() * 1e-12)
            tols = np.clip(tol_in * contrib.max() / contrib, tol_in, 1e-3)
            nbk = 3
        else:
            tols = np.full(npt, tol_in)
            nbk = 1
        zk_pow = np.power.outer(z, np.arange(M)) * w[:, None]  # (npt, M)
        S = torch.zeros((M * L, n), dtype=BV.dtype, device=BV.device)
        nrm_bv = max(float(torch.linalg.vector_norm(BV)), 1e-300)
        point_res = np.empty(npt)
        bad_all: list[int] = []
        state = {"host": host}

        def consume(idx, Yb):
            # stall detection: a point near an eigenvalue of the pencil is
            # ill-conditioned and may stop far from its tolerance; check
            # each point's relative residual and solve the offenders again
            # with an exact host factorization
            zb = torch.from_numpy(np.asarray(z[idx], complex)).to(
                Yb.device, Yb.dtype)[:, None, None]
            BY = _block_mult(B, Yb) if B is not None else Yb
            Rb = zb * BY - _block_mult(A, Yb) - BV[None]
            res = torch.linalg.vector_norm(Rb.reshape(len(idx), -1), dim=1)
            point_res[idx] = res.cpu().numpy() / nrm_bv
            del Rb, BY
            for p in np.flatnonzero(point_res[idx] > 1e3 * tol_in):
                if state["host"] is None:
                    state["host"] = _HostPencil(A, B)
                if "BVh" not in state:
                    state["BVh"] = BV.cpu().numpy().T
                Yp = state["host"].solve(z[idx[p]], state["BVh"])
                Yb[p] = torch.from_numpy(np.ascontiguousarray(Yp.T)).to(
                    Yb.device, Yb.dtype)
                bad_all.append(int(idx[p]))
            # S_k += sum_j w_j z_j^k Y_j over this bucket's points
            coef = torch.from_numpy(np.ascontiguousarray(zk_pow[idx].T)).to(
                Yb.device, Yb.dtype)
            S.view(M, L * n).add_(coef @ Yb.reshape(len(idx), L * n))

        _, info = batched_shifted_solves_adaptive(
            A, B, z, BV, tols=tols, nbuckets=nbk, consume=consume)
        eps.ciss_inner_iters = info["inner_iters"]
        eps.ciss_inner_buckets = info["buckets"]
        eps.ciss_point_residuals = point_res
        if bad_all:
            eps.ciss_refactored_points = sorted(bad_all)
        return S, state["host"]

    def _finish(self, A, B, wv: np.ndarray, Xc: torch.Tensor, rg,
                drop_zero: bool):
        """Keep the pairs inside the region, normalize the vectors, their
        residuals; sorted by real part.  ``drop_zero``: leave out zero
        vectors (Hankel) instead of keeping them unscaled (Rayleigh-Ritz)."""
        inside = np.flatnonzero(rg.check_inside(wv) >= 0)
        wv = wv[inside]
        Xc = Xc[:, torch.from_numpy(inside).to(Xc.device)]
        nrm = torch.linalg.vector_norm(Xc, dim=0).cpu().numpy()
        if drop_zero:
            ok = np.flatnonzero(nrm > 1e-12)
            wv, nrm = wv[ok], nrm[ok]
            Xc = Xc[:, torch.from_numpy(ok).to(Xc.device)]
        else:
            nrm[nrm == 0] = 1
        Xc = Xc / torch.from_numpy(nrm).to(Xc.device, Xc.real.dtype)[None, :]
        wt = torch.from_numpy(np.asarray(wv, complex)).to(Xc.device, Xc.dtype)
        BX = _cols_mult(B, Xc) if B is not None else Xc
        R = _cols_mult(A, Xc) - BX * wt[None, :]
        rn = torch.linalg.vector_norm(R, dim=0).cpu().numpy()
        errs = rn / np.maximum(np.abs(wv), 1e-300)
        order = np.argsort(wv.real)
        return wv[order], Xc[:, torch.from_numpy(order).to(Xc.device)], \
            errs[order]

    def _rayleigh_ritz(self, A, B, Sc: torch.Tensor, rg):
        """Rayleigh-Ritz on a rank-revealing basis of the moments
        (BVSVDAndRank analog)."""
        U, s, _ = _thin_svd(Sc)
        Q = U[:, : _rank(s)]
        G = (Q.conj().T @ _cols_mult(A, Q)).cpu().numpy()
        if B is not None:
            Mg = (Q.conj().T @ _cols_mult(B, Q)).cpu().numpy()
        else:
            Mg = np.eye(Q.shape[1], dtype=complex)
        wv, C = sla.eig(G, Mg)
        Xc = Q @ torch.from_numpy(C).to(Q.device, Q.dtype)
        return self._finish(A, B, wv, Xc, rg, drop_zero=False)

    def _hankel(self, A, B, Sc: torch.Tensor, L: int, M: int, n: int, rg):
        """Block-Hankel (Beyn) extraction: eigenvalues directly from the
        moment pencil (reference EPS_CISS_EXTRACTION_HANKEL)."""
        mhat = M // 2
        Sk = [Sc[:, k * L: (k + 1) * L] for k in range(M)]
        H0 = torch.cat([torch.cat([Sk[i + j] for j in range(mhat)], dim=1)
                        for i in range(mhat)])
        H1 = torch.cat([torch.cat([Sk[i + j + 1] for j in range(mhat)], dim=1)
                        for i in range(mhat)])
        U, s, Wh = _thin_svd(H0)
        rk = _rank(s)
        U1, s1 = U[:, :rk], s[:rk]
        W1 = torch.from_numpy(np.ascontiguousarray(Wh[:rk, :].conj().T)).to(
            U.device, U.dtype)
        Bm = (U1.conj().T @ H1 @ W1).cpu().numpy() / s1[None, :]
        wv, Yb = np.linalg.eig(Bm)
        Xc = U1[:n, :] @ torch.from_numpy(Yb).to(U.device, U.dtype)
        return self._finish(A, B, wv, Xc, rg, drop_zero=True)


EPS.register("ciss", CISS)
