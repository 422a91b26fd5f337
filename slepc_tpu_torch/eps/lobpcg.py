"""EPS LOBPCG -- locally optimal block preconditioned conjugate gradient
(``slepc_tpu/eps/lobpcg.py``).

Reference: src/eps/impls/cg/lobpcg/lobpcg.c (699 LoC): blocked iteration on
[X, W, P] with Rayleigh-Ritz, the preconditioner from STPRECOND, soft
locking.  Two paths, as in the reference:

  * the chunk (:func:`lobpcg_cycle`), for a standard problem with no
    preconditioner on a DIA, CSR or dense operator: ``lobpcg_chunk``
    iterations between host reads of the Ritz values and residuals; W and P
    are orthonormalized by SVQB, whose null directions (P on the first
    iteration, W at convergence) leave the Rayleigh-Ritz (the reference
    keeps its shapes static and pushes them to the far end with a
    (1/eps)^1.5 diagonal penalty instead: the same wanted pairs);
  * the host loop, with B and ``STPrecond``: W and P B-orthonormalized
    blockwise against the previous blocks with rank truncation (dropping
    near-dependent directions) before the Rayleigh-Ritz.

Layout and kernels: the blocks X, W, P are row-major (bs, n) tensors; their
operator products go through ``mult_block`` (kernel K5 for a DIA
operator).  The small Gram matrices (at most 3 bs square) and the block
combinations are plain matrix products, as the reference computes them with
``@`` outside any Pallas kernel; the small eigenproblems are LAPACK on the
host.  The start block is drawn with numpy's ``default_rng(0)``, as the
reference draws it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mat.linop import AIJOperator, DenseOperator, DIAOperator
from ..st.st import STPrecond
from .base import EPS, EPSSolver, op_mult_block


def _dots(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """C[k, p] = <X_k, Y_p> for row blocks X, Y (the reference's X^H Y)."""
    return X.conj() @ Y.T


def _host_herm(G: torch.Tensor) -> np.ndarray:
    G = G.cpu().numpy()
    return 0.5 * (G + G.conj().T)


def _combine(C: np.ndarray, S: torch.Tensor) -> torch.Tensor:
    """Rows of S combined by the columns of C (the reference's S @ C)."""
    return torch.from_numpy(np.ascontiguousarray(C.T)).to(S.device,
                                                          S.dtype) @ S


def _svqb(S: torch.Tensor, eps_mach: float) -> torch.Tensor:
    """SVQB of the rows of S, keeping only its good directions (those whose
    Gram eigenvalue passes eps times the largest): a (k, n) orthonormal
    block, k <= rows of S."""
    lam, U = np.linalg.eigh(_host_herm(_dots(S, S)))
    good = lam > eps_mach * max(lam[-1], eps_mach)
    return _combine(U[:, good] / np.sqrt(lam[good])[None, :], S)


def lobpcg_cycle(op, X: torch.Tensor, P: torch.Tensor, bs: int,
                 k_iters: int, largest: bool):
    """``k_iters`` LOBPCG iterations on a standard problem with no
    preconditioner, then the Ritz rotation.  X is (bs, n) orthonormal, P
    (at most bs, n) the previous search directions (zero rows on the first
    call).  Returns (X, P, theta, resid) with theta in wanted-first order
    and resid the residual norms of the Ritz pairs, numpy arrays."""
    eps_mach = float(torch.finfo(X.dtype).eps)
    sgn = -1.0 if largest else 1.0
    for _ in range(k_iters):
        AX = op_mult_block(op, X)
        R = AX - _dots(X, AX).T @ X  # the full projected residual
        W = _svqb(R - _dots(X, R).T @ X, eps_mach)
        Pp = _svqb(P - _dots(X, P).T @ X - _dots(W, P).T @ W, eps_mach)
        S = torch.cat([X, W, Pp])
        Gs = _host_herm(_dots(S, op_mult_block(op, S)))
        _, C = np.linalg.eigh(sgn * Gs)
        C = C[:, :bs]
        Cp = C.copy()
        Cp[:bs, :] = 0.0  # the W and P parts of the new X
        P = _combine(Cp, S)
        X = _svqb(_combine(C, S), eps_mach)  # keeps X well conditioned
    AX = op_mult_block(op, X)
    w, C = np.linalg.eigh(sgn * _host_herm(_dots(X, AX)))
    theta = sgn * w
    X = _combine(C, X)
    th = torch.from_numpy(theta.copy()).to(X.device, X.dtype)
    R = _combine(C, AX) - th[:, None] * X
    resid = torch.linalg.vector_norm(R, dim=1).cpu().numpy()
    return X, P, theta, resid


def _b_orthonormalize(S, BS, drop_tol=1e-8):
    """B-orthonormalize the rows of S (given BS = B S) with truncation.

    Returns (S', BS', rows kept); rows spanning near-null Gram directions
    are dropped."""
    lam, U = np.linalg.eigh(_host_herm(_dots(S, BS)))
    keep = lam > drop_tol * max(lam[-1], 1e-300)
    if not np.any(keep):
        return None, None, 0
    T = U[:, keep] / np.sqrt(lam[keep])[None, :]
    return _combine(T, S), _combine(T, BS), int(keep.sum())


def _precond_rows(precond, R: torch.Tensor) -> torch.Tensor:
    """The preconditioner (which takes (n,) or (n, k) columns) on the rows
    of R."""
    return precond(R.T).T.contiguous()


class LOBPCG(EPSSolver):
    def solve(self, eps: EPS) -> None:
        if not eps.is_hermitian:
            raise ValueError("lobpcg requires a Hermitian problem type")
        st = eps.st
        A, B = eps.A, eps.B
        n = eps.n
        dtype, device = A.dtype, A.device
        cplx = dtype.is_complex
        bs = min(max(eps.nev, 1),
                 getattr(eps, "lobpcg_blocksize", max(eps.nev, 4)))
        largest = eps.which.value.startswith("largest")
        sgn = -1.0 if largest else 1.0

        precond = st.preconditioner() if isinstance(st, STPrecond) \
            else (lambda r: r)

        def bmult(V):
            return op_mult_block(B, V) if B is not None else V

        rng = np.random.default_rng(0)
        X = rng.standard_normal((n, bs))
        if cplx:
            X = X + 1j * rng.standard_normal((n, bs))
        if eps.initial_space is not None:
            k0 = min(eps.initial_space.shape[1], bs)
            X[:, :k0] = eps.initial_space[:, :k0]
        Xj = torch.from_numpy(np.ascontiguousarray(X.T)).to(device, dtype)
        Xj, BX, _ = _b_orthonormalize(Xj, bmult(Xj))
        P = BP = None

        theta = np.zeros(bs)
        errs = np.full(bs, np.inf)
        nconv = 0

        if (B is None and not isinstance(st, STPrecond)
                and isinstance(A, (AIJOperator, DenseOperator, DIAOperator))):
            chunk = int(getattr(eps, "lobpcg_chunk", 8) or 8)
            Pj = torch.zeros_like(Xj)
            while eps.its < eps.max_it:
                eps.its += chunk
                Xj, Pj, theta, rn = lobpcg_cycle(A, Xj, Pj, bs=bs,
                                                 k_iters=chunk,
                                                 largest=largest)
                theta = np.asarray(theta, dtype=float)
                errs = np.array([eps.conv_measure(theta[i], rn[i])
                                 for i in range(bs)])
                nconv = 0
                for i in range(bs):
                    if errs[i] < eps.tol:
                        nconv += 1
                    else:
                        break
                eps.monitor(eps, eps.its, nconv, theta, errs)
                if nconv >= eps.nev:
                    break
            k = min(nconv, bs)
            eps.nconv = k
            eps.eigenvalues = theta[:k].astype(float)
            eps.errests = errs[:k]
            eps._eigenvectors = Xj[:k].clone()
            return

        while eps.its < eps.max_it:
            eps.its += 1
            AX = op_mult_block(A, Xj)
            theta = (Xj.conj() * AX).sum(dim=1).real.cpu().numpy()
            R = AX - torch.from_numpy(theta.copy()).to(
                device, BX.real.dtype)[:, None] * BX
            rn = torch.linalg.vector_norm(R, dim=1).cpu().numpy()
            errs = np.array([eps.conv_measure(theta[i], rn[i])
                             for i in range(bs)])
            order = np.argsort(sgn * theta, kind="stable")
            nconv = 0
            for i in order:
                if errs[i] < eps.tol:
                    nconv += 1
                else:
                    break
            eps.monitor(eps, eps.its, nconv, theta[order], errs[order])
            if nconv >= eps.nev:
                break

            W = _precond_rows(precond, R)
            # W := (I - X X^H B) W, B-orthonormalized with truncation
            W = W - _dots(BX, W).T @ Xj
            W, BW, nw = _b_orthonormalize(W, bmult(W))
            if nw == 0:
                break  # residual space exhausted
            blocks, bblocks = [Xj, W], [BX, BW]
            if P is not None:
                Pp = P - _dots(BX, P).T @ Xj - _dots(BW, P).T @ W
                Pp, BPp, np_cols = _b_orthonormalize(Pp, bmult(Pp))
                if np_cols:
                    blocks.append(Pp)
                    bblocks.append(BPp)
            Sb = torch.cat(blocks)
            Gs = _host_herm(_dots(Sb, op_mult_block(A, Sb)))
            _, C = np.linalg.eigh(sgn * Gs)
            C = C[:, :bs]
            Cp = C.copy()
            Cp[:bs, :] = 0.0  # implicit P: the W / P parts of the new X
            BSb = torch.cat(bblocks)
            P, BP = _combine(Cp, Sb), _combine(Cp, BSb)
            Xj, BX = _combine(C, Sb), _combine(C, BSb)

        order = np.argsort(sgn * theta, kind="stable")
        theta, errs = theta[order], errs[order]
        k = min(nconv, bs)
        eps.nconv = k
        eps.eigenvalues = theta[:k].astype(float)
        eps.errests = errs[:k]
        eps._eigenvectors = Xj[torch.from_numpy(order[:k]).to(device)]


EPS.register("lobpcg", LOBPCG)
