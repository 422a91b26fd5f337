"""Device-side shift-and-invert: iterative inner solves on the card
(``slepc_tpu/st/sinvert_jit.py``).

The transformed operator

    M = D^{1/2} (A - sigma B)^{-1} D^{1/2}      (B = diag(d) SPD)
    M = (A - sigma I)^{-1}                      (standard)

applies a fixed-iteration CG (definite) or MINRES (indefinite) inner solve
(``ksp/iterative_jit.py``) whose SpMV is the DIA kernel K1/K2, so a whole
shift-and-invert Krylov-Schur solve runs on the card with one host read per
outer column and none inside the inner solve.  The diagonal-B
symmetrization keeps the identity metric, so the Hermitian fast path
(``eps/ks_jit.py``) runs unchanged; eigenvalues back-transform as
lambda = sigma + 1/theta and eigenvectors as x = D^{-1/2} u.

A general (non-diagonal) SPD B goes through the general GHEP loop with a
B-metric basis (``STSinvert``, ``eps/krylovschur.py``).

Vectors are flat (n,): the reference's padded-layout surface
(``pad2d / unpad / mask2d / n_pad``), its pytree methods and its
double-single choice are TPU machinery and have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ksp.iterative_jit import cg_fixed, minres_fixed
from ..mat.linop import DIAOperator, LinearOperator, as_operand
from .st import ST


class SinvertCGOperator(LinearOperator):
    """Self-adjoint shift-invert operator on flat vectors.

    ``Sop``: a :class:`DIAOperator` for A - sigma B; ``dhalf``: the D^{1/2}
    vector (None for standard problems); ``invdiag``: an optional Jacobi
    preconditioner vector; ``iters`` inner steps of ``method`` ('cg' or
    'minres').
    """

    def __init__(self, Sop: DIAOperator, dhalf: Optional[torch.Tensor] = None,
                 invdiag: Optional[torch.Tensor] = None, iters: int = 200,
                 method: str = "cg"):
        if method not in ("cg", "minres"):
            raise ValueError(f"inner solve {method!r} is not 'cg' or 'minres'")
        self.Sop = Sop
        self.dhalf = dhalf
        self.invdiag = invdiag
        self.iters = int(iters)
        self.method = method
        self.shape = Sop.shape
        self.dtype = Sop.dtype
        self.device = Sop.device

    @classmethod
    def from_dia(cls, A: DIAOperator, sigma: float = 0.0, b_diag=None,
                 iters: int = 200, method: str = "cg") -> "SinvertCGOperator":
        """Build from a DIAOperator A and an optional diagonal SPD metric
        ``b_diag`` ((n,) tensor or array), on A's device."""
        dev, dt = A.device, A.dtype
        if b_diag is not None and not torch.is_tensor(b_diag):
            b_diag = torch.from_numpy(np.ascontiguousarray(b_diag))
        if b_diag is not None:
            b_diag = b_diag.to(dev, dt)
        offsets = list(A.offsets)
        diags = A.diags
        if 0 not in offsets:
            offsets.append(0)
            diags = torch.cat([diags, torch.zeros((1, diags.shape[1]),
                                                  dtype=dt, device=dev)])
        i0 = offsets.index(0)
        if sigma != 0.0:
            diags = diags.clone()
            diags[i0] -= sigma * (b_diag if b_diag is not None else 1.0)
        order = sorted(range(len(offsets)), key=offsets.__getitem__)
        Sop = DIAOperator(tuple(offsets[i] for i in order),
                          diags[order], shape=A.shape)
        dhalf = torch.sqrt(b_diag) if b_diag is not None else None
        d0 = diags[i0].abs()
        # Jacobi preconditioning only helps variable-diagonal systems; keep
        # it off for (near-)constant diagonals
        dmin = torch.where(d0 > 0, d0, torch.full_like(d0, 1e30)).min()
        spread = float(d0.max() / dmin.clamp_min(1e-30))
        invdiag = None
        if method == "cg" and spread > 4.0:
            dd = diags[i0]
            invdiag = torch.where(dd != 0, 1.0 / torch.where(
                dd != 0, dd, torch.ones_like(dd)), torch.zeros_like(dd))
        return cls(Sop, dhalf, invdiag, iters=iters, method=method)

    @property
    def nnz(self) -> int:
        return int(self.Sop.nnz) * max(self.iters, 1)

    def postprocess_vec(self, u: torch.Tensor) -> torch.Tensor:
        """Transformed-space eigenvector u -> original x = D^{-1/2} u."""
        if self.dhalf is None:
            return u
        return torch.where(self.dhalf > 0, u / torch.where(
            self.dhalf != 0, self.dhalf, torch.ones_like(u)),
            torch.zeros_like(u))

    def _solve(self, b: torch.Tensor) -> torch.Tensor:
        if self.method == "minres":
            return minres_fixed(self.Sop.mult, b, self.iters)
        Minv = None
        if self.invdiag is not None:
            invd = self.invdiag
            Minv = lambda r: r * invd
        return cg_fixed(self.Sop.mult, b, self.iters, Minv=Minv)

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = as_operand(x, "SinvertCGOperator.mult", self.dtype,
                           self.device, self.shape[1])
        if self.dhalf is None:
            return self._solve(x)
        return self._solve(x * self.dhalf) * self.dhalf

    mult_h = mult  # self-adjoint by construction


class STSinvertDevice(ST):
    """ST wrapper for the device iterative shift-invert tier.

    matrices = [A] or [A, B] with A a DIAOperator and B a DIAGONAL
    DIAOperator (offsets (0,)); lambda = sigma + 1/theta.  Runs through the
    Hermitian Krylov-Schur fast path (the symmetrization keeps the identity
    metric).
    """

    name = "sinvert-device"

    def __init__(self, matrices, sigma: complex = 0.0, iters: int = 200,
                 method: str = "cg"):
        super().__init__(matrices, sigma)
        self.iters = int(iters)
        self.method = method
        if not isinstance(self.A, DIAOperator):
            raise ValueError("STSinvertDevice needs a DIAOperator A")
        if self.B is not None and (not isinstance(self.B, DIAOperator)
                                   or tuple(self.B.offsets) != (0,)):
            raise ValueError(
                "STSinvertDevice needs a diagonal B (a DIAOperator with "
                "offsets (0,)); a general SPD B goes through STSinvert and "
                "the general GHEP loop")

    def _compute_operator(self) -> SinvertCGOperator:
        b_diag = self.B.diags[0] if self.B is not None else None
        return SinvertCGOperator.from_dia(
            self.A, sigma=float(np.real(self.sigma)), b_diag=b_diag,
            iters=self.iters, method=self.method)

    def back_transform(self, eigs):
        return self.sigma + 1.0 / np.asarray(eigs)

    def eig_map(self, lam):
        return 1.0 / (lam - self.sigma)
