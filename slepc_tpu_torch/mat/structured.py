"""Structured block matrices: 2x2 tiles and BSE Hamiltonians
(``slepc_tpu/mat/structured.py``).

A block structure is a shell operator over stacked (n1 + n2,) vectors: the
blocks apply in place, nothing is assembled.  ``create_tile`` is the role
of the reference's MatCreateTile (G = [a A, b B; c C, d D]); :class:`MatBSE`
of MatCreateBSE (H = [R C; -C^H -R^T], R Hermitian, C complex symmetric),
which carries its blocks for the structure-preserving BSE solvers
(``eps/bse.py``).  Each block applies through its own ``mult`` /
``mult_h`` (a DIA block on K1/K2, a CSR block on K6, a dense block as a
matrix product); a conjugate a block's kernel reads is a physical one
(``torch.conj_physical``: a kernel reads memory, not PyTorch's lazy
conjugate view).
"""

from __future__ import annotations

from typing import Optional

import torch

from .linop import LinearOperator, ShellOperator


def _conj(x: torch.Tensor) -> torch.Tensor:
    return torch.conj_physical(x) if x.is_complex() else x


def create_tile(a, A: Optional[LinearOperator], b, B: Optional[LinearOperator],
                c, C: Optional[LinearOperator], d, D: Optional[LinearOperator]
                ) -> ShellOperator:
    """G = [a*A b*B; c*C d*D] acting on stacked vectors (None block = 0)."""
    ops = [op for op in (A, B, C, D) if op is not None]
    if not ops:
        raise ValueError("at least one block required")
    m1 = next(op.shape[0] for op in (A, B) if op is not None)
    m2 = next(op.shape[0] for op in (C, D) if op is not None)
    n1 = next(op.shape[1] for op in (A, C) if op is not None)
    n2 = next(op.shape[1] for op in (B, D) if op is not None)
    dtype = ops[0].dtype
    for op in ops[1:]:
        dtype = torch.promote_types(dtype, op.dtype)
    nnz = sum(op.nnz for op in ops)

    def rows(x, sizes, terms, adjoint):
        """Each block row: sum of coef * op (or conj(coef) * op^H) on its
        part of x."""
        out = []
        for m, row in zip(sizes, terms):
            y = torch.zeros(m, dtype=torch.promote_types(dtype, x.dtype),
                            device=x.device)
            for coef, op, xi in row:
                if op is not None:
                    coef = complex(coef).conjugate() if adjoint else coef
                    coef = coef.real if complex(coef).imag == 0 else coef
                    y = y + coef * (op.mult_h(xi) if adjoint else op.mult(xi))
            out.append(y)
        return torch.cat(out)

    def matvec(x):
        x1, x2 = x[:n1], x[n1:]
        return rows(x, (m1, m2), (((a, A, x1), (b, B, x2)),
                                  ((c, C, x1), (d, D, x2))), False)

    def rmatvec(x):
        x1, x2 = x[:m1], x[m1:]
        return rows(x, (n1, n2), (((a, A, x1), (c, C, x2)),
                                  ((b, B, x1), (d, D, x2))), True)

    return ShellOperator((m1 + m2, n1 + n2), dtype, matvec, rmatvec, nnz=nnz,
                         device=ops[0].device)


class MatBSE(ShellOperator):
    """Bethe-Salpeter Hamiltonian H = [R C; -C^H -R^T].

    R is Hermitian, C symmetric (complex).  Carries its blocks so the
    structure-preserving EPS BSE variants can use them.
    """

    def __init__(self, R: LinearOperator, C: LinearOperator):
        self.R = R
        self.C = C
        n = R.shape[0]

        def matvec(x):
            x1, x2 = x[:n], x[n:]
            # -C^H x1 - R^T x2 = -C^H x1 - conj(R^H conj(x2))
            return torch.cat([R.mult(x1) + C.mult(x2),
                              -C.mult_h(x1) - _conj(R.mult_h(_conj(x2)))])

        def rmatvec(x):
            x1, x2 = x[:n], x[n:]
            # H^H = [R^H -C; C^H -conj(R)]; R Hermitian => R^H = R
            return torch.cat([R.mult_h(x1) - C.mult(x2),
                              C.mult_h(x1) - _conj(R.mult(_conj(x2)))])

        super().__init__((2 * n, 2 * n), torch.promote_types(R.dtype, C.dtype),
                         matvec, rmatvec, nnz=2 * (R.nnz + C.nnz),
                         device=R.device)


def create_bse(R: LinearOperator, C: LinearOperator) -> MatBSE:
    return MatBSE(R, C)
