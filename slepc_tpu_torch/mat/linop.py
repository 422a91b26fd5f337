"""Linear operators — the Mat tier on PyTorch tensors.

Ported so far: the abstract :class:`LinearOperator` and the diagonal-offset
:class:`DIAOperator` (``slepc_tpu/mat/linop.py:40,183``).  An operator's
tensors live on one device, and its ``mult`` runs there: a CUDA tensor goes
to the hand-written DIA kernel (``ops/dia.py``), a CPU tensor to its plain
PyTorch version.  The dense, AIJ, shell and algebra operators are still to
be ported (ROADMAP.md, queue 1, "Remainders of items 1-7").
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.dia import dia_spmv


class LinearOperator:
    """Abstract operator A: R^n -> R^m; ``mult(x)`` computes A @ x for a
    vector ``x`` of shape (n,) on the operator's device."""

    shape: Tuple[int, int]
    dtype: torch.dtype
    device: torch.device

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        """Nonzero count for flop accounting (dense ≙ m*n)."""
        return self.shape[0] * self.shape[1]

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, x):
        return self.mult(x)


class DIAOperator(LinearOperator):
    """Diagonal-offset (DIA) storage for stencil/banded matrices.

    y[i] = sum_d diags[d][i] * x[i + offsets[d]], with x taken as zero
    outside [0, n) (slepc_tpu pre-zeroes those entries of ``diags``; the
    kernel's bounds check makes that optional).  ``diags`` is a (ndiag, n)
    tensor; a numpy array is taken over as is onto ``device``.
    """

    def __init__(self, offsets: Sequence[int], diags, shape=None,
                 device=None):
        self.offsets = tuple(int(o) for o in offsets)
        if not torch.is_tensor(diags):
            diags = torch.from_numpy(np.ascontiguousarray(diags))
        if device is not None:
            diags = diags.to(device)
        self.diags = diags.contiguous()
        n = self.diags.shape[1]
        self.shape = tuple(shape) if shape is not None else (n, n)
        self.dtype = self.diags.dtype
        self.device = self.diags.device

    @property
    def nnz(self):
        # exact: padding entries in diags are zero but stored; report the
        # true nonzero budget for flop/byte accounting
        n = self.shape[0]
        return int(sum(n - abs(o) for o in self.offsets))

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        return dia_spmv(self.offsets, self.diags, x)
