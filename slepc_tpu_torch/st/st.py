"""ST — spectral transformations (``slepc_tpu/st/st.py``).

Ported so far: :class:`STShift` with sigma = 0, the identity transformation
the Krylov-Schur fast path runs.  A nonzero shift, shift-and-invert,
Cayley, precond, filter and shell transformations are still to be ported
(ROADMAP.md, queue 1, item 9).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..mat.linop import LinearOperator


class STShift:
    """The operator A itself (sigma = 0); ``back_transform`` is x + sigma."""

    name = "shift"
    requires_rayleigh = False

    def __init__(self, matrices: Sequence[LinearOperator], sigma: float = 0.0):
        if sigma != 0 or len(matrices) != 1:
            raise NotImplementedError(
                "only STShift with sigma = 0 on a standard problem is ported "
                "(ROADMAP.md, queue 1, item 9)")
        self.mats: List[LinearOperator] = list(matrices)
        self.sigma = sigma

    @property
    def A(self) -> LinearOperator:
        return self.mats[0]

    def op(self) -> LinearOperator:
        return self.A

    def back_transform(self, x):
        return np.asarray(x) + self.sigma
