"""DS -- dense projected solvers (``slepc_tpu/ds/types.py``).

Host-side classes over numpy / LAPACK, as in the reference: the small
(ncv x ncv) projected problem of each outer iteration is solved on the
host.  Ported: :class:`DS` (registry), :class:`DSHEP` and :class:`DSGHEP`,
the types the Hermitian Krylov-Schur loop uses.  The non-Hermitian,
indefinite, SVD and polynomial types wait for their solvers (ROADMAP.md,
queue 1, items 11-13); ``DSHEP.solve_block_tridiag`` waits with the block
divide-and-conquer (``ds/bdc.py``, item 11).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg as sla


class DS:
    """Base: registry + common helpers."""

    registry = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        DS.registry[cls.__name__.lower().replace("ds", "", 1)] = cls

    @staticmethod
    def create(name: str) -> "DS":
        return DS.registry[name.lower()]()


class DSHEP(DS):
    """Hermitian eigenproblem: full diagonalization of the projected H.
    The Schur form is diagonal, so 'truncate' / 'sort' are column
    selections."""

    def solve(self, H: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        H = np.asarray(H)
        return np.linalg.eigh(0.5 * (H + H.conj().T))

    def solve_tridiag(self, alpha: np.ndarray, beta: np.ndarray):
        """Tridiagonal fast path (steqr analog); LAPACK's divide and
        conquer (stevd) for large projected problems."""
        return sla.eigh_tridiagonal(
            alpha, beta,
            lapack_driver="stevd" if len(alpha) >= 256 else "auto")

    def sort(self, w, Q, keys):
        perm = np.argsort(np.asarray(keys), kind="stable")
        return w[perm], Q[:, perm]


class DSGHEP(DS):
    """Generalized Hermitian (A, B) with B > 0: sygvd analog."""

    def solve(self, A: np.ndarray, B: np.ndarray):
        w, X = sla.eigh(0.5 * (A + A.conj().T), 0.5 * (B + B.conj().T))
        return w, X  # X^H B X = I
