"""DS -- dense projected solvers (``slepc_tpu/ds/types.py``).

Host-side classes over numpy / LAPACK, as in the reference: the small
(ncv x ncv) projected problem of each outer iteration is solved on the
host.  Ported: :class:`DS` (registry), :class:`DSHEP`, :class:`DSGHEP`
(the Hermitian Krylov-Schur loop), :class:`DSNHEP` (real or complex Schur
form, ``ds/schur.py``) and :class:`DSGNHEP` (ordered QZ), the types of the
non-Hermitian arm.  The two-sided, indefinite, SVD and polynomial types
wait for their solvers (ROADMAP.md, queue 1, items 11d, 12-15);
``DSHEP.solve_block_tridiag`` waits with the block divide-and-conquer
(``ds/bdc.py``, item 11d).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import scipy.linalg as sla

from . import schur as _schur


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


class DSNHEP(DS):
    """Non-Hermitian: Hessenberg -> (real / complex) Schur form, sorted by
    keys, eigenvectors from the Schur form (gehrd / hseqr / trexc /
    trevc analog)."""

    def solve(self, H: np.ndarray):
        return _schur.schur(H)  # (T, Q, eigs)

    def sort(self, T, Q, keys):
        return _schur.sort_schur(T, Q, keys)

    def vectors(self, T, Q):
        return _schur.schur_eigvectors(T, Q)  # (eigs, X)


class DSGNHEP(DS):
    """Generalized non-Hermitian (A, B) by the ordered QZ form (gges /
    tgexc analog); wanted-first is largest magnitude unless ``keys_fn``
    says otherwise."""

    def solve(self, A: np.ndarray, B: np.ndarray,
              keys_fn: Optional[Callable] = None):
        if keys_fn is None:
            keys_fn = lambda ev: -np.abs(ev)
        return _schur.ordered_qz(np.asarray(A), np.asarray(B), keys_fn)

    def vectors(self, S, T, Q, Z):
        """Right eigenvectors of (A, B) from the QZ form: X = Z Y."""
        lam, Y = sla.eig(S, T)
        X = Z @ Y
        nrm = np.linalg.norm(X, axis=0)
        nrm[nrm == 0] = 1
        return lam, X / nrm
