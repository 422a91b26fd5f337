"""Eigenvalue sorting criteria (the SlepcSC analog).

Reference: src/sys/slepcsc.c — ``SlepcSCCompare`` comparators for
largest/smallest magnitude/real/imaginary, target magnitude/real/imaginary,
and arbitrary user maps (slepcsc.c:152-289).  Here a criterion is a vector
predicate: given arrays of eigenvalue approximations it returns a sort key;
``argsort`` orders best-first (the order in which eigenvalues are locked).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


class Which(enum.Enum):
    """Which eigenvalues to compute (reference: include/slepceps.h EPSWhich)."""

    LARGEST_MAGNITUDE = "largest_magnitude"
    SMALLEST_MAGNITUDE = "smallest_magnitude"
    LARGEST_REAL = "largest_real"
    SMALLEST_REAL = "smallest_real"
    LARGEST_IMAGINARY = "largest_imaginary"
    SMALLEST_IMAGINARY = "smallest_imaginary"
    TARGET_MAGNITUDE = "target_magnitude"
    TARGET_REAL = "target_real"
    TARGET_IMAGINARY = "target_imaginary"
    ALL = "all"  # all in an interval / region (spectrum slicing, CISS)
    USER = "user"


@dataclass
class SortCriterion:
    """Orders eigenvalue approximations best-first.

    ``keyfn`` maps a complex ndarray of eigenvalues to real keys,
    *smaller = better* (sorted ascending).  ``mapfn`` optionally transforms
    eigenvalues before comparison (the reference routes comparisons through
    the ST map so sorting happens in the transformed spectrum,
    slepcsc.c:40-66).
    """

    which: Which = Which.LARGEST_MAGNITUDE
    target: complex = 0.0
    comparison: Optional[Callable[[np.ndarray], np.ndarray]] = None  # user keyfn
    mapfn: Optional[Callable[[np.ndarray], np.ndarray]] = None

    def keys(self, eigs: np.ndarray) -> np.ndarray:
        ev = np.asarray(eigs)
        if self.mapfn is not None:
            ev = self.mapfn(ev)
        w = self.which
        if w == Which.USER:
            if self.comparison is None:
                raise ValueError("Which.USER requires a comparison function")
            return np.asarray(self.comparison(ev), dtype=float)
        if w == Which.LARGEST_MAGNITUDE:
            return -np.abs(ev)
        if w == Which.SMALLEST_MAGNITUDE:
            return np.abs(ev)
        if w == Which.LARGEST_REAL:
            return -np.real(ev)
        if w == Which.SMALLEST_REAL:
            return np.real(ev)
        if w == Which.LARGEST_IMAGINARY:
            # match reference: in real arithmetic compares |imag| (slepcsc.c:231)
            return -np.abs(np.imag(ev)) if not np.iscomplexobj(ev) else -np.imag(ev)
        if w == Which.SMALLEST_IMAGINARY:
            return np.abs(np.imag(ev)) if not np.iscomplexobj(ev) else np.imag(ev)
        if w == Which.TARGET_MAGNITUDE:
            return np.abs(ev - self.target)
        if w == Which.TARGET_REAL:
            return np.abs(np.real(ev) - np.real(self.target))
        if w == Which.TARGET_IMAGINARY:
            return np.abs(np.imag(ev) - np.imag(self.target))
        if w == Which.ALL:
            return np.real(ev)  # ascending through the interval
        raise ValueError(f"unknown Which: {w}")

    def argsort(self, eigs: np.ndarray) -> np.ndarray:
        """Indices ordering ``eigs`` best-first (stable)."""
        return np.argsort(self.keys(eigs), kind="stable")


def sort_eigenvalues(sc: SortCriterion, eigs, vectors=None):
    """Sort eigenvalues best-first (and the matching eigenvector columns of
    an (n, k) numpy array or tensor): ``SlepcSortEigenvalues``
    (slepcsc.c:89).  Returns (eigs, perm) or (eigs, vectors, perm)."""
    perm = sc.argsort(eigs)
    eigs = np.asarray(eigs)[perm]
    if vectors is None:
        return eigs, perm
    if torch.is_tensor(vectors):
        return eigs, vectors[:, torch.from_numpy(perm).to(vectors.device)], \
            perm
    return eigs, np.asarray(vectors)[:, perm], perm
