"""The port's dtype rule, in one place.

Every public constructor and function that takes ``dtype`` takes a torch
dtype or a numpy one (``np.float64``, ``np.complex128``, a ``np.dtype``, or
a name numpy reads, such as ``"float32"``), as the reference's take numpy
dtypes; each passes it through :func:`as_torch_dtype` (or
:func:`as_numpy_dtype` where it builds host data).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def as_torch_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype from a torch or numpy dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def as_numpy_dtype(dtype) -> Optional[np.dtype]:
    """A numpy dtype from a torch or numpy dtype (None stays None)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)
