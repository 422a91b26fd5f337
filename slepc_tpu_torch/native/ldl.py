"""ctypes binding for the native sparse LDL^T factorization (native/ldl.cpp):
the port's own copy of ``slepc_tpu/native/ldl.py``.

Provides factor-once/solve-many symmetric sparse solves WITH inertia — the
role PETSc's Cholesky/LDL^T factorizations play for the reference's
shift-and-invert and spectrum slicing (MatGetInertia,
ks-slice.c:227-258).  SciPy's SuperLU gives no inertia, so this is the
native component that completes the slicing path for general symmetric
sparsity.

The shared library is compiled on first use with g++ (plain C ABI + ctypes)
from the repository's ``native/ldl.cpp`` into the package's git-ignored
``_build/`` directory, beside the CUDA kernels' library.  Fill-reducing
ordering: reverse Cuthill-McKee from scipy.  Host only: the factorization
runs on the CPU, and ``ksp/direct.py`` moves each right-hand side over and
back.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()
_SRC = Path(__file__).resolve().parents[2] / "native" / "ldl.cpp"
_SO = Path(__file__).resolve().parents[1] / "_build" / "libldl.so"


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        if not _SO.exists():
            if not _SRC.exists():
                return None
            _SO.parent.mkdir(parents=True, exist_ok=True)
            tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-std=c++17", str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                return None  # no g++, or the build failed: not available
            os.replace(tmp, _SO)
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            return None
        lib.ldl_factor.restype = ctypes.c_void_p
        lib.ldl_factor.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_double,
        ]
        lib.ldl_inertia.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_int64)] * 3
        lib.ldl_solve.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float64, flags=("C_CONTIGUOUS", "WRITEABLE")),
            ctypes.c_int64,
        ]
        lib.ldl_nnz.restype = ctypes.c_int64
        lib.ldl_nnz.argtypes = [ctypes.c_void_p]
        lib.ldl_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def ldl_available() -> bool:
    return _load() is not None


class LDLFactorization:
    """Factor a symmetric sparse matrix once; solve/inertia many times."""

    def __init__(self, A, pivot_tol: float = 1e-14):
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        lib = _load()
        if lib is None:
            raise RuntimeError("native LDL library unavailable (g++ build failed)")
        self._lib = lib
        A = sp.csr_matrix(A).astype(np.float64)
        A.sum_duplicates()
        self.n = A.shape[0]
        perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                          dtype=np.int64)
        Ap = np.asarray(A.indptr, dtype=np.int64)
        Ai = np.asarray(A.indices, dtype=np.int64)
        Ax = np.ascontiguousarray(A.data, dtype=np.float64)
        self._handle = lib.ldl_factor(self.n, Ap, Ai, Ax, perm, pivot_tol)
        if not self._handle:
            raise RuntimeError("LDL factorization failed")

    def inertia(self) -> Tuple[int, int, int]:
        neg = ctypes.c_int64()
        zero = ctypes.c_int64()
        pos = ctypes.c_int64()
        self._lib.ldl_inertia(self._handle, ctypes.byref(neg),
                              ctypes.byref(zero), ctypes.byref(pos))
        return neg.value, zero.value, pos.value

    @property
    def factor_nnz(self) -> int:
        return int(self._lib.ldl_nnz(self._handle))

    def solve(self, b: np.ndarray) -> np.ndarray:
        b = np.asarray(b, dtype=np.float64)
        onedim = b.ndim == 1
        B = b[:, None] if onedim else b
        # column-major per-rhs contiguous layout
        work = np.ascontiguousarray(B.T.reshape(-1)).copy()
        self._lib.ldl_solve(self._handle, work, B.shape[1])
        X = work.reshape(B.shape[1], self.n).T
        return X[:, 0] if onedim else X

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.ldl_free(self._handle)
                self._handle = None
        except Exception:
            pass
