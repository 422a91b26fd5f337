"""PETSc binary matrix/vector I/O (``slepc_tpu/mat/petsc_io.py``, copied so
that the port does not import the JAX package).

The reference's tests/tutorials load matrices from PETSc binary files
(share/slepc/datafiles/matrices/*.petsc; -eps_view_mat0 binary: viewers,
reference epssolve.c:110).  Format (big-endian int32/float64):
  Mat:  [1211216, nrows, ncols, nnz, rowlens[nrows], colidx[nnz], vals[nnz]]
  Vec:  [1211214, n, vals[n]]
Complex builds store float64 pairs; this reader handles real and complex.
"""

from __future__ import annotations

import numpy as np

from ..sys.dtypes import as_numpy_dtype

MAT_CLASSID = 1211216
VEC_CLASSID = 1211214


def read_petsc_matrix(path: str, dtype=np.float64):
    """Read a PETSc binary Mat into a scipy CSR matrix."""
    import scipy.sparse as sp

    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=">i4", count=4)
        if len(header) < 4 or header[0] != MAT_CLASSID:
            raise ValueError(f"{path}: not a PETSc binary Mat")
        nrows, ncols, nnz = (int(x) for x in header[1:4])
        rowlens = np.fromfile(f, dtype=">i4", count=nrows).astype(np.int64)
        colidx = np.fromfile(f, dtype=">i4", count=nnz).astype(np.int64)
        if np.issubdtype(as_numpy_dtype(dtype), np.complexfloating):
            raw = np.fromfile(f, dtype=">f8", count=2 * nnz)
            vals = raw[0::2] + 1j * raw[1::2]
        else:
            vals = np.fromfile(f, dtype=">f8", count=nnz).astype(np.float64)
    indptr = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(rowlens, out=indptr[1:])
    return sp.csr_matrix((vals, colidx, indptr), shape=(nrows, ncols))


def write_petsc_matrix(path: str, A) -> None:
    """Write a scipy sparse matrix as PETSc binary (real float64)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    with open(path, "wb") as f:
        np.array([MAT_CLASSID, A.shape[0], A.shape[1], A.nnz],
                 dtype=">i4").tofile(f)
        np.diff(A.indptr).astype(">i4").tofile(f)
        A.indices.astype(">i4").tofile(f)
        A.data.astype(">f8").tofile(f)


def read_petsc_vector(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=">i4", count=2)
        if len(header) < 2 or header[0] != VEC_CLASSID:
            raise ValueError(f"{path}: not a PETSc binary Vec")
        n = int(header[1])
        return np.fromfile(f, dtype=">f8", count=n).astype(np.float64)


def write_petsc_vector(path: str, v) -> None:
    v = np.asarray(v, dtype=np.float64)
    with open(path, "wb") as f:
        np.array([VEC_CLASSID, v.shape[0]], dtype=">i4").tofile(f)
        v.astype(">f8").tofile(f)


def load_operator(path: str, dtype=np.float64, device=None):
    """Load a PETSc binary Mat as an AIJOperator on ``device`` (default: the
    card)."""
    from .linop import AIJOperator

    return AIJOperator.from_scipy(read_petsc_matrix(path, dtype), dtype=dtype,
                                  device=device)
