"""Test/benchmark matrix generators (``slepc_tpu/mat/generators.py:17-223``).

The discrete Laplacians are DIA operators whose diagonals are built with
torch ops directly on ``device`` (``None``: the card, ``sys/device.py``): at
10M rows the 3-D Laplacian materializes on the card in milliseconds, with no host array and no upload (the role of
slepc_tpu's ``laplacian_3d_device``).  The closed-form spectra are numpy.
General sparse input comes in through :func:`from_scipy` (an AIJOperator
in CSR on ``device``) and :func:`random_sparse`.  :func:`markov` is the
non-symmetric Markov chain of SLEPc's ``ex5``, built with vectorized numpy
and placed on ``device`` as CSR; :func:`from_complex_dia` turns a complex
DIA matrix into the real operator of twice its size that acts on the
interleaved (Re, Im) parts, so complex spectra run on the real kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sys.device import resolve_device
from ..sys.dtypes import as_numpy_dtype, as_torch_dtype
from .linop import AIJOperator, DenseOperator, DIAOperator


def _neighbor(cond: torch.Tensor, dtype) -> torch.Tensor:
    return torch.where(cond, -1.0, 0.0).to(dtype)


def laplacian_1d(n: int, dtype=torch.float64, device=None) -> DIAOperator:
    """Tridiagonal 1-D Laplacian, eigenvalues 2-2cos(k*pi/(n+1)).

    Reference analog: src/eps/tutorials/ex1.c.
    """
    device = resolve_device(device)
    i = torch.arange(n, device=device)
    dtype = as_torch_dtype(dtype)  # a numpy dtype too, as the reference takes
    main = torch.full((n,), 2.0, dtype=dtype, device=device)
    lo = _neighbor(i > 0, dtype)  # entry A[i, i-1] stored at row i
    hi = _neighbor(i < n - 1, dtype)  # entry A[i, i+1] stored at row i
    return DIAOperator((-1, 0, 1), torch.stack([lo, main, hi]))


def laplacian_2d(nx: int, ny: int | None = None, dtype=torch.float64,
                 device=None) -> DIAOperator:
    """5-point 2-D Laplacian on an nx x ny grid (row-major x fastest).

    Reference analog: src/eps/tutorials/ex2.c.
    """
    if ny is None:
        ny = nx
    n = nx * ny
    device = resolve_device(device)
    i = torch.arange(n, device=device)
    ix = i % nx
    dtype = as_torch_dtype(dtype)  # a numpy dtype too, as the reference takes
    main = torch.full((n,), 4.0, dtype=dtype, device=device)
    east = _neighbor(ix < nx - 1, dtype)
    west = _neighbor(ix > 0, dtype)
    north = _neighbor(i < n - nx, dtype)
    south = _neighbor(i >= nx, dtype)
    return DIAOperator((-nx, -1, 0, 1, nx),
                       torch.stack([south, west, main, east, north]))


def laplacian_3d(nx: int, ny: int | None = None, nz: int | None = None,
                 dtype=torch.float64, device=None) -> DIAOperator:
    """7-point 3-D Laplacian (x fastest, then y, then z)."""
    if ny is None:
        ny = nx
    if nz is None:
        nz = nx
    n = nx * ny * nz
    device = resolve_device(device)
    i = torch.arange(n, device=device)
    ix = i % nx
    iy = (i // nx) % ny
    iz = i // (nx * ny)
    dtype = as_torch_dtype(dtype)  # a numpy dtype too, as the reference takes
    main = torch.full((n,), 6.0, dtype=dtype, device=device)
    diags = torch.stack([
        _neighbor(iz > 0, dtype), _neighbor(iy > 0, dtype),
        _neighbor(ix > 0, dtype), main, _neighbor(ix < nx - 1, dtype),
        _neighbor(iy < ny - 1, dtype), _neighbor(iz < nz - 1, dtype)])
    return DIAOperator((-nx * ny, -nx, -1, 0, 1, nx, nx * ny), diags)


def laplacian_3d_device(nx: int, ny: int | None = None, nz: int | None = None,
                        dtype=np.float64, device=None) -> DIAOperator:
    """The 7-point 3-D Laplacian with its diagonals made on the device (the
    reference's name for that route; :func:`laplacian_3d` builds them there
    already)."""
    return laplacian_3d(nx, ny, nz, dtype=dtype, device=device)


def laplacian_1d_eigs(n: int, k: int | None = None) -> np.ndarray:
    """Closed-form eigenvalues of laplacian_1d, ascending."""
    j = np.arange(1, n + 1)
    ev = 2.0 - 2.0 * np.cos(j * np.pi / (n + 1))
    return ev if k is None else ev[:k]


def laplacian_2d_eigs(nx: int, ny: int | None = None, k: int | None = None) -> np.ndarray:
    """Closed-form eigenvalues of laplacian_2d, ascending."""
    if ny is None:
        ny = nx
    ex = 2.0 - 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    ey = 2.0 - 2.0 * np.cos(np.arange(1, ny + 1) * np.pi / (ny + 1))
    ev = np.sort((ex[:, None] + ey[None, :]).ravel())
    return ev if k is None else ev[:k]


def laplacian_3d_eigs(nx: int, ny: int | None = None, nz: int | None = None,
                      k: int | None = None) -> np.ndarray:
    """Closed-form eigenvalues of the 7-point 3-D Laplacian, ascending.

    For small k only the low-index corner of the (i,j,l) lattice can
    contain the smallest combinations (eigenvalues are monotone in each
    index), so the outer sum is truncated per axis."""
    if ny is None:
        ny = nx
    if nz is None:
        nz = nx
    mx = nx if k is None else min(k + 1, nx)
    my = ny if k is None else min(k + 1, ny)
    mz = nz if k is None else min(k + 1, nz)
    ex = 2.0 - 2.0 * np.cos(np.arange(1, mx + 1) * np.pi / (nx + 1))
    ey = 2.0 - 2.0 * np.cos(np.arange(1, my + 1) * np.pi / (ny + 1))
    ez = 2.0 - 2.0 * np.cos(np.arange(1, mz + 1) * np.pi / (nz + 1))
    ev = np.sort((ex[:, None, None] + ey[None, :, None]
                  + ez[None, None, :]).ravel())
    return ev if k is None else ev[:k]


def from_scipy(A, dtype=None, device=None) -> AIJOperator:
    """A scipy sparse matrix as an AIJOperator (CSR) on ``device``."""
    return AIJOperator.from_scipy(A, dtype=dtype, device=device)


def from_dense(A, device=None) -> DenseOperator:
    return DenseOperator(A, device=device)


def random_sparse(n: int, m: int | None = None, density: float = 0.01,
                  seed: int = 0, dtype=np.float64, symmetric: bool = False,
                  device=None) -> AIJOperator:
    """Random sparse test matrix (deterministic at fixed seed; the same
    matrix as slepc_tpu's ``random_sparse`` for the same arguments)."""
    import scipy.sparse as sp

    m = n if m is None else m
    rng = np.random.default_rng(seed)
    A = sp.random(n, m, density=density, random_state=rng,
                  dtype=np.float64).astype(as_numpy_dtype(dtype))
    if symmetric:
        A = (A + A.T) * 0.5
    return AIJOperator.from_scipy(sp.csr_matrix(A), device=device)


def markov(m: int, dtype=torch.float64, device=None) -> AIJOperator:
    """Markov chain transition matrix on a triangular grid of m(m+1)/2
    states (SLEPc ``ex5`` MatMarkovModel; the dominant eigenvalue is 1):
    the reference's loop, entry for entry, as index arithmetic."""
    import scipy.sparse as sp

    N = m * (m + 1) // 2
    cst = 0.5 / (m - 1)
    # grid point (i, j), 1 <= i <= m, 1 <= j <= jmax = m - i + 1, row r
    i = np.repeat(np.arange(1, m + 1), np.arange(m, 0, -1))
    jmax = m - i + 1
    start = np.concatenate([[0], np.cumsum(np.arange(m, 0, -1))[:-1]])
    r = np.arange(N)
    j = r - start[i - 1] + 1
    pd = cst * (i + j - 1)
    pu = 0.5 - cst * (i + j - 3)
    up = j != jmax
    north = (r[up], r[up] + 1, np.where(i[up] == 1, 2 * pd[up], pd[up]))
    east = (r[up], r[up] + jmax[up], np.where(j[up] == 1, 2 * pd[up], pd[up]))
    s_, w_ = j > 1, i > 1
    south = (r[s_], r[s_] - 1, pu[s_])
    west = (r[w_], r[w_] - jmax[w_] - 1, pu[w_])
    rows, cols, vals = (np.concatenate(t) for t in zip(north, east, south,
                                                       west))
    A = sp.csr_matrix((vals, (rows, cols)), shape=(N, N), dtype=np.float64)
    return AIJOperator.from_scipy(A, dtype=dtype, device=device)


def from_complex_dia(offsets, diags, dtype=torch.float64,
                     device=None) -> DIAOperator:
    """The real form of a complex DIA matrix A (``diags[k, i] = A[i, i +
    offsets[k]]``, a complex (nd, n) array): the DIA operator of 2n rows
    acting on z = (Re x_0, Im x_0, Re x_1, ...), whose 2x2 blocks are
    [[Re a, -Im a], [Im a, Re a]].  Its spectrum is lambda(A) and its
    conjugates.  Offset o of A becomes offsets 2o - 1, 2o, 2o + 1 (and 2o
    +- 2 through the blocks), so a tridiagonal A is 7 real diagonals."""
    diags = np.asarray(diags)
    n = diags.shape[1]
    span = [2 * o + t for o in offsets for t in (-1, 0, 1)]
    roffs = sorted(set(span))
    out = np.zeros((len(roffs), 2 * n))
    for k, o in enumerate(offsets):
        re, im = diags[k].real, diags[k].imag
        # row 2i (Re y_i): Re a x_re at col 2(i+o), -Im a x_im at 2(i+o)+1
        out[roffs.index(2 * o), 0::2] = re
        out[roffs.index(2 * o + 1), 0::2] = -im
        # row 2i+1 (Im y_i): Im a x_re at col 2(i+o), Re a x_im at 2(i+o)+1
        out[roffs.index(2 * o - 1), 1::2] = im
        out[roffs.index(2 * o), 1::2] = re
    device = resolve_device(device)
    return DIAOperator(roffs, torch.from_numpy(out).to(device,
                                                       as_torch_dtype(dtype)))
