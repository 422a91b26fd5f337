"""What the Laplacian makers share: the grid's coordinates and the seeded
scale c = 2^k of the operator c A, k = seed mod 17 - 8.

A binary scale is exact in floating point, so every seed gives the solver
the same work (the same Krylov vectors, columns and launches, scaled by c)
on inputs that differ: stored values and eigenvalues scale by c.  A
seeded similarity would change the solve's start vector relative to A's
eigenvectors, and with it the number of filtered columns (97 or 98 on the
flagship, about half the seeds each), so the time would follow the seed."""

from __future__ import annotations

import torch

# the 7-point stencil's neighbours: (axis, step); the diagonal holds 6
NEIGHBOURS = ((2, -1), (1, -1), (0, -1), (0, 1), (1, 1), (2, 1))


def scale(seed: int) -> float:
    """c = 2^k, k = seed mod 17 - 8 (1/256 to 256)."""
    return 2.0 ** (int(seed) % 17 - 8)


def coords(rows: torch.Tensor, nx: int, ny: int):
    """(ix, iy, iz) of grid rows (x fastest, then y, then z)."""
    return rows % nx, (rows // nx) % ny, rows // (nx * ny)


def offset(axis: int, step: int, nx: int, ny: int) -> int:
    return step * (1, nx, nx * ny)[axis]


def inside(axis: int, step: int, xyz, dims) -> torch.Tensor:
    """Rows whose neighbour along ``axis`` by ``step`` lies in the grid."""
    c = xyz[axis]
    return c > 0 if step < 0 else c < dims[axis] - 1
