"""Plain reference of the 7-point 3-D Laplacian scaled by the run's seed:
c A, with A the Dirichlet Laplacian of an nx x ny x nz grid (x fastest,
then y, then z; 6 on the diagonal, -1 to each neighbour) and c = 2^k,
k = seed mod 17 - 8.

c A has the eigenvalues c lambda (closed form below) and A's eigenvectors.
A configuration stored in a permutation of the grid's rows (RCM) is judged
here in grid order: a vector in the stored order goes to grid order, the
stencil runs there, and the result goes back.

Nothing here imports the program under test or the harness: the stencil is
applied by shifts of the grid, not by stored diagonals or CSR arrays, and
the scale is worked out again from the seed.
"""

from __future__ import annotations

import numpy as np
import torch


def scale(seed: int) -> float:
    """The seed's scale c = 2^k, k = seed mod 17 - 8."""
    return 2.0 ** (int(seed) % 17 - 8)


def exact_eigs(nx: int, ny: int, nz: int, k: int) -> np.ndarray:
    """The k smallest eigenvalues of the 3-D Dirichlet Laplacian, ascending:
    sums of 2 - 2 cos(j pi / (m + 1)) over the three axes."""
    return np.sort([lam for lam, _ in _smallest_modes(nx, ny, nz, k)])[:k]


def _smallest_modes(nx, ny, nz, k):
    """(eigenvalue, (i, j, l)) of the k smallest modes, ascending; only the
    first k + 1 indices of each axis can hold them."""
    ax = [2.0 - 2.0 * np.cos(np.arange(1, min(k + 1, m) + 1) * np.pi
                             / (m + 1)) for m in (nx, ny, nz)]
    modes = [(ax[0][i] + ax[1][j] + ax[2][l], (i + 1, j + 1, l + 1))
             for i in range(len(ax[0])) for j in range(len(ax[1]))
             for l in range(len(ax[2]))]
    modes.sort(key=lambda t: t[0])
    return modes[:k]


class Lap3D:
    """c A on ``device``; ``perm`` (stored row k is grid row perm[k]) or None
    for grid order."""

    def __init__(self, grid, seed: int, device, perm=None):
        self.nx, self.ny, self.nz = (int(g) for g in grid)
        self.n = self.nx * self.ny * self.nz
        self.device = torch.device(device)
        self.c = scale(seed)
        self.perm = None
        if perm is not None:
            p = torch.as_tensor(np.asarray(perm), device=self.device)
            p = p.to(torch.int64)
            if p.shape != (self.n,) or not bool(
                    (torch.bincount(p, minlength=self.n) == 1).all()):
                raise ValueError("the stored order is not a permutation of "
                                 "the grid's rows")
            self.perm = p

    def to_grid(self, X: torch.Tensor) -> torch.Tensor:
        if self.perm is None:
            return X
        G = torch.empty_like(X)
        G[..., self.perm] = X
        return G

    def from_grid(self, G: torch.Tensor) -> torch.Tensor:
        return G if self.perm is None else G[..., self.perm]

    def laplacian_grid(self, G: torch.Tensor) -> torch.Tensor:
        """A G for G (..., n) in grid order, by shifts of the (nz, ny, nx)
        grid with zeros past the boundary, in G's dtype."""
        lead = G.shape[:-1]
        g = G.reshape(*lead, self.nz, self.ny, self.nx)
        y = 6.0 * g
        y[..., :, :, 1:] -= g[..., :, :, :-1]
        y[..., :, :, :-1] -= g[..., :, :, 1:]
        y[..., :, 1:, :] -= g[..., :, :-1, :]
        y[..., :, :-1, :] -= g[..., :, 1:, :]
        y[..., 1:, :, :] -= g[..., :-1, :, :]
        y[..., :-1, :, :] -= g[..., 1:, :, :]
        return y.reshape(*lead, self.n)

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        """(c A) X for X (n,) or (b, n) in the stored order, in X's dtype."""
        return self.from_grid(self.c * self.laplacian_grid(self.to_grid(X)))

    def exact_eigs(self, k: int) -> np.ndarray:
        return self.c * exact_eigs(self.nx, self.ny, self.nz, k)

    def eigvecs(self, k: int, dtype=torch.float64) -> torch.Tensor:
        """(k, n) unit eigenvectors of c A for the k smallest eigenvalues, in
        the stored order, evaluated in ``dtype``: the products of sines
        sin(i pi x / (nx + 1)) sin(j pi y / (ny + 1)) sin(l pi z / (nz + 1))."""
        rows = []
        for _, (i, j, l) in _smallest_modes(self.nx, self.ny, self.nz, k):
            f = [torch.sin(torch.arange(1, m + 1, device=self.device,
                                        dtype=dtype) * (q * np.pi / (m + 1)))
                 for q, m in ((l, self.nz), (j, self.ny), (i, self.nx))]
            v = (f[0][:, None, None] * f[1][None, :, None]
                 * f[2][None, None, :]).reshape(self.n)
            v = v / torch.linalg.vector_norm(v)
            rows.append(self.from_grid(v))
        return torch.stack(rows)


def make(cfg: dict, seed: int, device, shared: dict) -> Lap3D:
    """The reference of a configuration whose ``reference`` is ``lap3d``:
    its grid, the run's seed, and the stored order among the inputs that
    the benchmark hands to both sides (``perm``; absent for grid order)."""
    return Lap3D(cfg["grid"], seed, device, perm=shared.get("perm"))
