"""The 7-point 3-D Laplacian, scaled by the seeded c = 2^k, as a general
sparse (AIJ) matrix in reverse Cuthill-McKee order (PETSc's
MATORDERINGRCM), handed to the port's ``AIJOperator(rowptr, cols, vals,
shape)``: float64 values, int32 columns sorted within each row, int64 row
pointers.

The RCM permutation is a function of the grid alone.  It is computed on
the host once (scipy's ``reverse_cuthill_mckee`` on the stencil's pattern,
as ``chip_smoke.py``'s ``rcm_order`` does) and kept in the cache directory
as int32; every run builds the permuted CSR on the device from it and from
the seed's scale.  Stored row k is grid row perm[k]."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from portbench.makers._stencil import NEIGHBOURS, coords, inside, offset, scale


def rcm_permutation(grid, cache_dir) -> np.ndarray:
    """RCM order of the grid's stencil graph (new row k = grid row
    perm[k]), from ``cache_dir`` when it was computed before."""
    nx, ny, nz = (int(g) for g in grid)
    path = Path(cache_dir) / f"rcm-{nx}x{ny}x{nz}.npy"
    if path.exists():
        return np.load(path)
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = nx * ny * nz
    i = np.arange(n, dtype=np.int64)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    rows, cols = [i], [i]
    for axis, step in NEIGHBOURS:
        c = (ix, iy, iz)[axis]
        keep = c > 0 if step < 0 else c < (nx, ny, nz)[axis] - 1
        rows.append(i[keep])
        cols.append(i[keep] + step * (1, nx, nx * ny)[axis])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    pattern = sp.csr_matrix((np.ones(rows.size, np.int8), (rows, cols)),
                            shape=(n, n))
    pattern.sort_indices()
    del rows, cols
    perm = reverse_cuthill_mckee(pattern, symmetric_mode=True)
    perm = perm.astype(np.int32)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npy")
    np.save(tmp, perm)
    os.replace(tmp, path)
    return perm


def shared_inputs(cfg: dict, cache_dir) -> dict:
    """Raw inputs that the program's operator and the reference both read:
    the stored order."""
    return {"perm": rcm_permutation(cfg["grid"], cache_dir)}


def build(cfg: dict, seed: int, device, shared: dict):
    """(operator, layout): the port's AIJOperator of c P A P^T on ``device``
    and the shapes the byte counts are taken from."""
    import slepc_tpu_torch as stt

    nx, ny, nz = cfg["grid"]
    dims, n = (nx, ny, nz), nx * ny * nz
    perm = torch.from_numpy(shared["perm"]).to(device=device,
                                                dtype=torch.int64)
    where = torch.empty_like(perm)  # grid row -> stored row
    where[perm] = torch.arange(n, device=device)
    c = scale(seed)
    xyz = coords(perm, nx, ny)
    cols = torch.full((n, 7), n, dtype=torch.int64, device=device)
    vals = torch.zeros((n, 7), dtype=torch.float64, device=device)
    cols[:, 0] = torch.arange(n, device=device)
    vals[:, 0] = 6.0 * c
    for k, (axis, step) in enumerate(NEIGHBOURS, start=1):
        ok = inside(axis, step, xyz, dims)
        nb = torch.where(ok, perm + offset(axis, step, nx, ny), perm)
        cols[:, k] = torch.where(ok, where[nb], n)
        vals[:, k] = torch.where(ok, -c, 0.0)
    del xyz, where
    cols, order = torch.sort(cols, dim=1)
    vals = torch.gather(vals, 1, order)
    keep = cols < n
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(keep.sum(dim=1), 0, out=rowptr[1:])
    nnz = int(rowptr[-1])
    op = stt.AIJOperator(rowptr, cols[keep].to(torch.int32), vals[keep],
                         (n, n))
    layout = {"format": "csr", "n": n, "nnz": nnz,
              "value_bytes": vals.element_size(), "index_bytes": 4,
              "rowptr_bytes": 8}
    return op, layout
