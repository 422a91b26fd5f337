"""The 7-point 3-D Laplacian, scaled by the seeded c = 2^k, as the port's
``DIAOperator``: 7 stored diagonals of n float64 entries each (zero where a
neighbour lies outside the grid), made on the device."""

from __future__ import annotations

import torch

from portbench.makers._stencil import NEIGHBOURS, coords, inside, offset, scale


def shared_inputs(cfg: dict, cache_dir) -> dict:
    """Raw inputs that the program's operator and the reference both read:
    none, the grid order is the stored order."""
    return {}


def build(cfg: dict, seed: int, device, shared: dict):
    """(operator, layout): the port's DIAOperator of c A on ``device`` and
    the shapes the byte counts are taken from."""
    import slepc_tpu_torch as stt

    nx, ny, nz = cfg["grid"]
    dims, n = (nx, ny, nz), nx * ny * nz
    c = scale(seed)
    xyz = coords(torch.arange(n, device=device), nx, ny)
    # ascending offsets: the three lower neighbours, the diagonal, the upper
    stencil = NEIGHBOURS[:3] + (None,) + NEIGHBOURS[3:]
    diags = torch.empty((7, n), dtype=torch.float64, device=device)
    offsets = []
    for k, nb in enumerate(stencil):
        if nb is None:
            diags[k] = 6.0 * c
            offsets.append(0)
        else:
            # A[i, i + off] = -1 where the neighbour lies inside the grid
            diags[k] = torch.where(inside(*nb, xyz, dims), -c, 0.0)
            offsets.append(offset(*nb, nx, ny))
    del xyz
    op = stt.DIAOperator(offsets, diags)
    layout = {"format": "dia", "n": n, "ndiag": 7,
              "value_bytes": diags.element_size()}
    return op, layout
