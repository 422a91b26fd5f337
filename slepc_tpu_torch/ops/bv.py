"""CGS2 panel sweeps: kernel K3, ``csrc/bv_panel.cu``.

On a row-major basis ``V`` (K, n) and a panel ``W`` (b, n):

* ``panel_dots(V, W)``            C[k, m] = <V[k], W[m]>
* ``panel_update(V, C, W)``       W[m] - sum_k C[k, m] V[k]
* ``panel_update_dots(V, C, W)``  the update plus the dots of V with the
  updated panel, reading V once

-- the functions of ``slepc_tpu/ops/bv_pallas.py`` on the transposed basis of
``slepc_tpu/eps/ks_jit.py``, for float32 and float64.  Each wrapper runs its
plain version (``*_ref``) for tensors on the CPU, launches the kernel for
tensors on a CUDA device, and raises for anything else.  The kernel's sums
are deterministic (two-pass, no atomics).
"""

from __future__ import annotations

import torch

from . import _build

_NAMES = ("panel_dots", "panel_update", "panel_update_dots")
launches = {f"{name}_{t}": 0 for name in _NAMES for t in ("f32", "f64")}
_MAX_GRID = 1024  # blocks of the sweep kernel; each walks n / (grid * tile) tiles


def panel_dots_ref(V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return V @ W.T


def panel_update_ref(V: torch.Tensor, C: torch.Tensor,
                     W: torch.Tensor) -> torch.Tensor:
    return W - C.T @ V


def panel_update_dots_ref(V: torch.Tensor, C: torch.Tensor, W: torch.Tensor):
    U = panel_update_ref(V, C, W)
    return U, V @ U.T


def _check_args(V, W, C):
    if V.dim() != 2 or W.dim() != 2 or V.shape[1] != W.shape[1]:
        raise ValueError(f"panel sweep: V {tuple(V.shape)} and W "
                         f"{tuple(W.shape)} are not (K, n) and (b, n)")
    if C is not None and tuple(C.shape) != (V.shape[0], W.shape[0]):
        raise ValueError(f"panel sweep: C {tuple(C.shape)} is not "
                         f"{(V.shape[0], W.shape[0])}")
    for t in (W, C):
        if t is not None and (t.dtype != V.dtype or t.device != V.device):
            raise ValueError("panel sweep: operands differ in dtype or device")
    if V.device.type not in ("cpu", "cuda"):
        raise ValueError(f"panel sweep: no kernel for device {V.device}")


def _launch(mode: int, V, W, C):
    """mode 0 = dots, 1 = update, 2 = update + dots (see bv_panel.cu)."""
    code = _build.dtype_code(V)
    if V.stride(1) != 1 or W.stride(1) != 1:
        raise ValueError("panel sweep: rows of V and W must be contiguous")
    lib = _build.load()
    K, n = V.shape
    b = W.shape[0]
    if b > lib.slepc_panel_max_b():
        raise ValueError(f"panel sweep: panel width {b} is more than the "
                         f"kernel takes")
    grid = min(-(-n // lib.slepc_panel_tile()), _MAX_GRID)
    out = torch.empty((b, n), dtype=V.dtype, device=V.device) if mode else None
    dots = mode != 1
    partial = torch.empty((K * b, grid), dtype=V.dtype, device=V.device) \
        if dots else None
    D = torch.empty((K, b), dtype=V.dtype, device=V.device) if dots else None
    Cc = C.contiguous() if C is not None else None
    rc = lib.slepc_panel(
        code, mode, V.data_ptr(), V.stride(0), K, W.data_ptr(), W.stride(0), b,
        Cc.data_ptr() if Cc is not None else None,
        out.data_ptr() if out is not None else None, n,
        partial.data_ptr() if partial is not None else None, grid,
        D.data_ptr() if D is not None else None, n, _build.stream_handle(V))
    _build.check(rc, _NAMES[mode])
    launches[f"{_NAMES[mode]}_{'f64' if code else 'f32'}"] += 1
    return out, D


def panel_dots(V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(K, b) dots of the basis rows with the panel rows."""
    _check_args(V, W, None)
    if V.device.type == "cpu":
        return panel_dots_ref(V, W)
    return _launch(0, V, W, None)[1]


def panel_update(V: torch.Tensor, C: torch.Tensor,
                 W: torch.Tensor) -> torch.Tensor:
    """W - C^T V, a new (b, n) tensor."""
    _check_args(V, W, C)
    if V.device.type == "cpu":
        return panel_update_ref(V, C, W)
    return _launch(1, V, W, C)[0]


def panel_update_dots(V: torch.Tensor, C: torch.Tensor, W: torch.Tensor):
    """(W - C^T V, V (W - C^T V)^T) with one read of V."""
    _check_args(V, W, C)
    if V.device.type == "cpu":
        return panel_update_dots_ref(V, C, W)
    return _launch(2, V, W, C)
