"""Restart rotation: kernel K4, ``csrc/rotate.cu``.

``out[p] = sum_k Q[k, p] V[k]`` for a row-major basis ``V`` (K, n) and
``Q`` (K, P) -- the function of ``slepc_tpu/ops/rotate_pallas.py``
(``rotate_basis_ds``, double-single there, native float64 here) and of the
XLA rotation ``slepc_tpu/eps/ks_jit.py:_rotate_basis``.  Every rotation of the
port goes through it.  :func:`rotate` runs the plain :func:`rotate_ref` for
tensors on the CPU, launches the kernel for tensors on a CUDA device, and
raises for anything else.  The result is a new (P, n) tensor.
"""

from __future__ import annotations

import torch

from . import _build

launches = {"rotate_f32": 0, "rotate_f64": 0}


def rotate_ref(Q: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    return Q.T @ V


def rotate(Q: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    if Q.dim() != 2 or V.dim() != 2 or Q.shape[0] != V.shape[0]:
        raise ValueError(f"rotate: Q {tuple(Q.shape)} does not match V "
                         f"{tuple(V.shape)}")
    if Q.dtype != V.dtype or Q.device != V.device:
        raise ValueError("rotate: Q and V differ in dtype or device")
    if V.device.type == "cpu":
        return rotate_ref(Q, V)
    if V.device.type != "cuda":
        raise ValueError(f"rotate: no kernel for device {V.device}")
    code = _build.dtype_code(V)
    if V.stride(1) != 1:
        raise ValueError("rotate: rows of V must be contiguous")
    K, n = V.shape
    P = Q.shape[1]
    Qc = Q.contiguous()
    out = torch.empty((P, n), dtype=V.dtype, device=V.device)
    lib = _build.load()
    rc = lib.slepc_rotate(code, Qc.data_ptr(), K, P, V.data_ptr(), V.stride(0),
                          out.data_ptr(), n, n, _build.stream_handle(V))
    _build.check(rc, "rotate")
    launches["rotate_f64" if code else "rotate_f32"] += 1
    return out
