"""The stream yardstick: kernel K7, ``csrc/stream.cu``.

``stream_sum(d, x)`` computes ``y[i] = sum_k d[k, i] * x[i]`` for ``d``
(nd, n) and ``x`` (n,): a DIA SpMV whose offsets are all zero, so it moves
the ``(nd + 2) * n * elt`` bytes an ideal SpMV of nd diagonals must move and
does nothing else -- the function of ``_stream_kernel`` in the JAX package's
``bench.py`` (``stream_loop_impl``), on flat vectors, in float32 and float64.

:func:`stream_bandwidth` times it and returns the rate in GB/s: the
bandwidth a kernel of this shape reaches on the card at hand, which the
SpMV kernels' times are held against.  Nothing in a solver calls this
module.

The wrapper runs the plain :func:`stream_sum_ref` for tensors on the CPU,
launches the kernel for tensors on a CUDA device, and raises for anything
else.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..sys.device import resolve_device
from ..sys.dtypes import as_torch_dtype
from . import _build

launches = {"stream_sum_f32": 0, "stream_sum_f64": 0}


def stream_sum_ref(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the reference the kernel is held against)."""
    return (d * x).sum(0)


def stream_sum(d: torch.Tensor, x: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = sum_k d[k] * x into ``out`` (a new tensor when None)."""
    if d.dim() != 2 or x.dim() != 1 or d.shape[1] != x.shape[0] \
            or d.shape[0] < 1:
        raise ValueError(f"stream_sum: d {tuple(d.shape)} and x "
                         f"{tuple(x.shape)} are not (nd, n) and (n,)")
    operands = (d, x) if out is None else (d, x, out)
    if any(t.dtype != d.dtype or t.device != d.device for t in operands):
        raise ValueError("stream_sum: operands differ in dtype or device")
    if out is not None and out.shape != x.shape:
        raise ValueError(f"stream_sum: out {tuple(out.shape)} is not "
                         f"{tuple(x.shape)}")
    if d.device.type == "cpu":
        y = stream_sum_ref(d, x)
        return y if out is None else out.copy_(y)
    if d.device.type != "cuda":
        raise ValueError(f"stream_sum: no kernel for device {d.device}")
    if d.dtype not in (torch.float32, torch.float64):  # a real yardstick
        raise TypeError(f"stream_sum: K7 takes float32 or float64, got "
                        f"{d.dtype}")
    code = _build.dtype_code(d)
    y = torch.empty_like(x) if out is None else out
    if d.stride(1) != 1 or not x.is_contiguous() or not y.is_contiguous():
        raise ValueError("stream_sum: x, out and the rows of d must be "
                         "contiguous")
    rc = _build.load().slepc_stream_sum(
        code, d.data_ptr(), d.stride(0), d.shape[0], x.data_ptr(),
        y.data_ptr(), x.shape[0], _build.stream_handle(d))
    _build.check(rc, "stream_sum")
    launches["stream_sum_f64" if code else "stream_sum_f32"] += 1
    return y


def stream_bandwidth(nd: int, n: int, dtype=torch.float64, device=None,
                     reps: int = 20, warmup: int = 3) -> float:
    """GB/s of :func:`stream_sum` at (nd, n): ``(nd + 2) * n * elt`` bytes
    over the median CUDA-event time of ``reps`` calls after ``warmup``
    (the role of ``measure_stream`` in the JAX package's ``bench.py``).
    Needs a CUDA device: a rate is a device measurement."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("stream_bandwidth measures a CUDA card; on the "
                           "CPU there is no kernel to time")
    dtype = as_torch_dtype(dtype)
    d = torch.ones((nd, n), dtype=dtype, device=device)
    x = torch.ones(n, dtype=dtype, device=device)
    y = torch.empty_like(x)
    for _ in range(warmup):
        stream_sum(d, x, out=y)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        stream_sum(d, x, out=y)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = sorted(times)[len(times) // 2]
    return (nd + 2) * n * x.element_size() / ms / 1e6
