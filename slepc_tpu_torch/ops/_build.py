"""Build and load the hand-written CUDA kernels (``slepc_tpu_torch/csrc``).

The kernels are compiled at first use with one ``nvcc`` call (which compiles
the sources side by side: ``--threads 0 --split-compile 0``) into one shared
library with a plain C interface,
``slepc_tpu_torch/_build/libslepc_tpu_torch_kernels.so``, and bound with
``ctypes``.  The library is rebuilt whenever the hash of the sources (and of
the compiler flags) changes.  Only the sources in this
package are compiled; nothing is downloaded.  If ``nvcc`` is missing or the
build fails, :func:`load` raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libslepc_tpu_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--threads", "0", "--split-compile", "0")

DTYPE_CODE = {"torch.float32": 0, "torch.float64": 1, "torch.complex64": 2,
              "torch.complex128": 3}
# the launch counters' suffix of each dtype code
SUFFIX = ("f32", "f64", "c64", "c128")

_lib = None
build_seconds = None   # wall time of the last compile in this process, if any
build_log = ""         # compiler output of that compile (-Xptxas -v report)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_SIGNATURES = {
    "slepc_csr_spmv": (_I, [_I, _P, _P, _P, _P, _P, _P, _I64, _I, _P, _P, _P,
                            _I64, _I, _P, _P, _P]),
    "slepc_csr_max_rows": (_I, []),
    "slepc_csr_max_budget": (_I, []),
    "slepc_dia_spmv": (_I, [_I, _P, _I64, ctypes.POINTER(_I64), _I, _P, _P,
                            _I64, _P]),
    "slepc_dia_max_diags": (_I, []),
    "slepc_dia_spmm": (_I, [_I, _P, _I64, ctypes.POINTER(_I64),
                            ctypes.POINTER(_I), _I, _P, _I64, _P, _I64, _I,
                            _I64, _I, _I, _P]),
    "slepc_dia_spmm_smem": (_I64, [_I, _I, _I, _I]),
    "slepc_dia_spmm_max_b": (_I, []),
    "slepc_error_string": (ctypes.c_char_p, [_I]),
    "slepc_panel": (_I, [_I, _I, _I, _P, _I64, _I, _P, _I64, _I, _P, _P, _I64,
                         _P, _I, _I, _I, _P, _I64, _P]),
    "slepc_panel_max_b": (_I, []),
    "slepc_panel_max_groups": (_I, []),
    "slepc_panel_rows": (_I, [_I, _I]),
    "slepc_panel_smem": (_I64, [_I, _I, _I, _I, _I, _I]),
    "slepc_panel_occupancy": (_I, [_I, _I, _I, _I, _I, _I,
                                   ctypes.POINTER(_I)]),
    "slepc_rotate": (_I, [_I, _I, _P, _I, _I, _P, _I64, _P, _I64, _I64, _I, _I,
                          _P]),
    "slepc_rotate_max_p": (_I, []),
    "slepc_rotate_smem": (_I64, [_I, _I, _I, _I]),
    "slepc_rotate_occupancy": (_I, [_I, _I, _I, _I, _I, ctypes.POINTER(_I)]),
    "slepc_stream_sum": (_I, [_I, _P, _I64, _I, _P, _P, _I64, _P]),
}


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and Path("/usr/local/cuda/bin/nvcc").exists():
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the slepc_tpu_torch CUDA kernels are built from "
            "source at first use and need the CUDA toolkit on PATH")
    return exe


def _compile(so: Path, stamp: Path, digest: str) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(SRC_DIR.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the slepc_tpu_torch kernels failed "
            f"(rc={proc.returncode}): {' '.join(cmd)}\n{build_log}")
    os.replace(tmp, so)
    stamp.write_text(digest)


def load():
    """The kernel library, compiled first if its sources changed."""
    global _lib
    if _lib is not None:
        return _lib
    so = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if not (so.exists() and stamp.exists() and stamp.read_text() == digest):
        _compile(so, stamp, digest)
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry reported a CUDA error."""
    if rc != 0:
        msg = load().slepc_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t) -> int:
    code = DTYPE_CODE.get(str(t.dtype))
    if code is None:
        raise TypeError(f"kernels take float32, float64, complex64 or "
                        f"complex128, got {t.dtype}")
    return code
