"""Restart rotation: kernel K4, ``csrc/rotate.cu``.

``out[p] = sum_k Q[k, p] V[k]`` for a row-major basis ``V`` (K, n) and
``Q`` (K, P) -- the function of ``slepc_tpu/ops/rotate_pallas.py``
(``rotate_basis_ds``, double-single there, native float64 here) and of the
XLA rotation ``slepc_tpu/eps/ks_jit.py:_rotate_basis``.  Every rotation of the
port goes through it.  Complex64 / complex128 Q and V take the complex
kernels K4c (no conjugate: out = Q^T V; complex128 as a real product of
twice the size on the f64 tensor cores, complex64 on the FP32 pipe); a real
Q on a complex V is the real kernel on ``view_as_real(V)`` as
a (K, 2n) basis.  :func:`rotate` runs the plain :func:`rotate_ref` for
tensors on the CPU, launches the kernel for tensors on a CUDA device, and
raises for anything else.  The result is a new (P, n) tensor, or ``out``
when one is given; ``out`` may be rows of ``V`` itself (same row stride,
same columns), which is how the restart writes ``V[:P]`` in place.

:func:`plan_rotate` is the launch planning in plain Python (no card needed):
which kernel variant a shape gets, its tile, threads, ring depth, shared
memory and grid.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = {"rotate_f32": 0, "rotate_f64": 0, "rotate_c64": 0,
            "rotate_c128": 0}

SMEM_LIMIT = 232_448   # bytes of shared memory a block can use (227 KB)
MAX_P = 64             # output rows of one launch (8 tiles of 8 rows)
CHUNK = 16             # basis rows per stage of the shared-memory ring
_occupancy = {}        # (code, vec, K, P, stages) -> blocks per SM


def rotate_ref(Q: torch.Tensor, V: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    res = Q.T @ V
    if out is None:
        return res
    out.copy_(res)
    return out


def _q_stride64(kpad: int) -> int:
    return kpad + (4 - kpad % 16) % 16


def _q_stride128(kpad: int) -> int:
    return kpad + (2 - kpad % 8) % 8


def plan_rotate(K: int, P: int, n: int, dtype: torch.dtype, *,
                ldv: int | None = None, ldo: int | None = None,
                v_base: int = 0, out_base: int = 0, sm_count: int = 132,
                blocks_per_sm=None) -> dict:
    """How ``rotate`` launches K4 for Q (K, P), V (K, n) of ``dtype``: row
    strides ``ldv`` / ``ldo`` in elements (n when left out), base addresses
    ``v_base`` / ``out_base`` in bytes.  ``blocks_per_sm``: a function of
    (vec, K, widest launch's P, stages) giving the compiled kernel's
    occupancy, else the shared-memory estimate.

    Returns a dict: ``variant`` ("mma_f64": tensor-core m8n8k4; "mma_c128":
    complex128 as its real form, tensor-core m16n8k4; "ffma_f32" /
    "ffma_c64": register-tiled FP32), ``vec`` (16-byte copies and stores,
    else 8/4-byte; a complex128 is 16 bytes either way), ``tile``
    (columns), ``threads``, ``row_tiles`` (8-row output tiles the kernel
    computes), ``stages`` (ring depth), ``smem`` (bytes), ``grid``,
    ``max_p`` (output rows of one launch) and ``chunks``: the (p0, p1)
    column ranges of Q, one launch each.  Raises ``ValueError`` for a shape
    no ring depth fits."""
    if K < 1 or P < 1 or n < 1:
        raise ValueError(f"rotate: empty shape K={K} P={P} n={n}")
    if str(dtype) not in _build.DTYPE_CODE:
        raise TypeError(f"kernels take float32, float64, complex64 or "
                        f"complex128, got {dtype}")
    elt = dtype.itemsize
    width = 16 // elt
    ldv = n if ldv is None else ldv
    ldo = n if ldo is None else ldo
    vec = (n % width == 0 and (ldv * elt) % 16 == 0 and (ldo * elt) % 16 == 0
           and v_base % 16 == 0 and out_base % 16 == 0)
    chunks = [(p0, min(p0 + MAX_P, P)) for p0 in range(0, P, MAX_P)]
    pc = chunks[0][1]  # the widest launch
    tiles8 = -(-pc // 8)
    if dtype in (torch.float64, torch.complex128):  # the tensor cores
        row_tiles = next(t for t in (1, 2, 4, 5, 6, 8) if tiles8 <= t)
        tile, threads = 64, (128 if dtype == torch.float64 else 256)
        sq = (_q_stride64(-(-K // 4) * 4) if dtype == torch.float64
              else _q_stride128(-(-K // 2) * 2))
        fixed = 8 * row_tiles * sq * elt
        stage = CHUNK * 68 * elt  # ring rows of 68 elements
    else:  # FP32 FFMA: Q^T (K, 8 * tiles8) in shared memory
        row_tiles = tiles8
        tile = 128
        threads = 32 * tiles8
        fixed = K * 8 * tiles8 * elt
        stage = CHUNK * tile * elt
    fits = [s for s in (4, 3, 2) if fixed + s * stage <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"rotate: Q ({K}, {P}) of {dtype} needs {fixed + 2 * stage} bytes "
            f"of shared memory, more than the {SMEM_LIMIT} a block can use")

    def occupancy(s):
        if blocks_per_sm is not None:
            return blocks_per_sm(vec, K, pc, s)
        return max(1, min(SMEM_LIMIT // (fixed + s * stage + 1024),
                          2048 // threads, 8))

    # the real kernels take the deepest ring that fits; the complex ones,
    # whose products hold a warp longer, the ring that gives the most blocks
    # an SM, the deepest of those (chip_smoke.py --profile sweeps the depth)
    stages = fits[0] if not dtype.is_complex else max(
        fits, key=lambda s: (occupancy(s), s))
    smem = fixed + stages * stage
    per_sm = occupancy(stages)
    grid = max(1, min(-(-n // tile), sm_count * per_sm))
    variant = {torch.float32: "ffma_f32", torch.float64: "mma_f64",
               torch.complex64: "ffma_c64", torch.complex128: "mma_c128"}[dtype]
    return {"variant": variant, "vec": vec,
            "tile": tile, "threads": threads, "row_tiles": row_tiles,
            "stages": stages, "smem": smem, "grid": grid, "max_p": MAX_P,
            "chunks": chunks}


def _same_rows(out: torch.Tensor, V: torch.Tensor) -> bool | None:
    """How ``out`` (P, n) lies against ``V`` (K, n): None if they share no
    element, True if every shared element is the same column of a row of
    both (the aliasing the kernel is safe for), False for any other overlap."""
    elt = V.element_size()
    n = V.shape[1]

    def span(t):
        return t.data_ptr(), t.data_ptr() + ((t.shape[0] - 1) * t.stride(0) + n) * elt

    (a0, a1), (b0, b1) = span(out), span(V)
    if a1 <= b0 or b1 <= a0:
        return None
    s = V.stride(0)
    if out.stride(0) != s or s < n or (a0 - b0) % elt:
        return False
    shift = ((a0 - b0) // elt) % s
    if shift == 0:
        return True
    # same stride, other columns: apart only if the column windows miss
    return None if (shift >= n and shift + n <= s) else False


def _check_out(Q, V, out) -> bool:
    """Raise for an ``out`` the function does not take; True if ``out`` is
    rows of V (in place)."""
    P, n = Q.shape[1], V.shape[1]
    if tuple(out.shape) != (P, n):
        raise ValueError(f"rotate: out {tuple(out.shape)} is not {(P, n)}")
    if out.dtype != V.dtype or out.device != V.device:
        raise ValueError("rotate: out differs from V in dtype or device")
    if out.stride(1) != 1:
        raise ValueError("rotate: rows of out must be contiguous")
    q0, q1 = Q.data_ptr(), Q.data_ptr() + Q.element_size() * (
        (Q.shape[0] - 1) * abs(Q.stride(0)) + (P - 1) * abs(Q.stride(1)) + 1)
    o0 = out.data_ptr()
    o1 = o0 + ((P - 1) * out.stride(0) + n) * out.element_size()
    if o0 < q1 and q0 < o1:
        raise ValueError("rotate: out overlaps Q")
    same = _same_rows(out, V)
    if same is False:
        raise ValueError(
            "rotate: out overlaps V other than as rows of it (same row "
            "stride, same columns)")
    return bool(same)


def _blocks_per_sm(lib, code, vec, K, P, stages):
    key = (code, vec, K, P, stages)
    if key not in _occupancy:
        got = ctypes.c_int(0)
        _build.check(lib.slepc_rotate_occupancy(code, int(vec), K, P, stages,
                                                ctypes.byref(got)),
                     "rotate occupancy")
        _occupancy[key] = max(got.value, 1)
    return _occupancy[key]


def rotate(Q: torch.Tensor, V: torch.Tensor,
           out: torch.Tensor | None = None) -> torch.Tensor:
    if Q.dim() != 2 or V.dim() != 2 or Q.shape[0] != V.shape[0]:
        raise ValueError(f"rotate: Q {tuple(Q.shape)} does not match V "
                         f"{tuple(V.shape)}")
    if Q.device != V.device or (Q.dtype != V.dtype and not (
            V.dtype.is_complex and Q.dtype == V.real.dtype)):
        raise ValueError("rotate: Q and V differ in dtype or device")
    if Q.dtype != V.dtype:
        # a real Q mixes whole rows: the (re, im) pairs of V stay together,
        # so it is a real rotation of the (K, 2n) real view
        if out is not None and out.dtype != V.dtype:
            raise ValueError("rotate: out differs from V in dtype or device")
        res = rotate(Q, torch.view_as_real(V).flatten(1),
                     None if out is None else torch.view_as_real(out).flatten(1))
        return out if out is not None else torch.view_as_complex(
            res.view(res.shape[0], -1, 2))
    if V.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rotate: no kernel for device {V.device}")
    in_place = out is not None and _check_out(Q, V, out)
    if V.device.type == "cpu":
        return rotate_ref(Q, V, out)
    if V.stride(1) != 1:
        raise ValueError("rotate: rows of V must be contiguous")
    code = _build.dtype_code(V)
    K, n = V.shape
    P = Q.shape[1]
    if P == 0 or n == 0:
        return out if out is not None else V.new_empty((P, n))
    if in_place and P > MAX_P:
        # several launches, each reading all of V: not safe in place
        out.copy_(rotate(Q, V))
        return out
    if out is None:
        out = torch.empty((P, n), dtype=V.dtype, device=V.device)
    lib = _build.load()
    plan = plan_rotate(
        K, P, n, V.dtype, ldv=V.stride(0), ldo=out.stride(0),
        v_base=V.data_ptr(), out_base=out.data_ptr(),
        sm_count=torch.cuda.get_device_properties(
            V.device).multi_processor_count,
        blocks_per_sm=lambda vec, k, pc, stages: _blocks_per_sm(
            lib, code, vec, k, pc, stages))
    for p0, p1 in plan["chunks"]:
        Qc = Q[:, p0:p1].contiguous()
        rc = lib.slepc_rotate(code, int(plan["vec"]), Qc.data_ptr(), K, p1 - p0,
                              V.data_ptr(), V.stride(0), out[p0:p1].data_ptr(),
                              out.stride(0), n, plan["stages"], plan["grid"],
                              _build.stream_handle(V))
        _build.check(rc, "rotate")
        launches["rotate_" + _build.SUFFIX[code]] += 1
    return out
