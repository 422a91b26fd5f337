"""CGS2 panel sweeps: kernel K3, ``csrc/bv_panel.cu``.

On a row-major basis ``V`` (K, n) and a panel ``W`` (b, n):

* ``panel_dots(V, W)``            C[k, m] = <V[k], W[m]> = V[k]^H W[m]
* ``panel_update(V, C, W)``       W[m] - sum_k C[k, m] V[k]
* ``panel_update_dots(V, C, W)``  the update plus the dots of V with the
  updated panel, reading V once

-- the functions of ``slepc_tpu/ops/bv_pallas.py`` on the transposed basis of
``slepc_tpu/eps/ks_jit.py``, for float32 and float64, and for complex64 /
complex128 (K3c: the dots conjugate the basis, the update does not, as the
reference's conjugate CGS2 in ``slepc_tpu/bv/orthog.py``).  Each wrapper runs its
plain version (``*_ref``) for tensors on the CPU, launches the kernel for
tensors on a CUDA device, and raises for anything else.  The kernel's sums
are deterministic (two-pass, no atomics).

:func:`plan_panel` is the launch planning in plain Python (no card needed):
the compiled panel width, the basis rows a thread holds, the block's row
groups and column warps, shared memory and grid a shape gets, and the row
chunks a basis taller than one block's reach is swept in.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_NAMES = ("panel_dots", "panel_update", "panel_update_dots")
launches = {f"{name}_{t}": 0 for name in _NAMES for t in _build.SUFFIX}

SMEM_LIMIT = 232_448          # bytes of shared memory a block can use
MAX_B = 8                     # widest panel the kernel is compiled for
MAX_GROUPS = 16               # row groups (warps down the rows) of a block
WIDTHS = (1, 2, 4, 8)         # the compiled panel widths
# element type -> compiled width -> basis rows a thread holds
# (csrc/bv_panel.cu rows_for): a thread holds that many 16-byte packs, and a
# running sum is 1 (f32), 2 (f64, c64) or 4 (c128) registers
_REAL_ROWS = {1: 8, 2: 8, 4: 4, 8: 4}
ROWS = {torch.float32: _REAL_ROWS, torch.float64: _REAL_ROWS,
        torch.complex64: {1: 8, 2: 8, 4: 4, 8: 2},
        torch.complex128: {1: 7, 2: 4, 4: 4, 8: 1}}
_occupancy = {}               # (code, mode, b, groups, cw, vec) -> blocks/SM


def fused_update_dots(K: int, b: int,
                      dtype: torch.dtype = torch.float64) -> bool:
    """Whether update+dots is one kernel reading V once.  It is two sweeps
    (the updates, then the dots with the finished panel; V read twice) for a
    basis taller than one block's reach, and at the compiled width 8
    (complex128: from 4 up), where the fused kernel's running sums beside
    its held values spill and the two sweeps are the faster."""
    width = _compiled_width(b)
    return (K <= MAX_GROUPS * ROWS[dtype][width]
            and width < (4 if dtype == torch.complex128 else 8))


def _compiled_width(b: int) -> int:
    return next(w for w in WIDTHS if b <= w)


def _block_smem(mode: int, width: int, groups: int, cw: int, vw: int,
                dtype: torch.dtype) -> int:
    """Bytes of shared memory of one block (csrc/bv_panel.cu smem_elems)."""
    tc = 32 * cw * vw
    rows = ROWS[dtype][width]
    need = 0
    if mode:
        need = 2 * groups * width * tc
    if mode == 2:
        need += 2 * width * tc
    if mode and (width >= 4 or (mode == 2 and dtype == torch.complex128)):
        # the coefficients, for the wide panels and c128's update+dots
        need += groups * rows * width
    red = groups * cw * rows * width if mode != 1 else 0
    return max(need, red) * dtype.itemsize


def plan_panel(mode: int, K: int, b: int, n: int, dtype: torch.dtype, *,
               ldv: int | None = None, ldw: int | None = None,
               v_base: int = 0, w_base: int = 0, sm_count: int = 132,
               blocks_per_sm=None) -> dict:
    """How a sweep (mode 0 = dots, 1 = update, 2 = update + dots) launches K3
    for V (K, n), W (b, n) of ``dtype``: row strides in elements (n when left
    out), base addresses in bytes.  ``blocks_per_sm``: a function of (vec, one
    launch's dict) giving the compiled kernel's occupancy, else an estimate.

    Returns ``vec`` (16-byte loads, else one element a load), ``width`` (the
    compiled panel width), ``rows`` (basis rows a thread holds) and
    ``launches``: one dict per row chunk [k0, k1) of the basis with its
    ``groups`` (row groups), ``cw`` (warps across the columns), ``threads``,
    ``tile`` (columns), ``smem`` (bytes) and ``grid``."""
    if str(dtype) not in _build.DTYPE_CODE:
        raise TypeError(f"kernels take float32, float64, complex64 or "
                        f"complex128, got {dtype}")
    if mode not in (0, 1, 2):
        raise ValueError(f"panel sweep: no mode {mode}")
    if mode == 2 and b <= MAX_B and not fused_update_dots(K, b, dtype):
        raise ValueError(f"panel sweep: update+dots at K={K}, b={b} is an "
                         f"update sweep and a dots sweep, planned each")
    if K < 1 or b < 1 or n < 1:
        raise ValueError(f"panel sweep: empty shape K={K} b={b} n={n}")
    if b > MAX_B:
        raise ValueError(f"panel sweep: panel width {b} is more than the "
                         f"kernel takes ({MAX_B})")
    elt = dtype.itemsize
    vw = 16 // elt
    ldv = n if ldv is None else ldv
    ldw = n if ldw is None else ldw
    # the update's output is a new (b, n) tensor: its rows are aligned when
    # n is a multiple of the vector width
    vec = (n % vw == 0 and (ldv * elt) % 16 == 0 and (ldw * elt) % 16 == 0
           and v_base % 16 == 0 and w_base % 16 == 0)
    if not vec:
        vw = 1
    width = _compiled_width(b)
    rows = ROWS[dtype][width]
    reach = MAX_GROUPS * rows
    out = []
    for k0 in range(0, K, reach):
        k1 = min(k0 + reach, K)
        groups = -(-(k1 - k0) // rows)
        cw = max(1, 8 // groups)
        threads = 32 * groups * cw
        one = {"k0": k0, "k1": k1, "groups": groups, "cw": cw,
               "threads": threads, "tile": 32 * cw * vw,
               "smem": _block_smem(mode, width, groups, cw, vw, dtype)}
        if one["smem"] > SMEM_LIMIT:
            raise ValueError(f"panel sweep: {one['smem']} bytes of shared "
                             f"memory, more than the {SMEM_LIMIT} a block "
                             f"can use")
        per_sm = blocks_per_sm(vec, one) if blocks_per_sm is not None else max(
            1, min(2048 // threads, SMEM_LIMIT // (one["smem"] + 1024), 16))
        one["grid"] = max(1, min(-(-n // one["tile"]), sm_count * per_sm))
        out.append(one)
    return {"vec": vec, "width": width, "rows": rows, "launches": out}


def panel_dots_ref(V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return V.conj() @ W.T


def panel_update_ref(V: torch.Tensor, C: torch.Tensor,
                     W: torch.Tensor) -> torch.Tensor:
    return W - C.T @ V


def panel_update_dots_ref(V: torch.Tensor, C: torch.Tensor, W: torch.Tensor):
    U = panel_update_ref(V, C, W)
    return U, panel_dots_ref(V, U)


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


def _sweep(lib, code, mode, vec, one, V, W, C):
    """One kernel launch on the basis rows of ``one`` (a plan_panel launch
    dict): returns (Wout or None, D rows or None)."""
    K, n = V.shape
    b = W.shape[0]
    out = torch.empty((b, n), dtype=V.dtype, device=V.device) if mode else None
    dots = mode != 1
    partial = torch.empty((K * b, one["grid"]), dtype=V.dtype,
                          device=V.device) if dots else None
    D = torch.empty((K, b), dtype=V.dtype, device=V.device) if dots else None
    Cc = C.contiguous() if C is not None else None
    rc = lib.slepc_panel(
        code, mode, int(vec), V.data_ptr(), V.stride(0), K, W.data_ptr(),
        W.stride(0), b, Cc.data_ptr() if Cc is not None else None,
        out.data_ptr() if out is not None else None, n,
        partial.data_ptr() if partial is not None else None, one["grid"],
        one["groups"], one["cw"], D.data_ptr() if D is not None else None, n,
        _build.stream_handle(V))
    _build.check(rc, _NAMES[mode])
    return out, D


def _plan_for(lib, code, mode, V, W):
    """plan_panel for these tensors with the compiled kernel's occupancy."""
    K, n = V.shape
    b = W.shape[0]

    def per_sm(vec, one):
        okey = (code, mode, b, one["groups"], one["cw"], vec)
        if okey not in _occupancy:
            got = ctypes.c_int(0)
            _build.check(lib.slepc_panel_occupancy(
                code, mode, b, one["groups"], one["cw"], int(vec),
                ctypes.byref(got)), "panel occupancy")
            _occupancy[okey] = max(got.value, 1)
        return _occupancy[okey]

    return plan_panel(
        mode, K, b, n, V.dtype, ldv=V.stride(0), ldw=W.stride(0),
        v_base=V.data_ptr(), w_base=W.data_ptr(), blocks_per_sm=per_sm,
        sm_count=torch.cuda.get_device_properties(
            V.device).multi_processor_count)


def _run_plan(mode: int, V, W, C, plan_for, sweep):
    """A sweep as its kernel launches: one per row chunk of the basis, and
    update+dots as the updates then the dots where it is not one kernel
    (:func:`fused_update_dots`).  ``plan_for(m, W)`` gives the plan_panel
    dict of a mode-m sweep, ``sweep(m, vec, one, Vrows, W, Crows)`` runs one
    launch and returns (Wout or None, D rows or None).  Returns (Wout, D)."""

    def run(m, Wm):
        plan = plan_for(m, Wm)
        Ds = []
        for one in plan["launches"]:
            rows = slice(one["k0"], one["k1"])
            U, D = sweep(m, plan["vec"], one, V[rows], Wm,
                         C[rows] if m else None)
            if m:
                Wm = U  # the next chunk updates what this one left
            Ds.append(D)
        if m == 1:
            return Wm, None
        return Wm, (Ds[0] if len(Ds) == 1 else torch.cat(Ds))

    if mode == 2 and not fused_update_dots(V.shape[0], W.shape[0], V.dtype):
        U, _ = run(1, W)
        return U, run(0, U)[1]
    U, D = run(mode, W)
    return (U if mode else None), D


def _launch(mode: int, V, W, C):
    """mode 0 = dots, 1 = update, 2 = update + dots (see bv_panel.cu)."""
    code = _build.dtype_code(V)
    if V.stride(1) != 1 or W.stride(1) != 1:
        raise ValueError("panel sweep: rows of V and W must be contiguous")
    if W.shape[0] > MAX_B:
        raise ValueError(f"panel sweep: panel width {W.shape[0]} is more than "
                         f"the kernel takes")
    lib = _build.load()
    key = f"{_NAMES[mode]}_{_build.SUFFIX[code]}"

    def sweep(m, vec, one, Vrows, Wm, Crows):
        res = _sweep(lib, code, m, vec, one, Vrows, Wm, Crows)
        launches[key] += 1
        return res

    return _run_plan(mode, V, W, C,
                     lambda m, Wm: _plan_for(lib, code, m, V, Wm), sweep)


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
