#!/usr/bin/env python3
"""Drive the slepc_tpu_torch port once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each failing check raises; the script then exits non-zero):
  0. device: card name, nvidia-smi name and power limit; build the CUDA
     kernels from slepc_tpu_torch/csrc and report the build time;
  1. each kernel against its plain PyTorch version on the card, at the
     flagship shapes (200x225x230 3-D Laplacian, 10.35M rows): error and
     CUDA-event times (median of 20) of kernel and plain version, first
     the stream yardstick K7 (nd = 7, n = 10.35M, f32 and f64; its
     measured GB/s is the rate the other kernels' bytes are held against).
     Beside every kernel: its bound (bytes / 3.35 TB/s or operations / peak,
     whichever is larger), its bytes at K7's measured rate, and one PyTorch
     library call computing the same function (cuSPARSE CSR product for
     the SpMV kernels, the cuBLAS `@` that is the plain version of K3/K4,
     einsum for K7).  The CSR
     kernel K6 runs on the flagship built as a scipy CSR matrix and
     reordered with reverse Cuthill-McKee (an irregular pattern), and on
     that matrix plus seeded symmetric random entries (rows past 32
     entries); the un-permuted CSR must route to the DIA kernel;
  2. the plain Krylov-Schur cycle through EPS on laplacian_2d(95, 97),
     nev=6, ncv=28, in f64 (tol 1e-9) and f32 (tol 1e-5), as a DIA
     operator and as its RCM-ordered CSR matrix;
  3. the flagship through EPS: the k=20 smallest eigenpairs of the
     200x225x230 Laplacian in f64 to tol 1e-8, Chebyshev degree 450,
     ncv 48, certified against the closed-form spectrum;
  4. the same solve on the RCM-ordered CSR flagship through
     ``from_scipy``: the general-sparsity (AIJ) path on K6;
  5. the blocked flagship: the phase-3 solve with ``cheb_block = 4``, the
     blocked filtered cycle on the block DIA kernel K5, same gates;
  6. small paths: EPS(block_size=4, ncv=28) on laplacian_2d(95, 97) as DIA
     (K5) and as RCM-ordered CSR (K6 per row) in f64 and f32, and EPS
     with ``set_reorthogonalization("partial")`` in f64, with phase 2's
     gates; ks_cheb_smallest(reorth="partial") on laplacian_2d(80, 80) in
     f64 against the closed form;
  7. the shift-and-invert slice at full size: the 100x102x104 Laplacian
     (1,060,800 rows), f64, B = diag(1 + 0.5 sin(1e-3 i)), sigma = 0,
     800 fixed CG steps per inner solve on K2, nev 10, ncv 32, tol 1e-10
     on the transformed estimate (SINVERT_TOL says why), through
     EPS(A, B, "ghep") + STSinvertDevice: nconv >= 10 and max true
     residual ||A x - lam B x|| / (|lam| ||x||) <= 1e-8 recomputed with K2;
     then the standard problem on the same grid, |lam - exact| <= 1e-9.
     Before it, K2, K3 and K4 against their plain versions at the shapes
     phases 7 and 8 give them (each path's operator and basis height);
  8. small shift-and-invert paths: interior target with MINRES inner
     solves on laplacian_3d(8, 9, 10); host-factorized STSinvert through
     the general Krylov-Schur loop on laplacian_2d(95, 97) with an interior
     target (HEP, closed form) and with a diagonal B (GHEP, against scipy's
     eigsh), STCayley once; spectrum slicing on laplacian_2d(95, 97)
     (block-tridiagonal LDL^T on the card) and on laplacian_1d(1,000,000)
     over a mid-spectrum interval (scanned LDL^T inertia on the card),
     count and values against the closed forms, and every factorization
     of a slicing solve on that card backend.  The native LDL^T library
     must build (g++): a missing one fails the run.

  9. the path K3 sets the pace of, at full width: the plain (unfiltered)
     EPS(krylovschur, hep) on the 200x225x230 Laplacian, f64, ncv 48,
     which = "largest_real", stopped after 3 restarts (it need not
     converge): ms per column, the K2 / K3 / K4 launches, K3's share of
     the wall estimated from phase 1's per-sweep times, and every Ritz
     value inside [0, 12]; then the same restarts through ks_hep_cycle on a
     basis held here, its kept rows orthonormal to 1e-12.

Phase 1 also times K5 at b = 2, 4, 8 beside b single K1/K2 calls on the
same block, K3's three sweeps at panel width b = 4 (K = 52), and K4 in
place (out = V[:P]) and at (K, P) = (48, 1) and (4, 4), and the host time
of K3's and K4's launch planning beside a whole wrapper call at the small
paths' size.  The printed rows
show, in brackets, each kernel's time before the last redesign of K3 and K4
(BEFORE_MS: PERF.md's earlier reading, a constant, so not in the JSON line,
which holds only what this run measured).

    python3 chip_smoke.py --profile

adds, after phase 9, a torch.profiler split by kernel of one more phase-9
solve (K3's measured share of the device time), of one more phase-7 GHEP solve
(the device-busy share of the launch-bound inner solve), the residual of
phase 7's inner solve after 400 and 800 CG steps with the ungated solves
at EPS tol 1e-8 (what SINVERT_TOL rests on), a lane sweep of
K6 (every lane count the kernel is built for, natural and RCM order, f64
and f32, beside the DIA kernel on the same matrix) and a torch.profiler
split by kernel of one more phase-4 solve and one more phase-5 solve.  Its
launches are not counted.

Launch counters are reset to 0 before phase 2 and read after phase 3 (the
DIA path), reset again before phase 4 and read after it (the AIJ path),
before phase 5 and after it (the blocked path), before phase 6 and after
it (the small blocked and partial paths), before phase 7 and after
phase 8 (the shift-and-invert paths: K2, K3, K4), and before phase 9 and
after it (the plain cycle at full width); K7's launches are read around
its yardstick measurement in phase 1.  Every kernel of each path must
have launched.  The last three lines
are the kernel table as JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Needs one card; imports no JAX.
"""

import argparse
import json
import logging
import re
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

import slepc_tpu_torch as stt
from slepc_tpu_torch.ops import _build
from slepc_tpu_torch.ops.csr import (csr_spmv, csr_spmv_ref, lanes_for,
                                     row_of_entry)
from slepc_tpu_torch.ops.bv import (panel_dots, panel_dots_ref, panel_update,
                                    panel_update_dots, panel_update_dots_ref,
                                    panel_update_ref, plan_panel)
from slepc_tpu_torch.eps.cheb_accel import ks_cheb_smallest
from slepc_tpu_torch.eps.ks_jit import ks_hep_cycle
from slepc_tpu_torch.ops.dia import (dia_spmm, dia_spmm_ref, dia_spmv,
                                     dia_spmv_ref)
from slepc_tpu_torch.ops.rotate import plan_rotate, rotate, rotate_ref
from slepc_tpu_torch.ops.stream import (stream_bandwidth, stream_sum,
                                        stream_sum_ref)
from slepc_tpu_torch.native.ldl import ldl_available

FLAGSHIP = (200, 225, 230)
TAG = {torch.float32: "f32", torch.float64: "f64"}
SRC = "slepc_tpu_torch/csrc/"
# kernel entry -> (K#, source, the Pallas kernel function it replaces)
KERNELS = {
    "dia_spmv_f32": ("K1", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:463"),
    "dia_spmv_f64": ("K2", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:720"),
    "dia_spmm_f32": ("K5", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:280"),
    "dia_spmm_f64": ("K5", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:280"),
    "panel_dots_f32": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:74"),
    "panel_dots_f64": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:74"),
    "panel_update_f32": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:115"),
    "panel_update_f64": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:115"),
    "panel_update_dots_f32": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:160"),
    "panel_update_dots_f64": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:160"),
    "rotate_f32": ("K4", SRC + "rotate.cu", "slepc_tpu/ops/rotate_pallas.py:100"),
    "rotate_f64": ("K4", SRC + "rotate.cu", "slepc_tpu/ops/rotate_pallas.py:100"),
    "csr_spmv_f32": ("K6", SRC + "csr_spmv.cu", "slepc_tpu/ops/ell_pallas.py:197"),
    "csr_spmv_f64": ("K6", SRC + "csr_spmv.cu", "slepc_tpu/ops/ell_pallas.py:197"),
    "stream_sum_f32": ("K7", SRC + "stream.cu", "bench.py:164"),
    "stream_sum_f64": ("K7", SRC + "stream.cu", "bench.py:164"),
}
# Each kernel's time before the last redesign of K3 and K4, same script and
# shapes (PERF.md's kernel table: NVIDIA H100 80GB HBM3, 700.00 W), ms
BEFORE_MS = {
    "dia_spmv_f32": 0.2129, "dia_spmv_f64": 0.2866,
    "dia_spmm_f32": 0.3976, "dia_spmm_f64": 0.5643,
    "panel_dots_f32": 1.0976, "panel_dots_f64": 2.5056,
    "panel_update_f32": 1.0385, "panel_update_f64": 1.8921,
    "panel_update_dots_f32": 1.5866, "panel_update_dots_f64": 4.5716,
    "rotate_f32": 4.1784, "rotate_f64": 7.4997,
    "csr_spmv_f32": 0.7195, "csr_spmv_f64": 0.6416,
    "stream_sum_f32": 0.1562, "stream_sum_f64": 0.2739,
}
# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM;
# 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor cores.
CUBLAS = "the plain version's `@` (cuBLAS), timed once"
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def record(table, name, err_abs, err_rel, tol, ms, plain_ms, nbytes, flops,
           dtype, library_ms=None, library=""):
    """One kernel row: the error gate, the times measured here, and the
    bound computed from this run's inputs (nbytes: every input read once
    and every output written once; flops: the operations on them)."""
    check(np.isfinite(err_rel) and err_rel <= tol,
          f"{name}: relative error {err_rel:.3e} > {tol:.0e}")
    if library == CUBLAS:  # K3 / K4: the plain version is the library call
        library_ms = plain_ms
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    table[name] = {"max_abs_err": err_abs, "rel_err": err_rel, "ms": ms,
                   "plain_ms": plain_ms,
                   "bytes": nbytes,
                   "bound_ms": max(t_bytes, t_flops),
                   "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                   "library_ms": library_ms, "library": library,
                   "dtype": dtype}
    lib = f"  library {library_ms:.4f} ms ({library})" \
        if library_ms is not None else ""
    print(f"  {name:<22} err {err_rel:.3e} (tol {tol:.0e})  kernel {ms:.4f} ms"
          f" (PERF.md's earlier {BEFORE_MS[name]:.4f})  plain {plain_ms:.4f} ms  bound {max(t_bytes, t_flops):.4f} ms"
          f"  {nbytes / 1e9:.3f} GB -> {nbytes / ms / 1e6:.1f} GB/s{lib}",
          flush=True)


def spmv_errors(offsets, diags, x):
    """(max abs, relative to max |y|) error of K1/K2 against the plain
    version."""
    y_ref = dia_spmv_ref(offsets, diags, x)
    err = float((dia_spmv(offsets, diags, x) - y_ref).abs().max())
    return err, err / float(y_ref.abs().max())


def panel_errors(V, W, C):
    """{sweep: (max abs, max scaled)} error of K3's three sweeps against
    their plain versions.  Scaled by the sums of |products|: the kernel and
    torch add in different orders."""
    dscale = V.abs() @ W.abs().T
    uscale = W.abs() + C.abs().T @ V.abs()
    err = (panel_dots(V, W) - panel_dots_ref(V, W)).abs()
    out = {"panel_dots": (float(err.max()), float((err / dscale).max()))}
    err = (panel_update(V, C, W) - panel_update_ref(V, C, W)).abs()
    out["panel_update"] = (float(err.max()), float((err / uscale).max()))
    U, D = panel_update_dots(V, C, W)
    U_ref, D_ref = panel_update_dots_ref(V, C, W)
    err_u, err_d = (U - U_ref).abs(), (D - D_ref).abs()
    d2scale = V.abs() @ U_ref.abs().T
    out["panel_update_dots"] = (
        max(float(err_u.max()), float(err_d.max())),
        max(float((err_u / uscale).max()), float((err_d / d2scale).max())))
    return out


def rotate_errors(Q, V):
    """(max abs, max scaled by sum |products|) error of K4."""
    err = (rotate(Q, V) - rotate_ref(Q, V)).abs()
    return float(err.max()), float((err / (Q.abs().T @ V.abs())).max())


def random_q(K, P, dev, dtype, seed=2):
    """P orthonormal columns of length K (a restart's rotation)."""
    Qm, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((K, K)))
    return torch.from_numpy(np.ascontiguousarray(Qm[:, :P])).to(dev, dtype)


def phase1_stream(dev, table):
    """K7 against its plain version, then the yardstick itself: the rate
    every other kernel's bytes are held against, per dtype in GB/s."""
    print("phase 1: K7 (stream yardstick) vs plain PyTorch, nd = 7, "
          "n = 10,350,000", flush=True)
    nd, n = 7, FLAGSHIP[0] * FLAGSHIP[1] * FLAGSHIP[2]
    gen = torch.Generator(device=dev).manual_seed(7)
    rates = {}
    for dt, tol in ((torch.float32, 2e-6), (torch.float64, 1e-14)):
        d = torch.randn((nd, n), generator=gen, dtype=dt, device=dev)
        x = torch.randn(n, generator=gen, dtype=dt, device=dev)
        worst_abs = worst_rel = 0.0
        # the whole rows (n is a multiple of 4: the vector kernel alone), an
        # aligned window of odd length (the vector kernel and its scalar
        # tail) and a window whose base is not 16-byte aligned (the scalar
        # kernel)
        for dd, xx in ((d, x), (d[:, :n - 3], x[:n - 3].clone()),
                       (d[:, 1:n - 2], x[1:n - 2].clone())):
            y = stream_sum(dd, xx)
            y_ref = stream_sum_ref(dd, xx)
            err = float((y - y_ref).abs().max())
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / float(y_ref.abs().max()))
        y = torch.empty_like(x)
        ms = cuda_ms(lambda: stream_sum(d, x, out=y))
        plain = cuda_ms(lambda: stream_sum_ref(d, x))
        lib = cuda_ms(lambda: torch.einsum("kn,n->n", d, x))
        record(table, f"stream_sum_{TAG[dt]}", worst_abs, worst_rel, tol, ms,
               plain, (nd + 2) * n * x.element_size(), 2 * nd * n, dt, lib,
               "torch.einsum('kn,n->n')")
        del d, x, y, y_ref
        torch.cuda.empty_cache()
    # the yardstick's own path: counted from zero
    stt.reset_launch_counts()
    for dt in (torch.float32, torch.float64):
        rates[dt] = stream_bandwidth(nd, n, dt, dev)
        print(f"  stream_bandwidth({nd}, {n}, {TAG[dt]}) = {rates[dt]:.1f} GB/s "
              f"({100 * rates[dt] * 1e9 / PEAK_BYTES:.1f}% of 3.35 TB/s)",
              flush=True)
    return rates, stt.launch_counts()


def phase1(dev, table):
    print("phase 1: kernels vs plain PyTorch at the flagship shapes", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    lap = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    n = lap.shape[0]
    n_odd = n - 7  # random-coefficient DIA, n not a multiple of any block
    rnd = torch.randn((len(lap.offsets), n_odd), generator=gen,
                      dtype=torch.float64, device=dev)
    for dt, tol in ((torch.float64, 1e-14), (torch.float32, 2e-6)):
        name = f"dia_spmv_{TAG[dt]}"
        worst_abs = worst_rel = 0.0
        for i, diags in enumerate((lap.diags.to(dt), rnd.to(dt))):
            x = torch.randn(diags.shape[1], generator=gen, dtype=dt, device=dev)
            err, rel = spmv_errors(lap.offsets, diags, x)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            if i == 0:  # time the flagship operator itself
                ms = cuda_ms(lambda: dia_spmv(lap.offsets, diags, x))
                plain = cuda_ms(lambda: dia_spmv_ref(lap.offsets, diags, x))
        nbytes = (len(lap.offsets) + 2) * n * x.element_size()
        record(table, name, worst_abs, worst_rel, tol, ms, plain, nbytes,
               2 * lap.nnz, dt)  # library time: phase1_csr, on the CSR
        del diags, x
    del lap, rnd

    K, b = 49, 1
    for dt, tol in ((torch.float64, 1e-13), (torch.float32, 1e-5)):
        t = TAG[dt]
        V = torch.randn((K, n), generator=gen, dtype=dt, device=dev)
        W = torch.randn((b, n), generator=gen, dtype=dt, device=dev)
        C = torch.randn((K, b), generator=gen, dtype=dt, device=dev)
        elt = V.element_size()
        errs = panel_errors(V, W, C)
        record(table, f"panel_dots_{t}", *errs["panel_dots"], tol,
               cuda_ms(lambda: panel_dots(V, W)),
               cuda_ms(lambda: panel_dots_ref(V, W)),
               (K + b) * n * elt, 2 * K * b * n, dt, library=CUBLAS)
        record(table, f"panel_update_{t}", *errs["panel_update"], tol,
               cuda_ms(lambda: panel_update(V, C, W)),
               cuda_ms(lambda: panel_update_ref(V, C, W)),
               (K + 2 * b) * n * elt, 2 * K * b * n, dt, library=CUBLAS)
        record(table, f"panel_update_dots_{t}", *errs["panel_update_dots"],
               tol, cuda_ms(lambda: panel_update_dots(V, C, W)),
               cuda_ms(lambda: panel_update_dots_ref(V, C, W)),
               (K + 2 * b) * n * elt, 4 * K * b * n, dt, library=CUBLAS)

        Kr, P = 48, 40
        Q = random_q(Kr, P, dev, dt)
        Vr = V[:Kr]
        record(table, f"rotate_{t}", *rotate_errors(Q, Vr),
               1e-14 if dt == torch.float64 else 1e-5,
               cuda_ms(lambda: rotate(Q, Vr)),
               cuda_ms(lambda: rotate_ref(Q, Vr)),
               (Kr + P) * n * elt, 2 * Kr * P * n, dt, library=CUBLAS)
        # in place (the restart's call: out = V[:P], no copy-back) on a copy
        # of the basis; bitwise the out-of-place result
        Vw = Vr.clone()
        same = torch.equal(rotate(Q, Vw, out=Vw[:P]), rotate(Q, Vr))
        check(same, f"rotate_{t} in place differs from out of place")
        ms_in = cuda_ms(lambda: rotate(Q, Vw, out=Vw[:P]))
        print(f"  rotate_{t} in place ({Kr}, {P}): {ms_in:.4f} ms "
              f"({(Kr + P) * n * elt / ms_in / 1e6:.1f} GB/s)", flush=True)
        del Vw
        for Ks, Ps in ((48, 1), (4, 4)):  # one Ritz vector; a b x b block
            Qs, Vs = random_q(Ks, Ps, dev, dt), V[:Ks]
            rel = rotate_errors(Qs, Vs)[1]
            check(rel <= (1e-14 if dt == torch.float64 else 1e-5),
                  f"rotate_{t} ({Ks}, {Ps}): error {rel:.3e}")
            nb = (Ks + Ps) * n * elt
            ms_s = cuda_ms(lambda: rotate(Qs, Vs))
            print(f"  rotate_{t} ({Ks}, {Ps}): err {rel:.3e}  kernel "
                  f"{ms_s:.4f} ms  plain {cuda_ms(lambda: rotate_ref(Qs, Vs)):.4f}"
                  f" ms  bound {nb / PEAK_BYTES * 1e3:.4f} ms  "
                  f"{nb / ms_s / 1e6:.1f} GB/s", flush=True)
        del V, W, C, Vr, Q, Qs, Vs
        torch.cuda.empty_cache()


def phase1_planning(dev):
    """Host time of K3's and K4's launch planning (plain Python, redone at
    every call) beside the whole wrapper call at the small paths' size,
    where a solve is bound by launches: microseconds per call."""
    def us(fn, reps=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    K, n, f64 = 28, 95 * 97, torch.float64
    V = torch.randn((K, n), dtype=f64, device=dev)
    C = torch.randn((K, 1), dtype=f64, device=dev)
    Q = random_q(K, K // 2, dev, f64)
    print(f"  host microseconds a call at ({K}, {n}) f64: plan_panel "
          f"{us(lambda: plan_panel(2, K, 1, n, f64, blocks_per_sm=lambda *a: 4)):.1f}"
          f" of panel_update_dots {us(lambda: panel_update_dots(V, C, V[:1])):.1f}"
          f"; plan_rotate "
          f"{us(lambda: plan_rotate(K, K // 2, n, f64, blocks_per_sm=lambda *a: 2)):.1f}"
          f" of rotate {us(lambda: rotate(Q, V)):.1f}", flush=True)


def phase1_block(dev, table):
    print("phase 1: K5 (block DIA SpMM) vs plain PyTorch on the flagship "
          "operator, beside b single K1/K2 calls; K3 at b = 4", flush=True)
    gen = torch.Generator(device=dev).manual_seed(6)
    lap = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    n, nd = lap.shape[0], len(lap.offsets)
    for dt, tol in ((torch.float64, 1e-13), (torch.float32, 1e-6)):
        diags = lap.diags.to(dt)
        # X is a slice of a taller basis, as the blocked cycle hands it over
        V = torch.randn((12, n), generator=gen, dtype=dt, device=dev)
        for b in (2, 4, 8):
            X = V[3:3 + b]
            Y = dia_spmm(lap.offsets, diags, X)
            Y_ref = dia_spmm_ref(lap.offsets, diags, X)
            err = float((Y - Y_ref).abs().max())
            rel = err / float(Y_ref.abs().max())
            ms = cuda_ms(lambda: dia_spmm(lap.offsets, diags, X))
            plain = cuda_ms(lambda: dia_spmm_ref(lap.offsets, diags, X))
            single = cuda_ms(lambda: [dia_spmv(lap.offsets, diags, X[m])
                                      for m in range(b)])
            nbytes = (nd + 2 * b) * n * X.element_size()
            name = f"dia_spmm_{TAG[dt]}"
            print(f"  b={b}: {b} single K{2 if dt == torch.float64 else 1} "
                  f"calls {single:.4f} ms ({b * (nd + 2) * n * X.element_size() / 1e9:.3f} GB)",
                  flush=True)
            if b == 4:  # the path's block size goes into the kernel table
                record(table, name, err, rel, tol, ms, plain, nbytes,
                       2 * lap.nnz * b, dt)  # library time: phase1_csr
            else:
                check(np.isfinite(rel) and rel <= tol,
                      f"{name} b={b}: relative error {rel:.3e} > {tol:.0e}")
                print(f"  {name} b={b}: err {rel:.3e} (tol {tol:.0e})  "
                      f"kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                      f"{nbytes / 1e9:.3f} GB -> {nbytes / ms / 1e6:.1f} GB/s",
                      flush=True)
            del Y, Y_ref
        del V, diags
    del lap
    torch.cuda.empty_cache()

    K, b = 52, 4
    dt = torch.float64
    V = torch.randn((K, n), generator=gen, dtype=dt, device=dev)
    W = torch.randn((b, n), generator=gen, dtype=dt, device=dev)
    C = torch.randn((K, b), generator=gen, dtype=dt, device=dev)
    elt = V.element_size()
    sweeps = (("panel_dots", lambda: panel_dots(V, W),
               lambda: panel_dots_ref(V, W), (K + b) * n * elt),
              ("panel_update", lambda: panel_update(V, C, W),
               lambda: panel_update_ref(V, C, W), (K + 2 * b) * n * elt),
              ("panel_update_dots", lambda: panel_update_dots(V, C, W),
               lambda: panel_update_dots_ref(V, C, W), (K + 2 * b) * n * elt))
    for name, fn, ref_fn, nbytes in sweeps:
        out, ref = fn(), ref_fn()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        rel = max(float((o - r).abs().max() / r.abs().max())
                  for o, r in zip(outs, refs))
        check(rel <= 1e-12, f"{name} at b=4: relative error {rel:.3e}")
        ms, plain = cuda_ms(fn), cuda_ms(ref_fn)
        print(f"  {name}_f64 K={K} b={b}: err {rel:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain:.4f} ms  {nbytes / 1e9:.3f} GB -> "
              f"{nbytes / ms / 1e6:.1f} GB/s", flush=True)
        del out, ref, outs, refs
    del V, W, C
    torch.cuda.empty_cache()


CUSPARSE = "torch.sparse_csr_tensor @ x (cuSPARSE)"


def cusparse_ms(op, rhs):
    """Median time of the library's CSR product on op's matrix: rhs (n,) or
    (n, b).  Used nowhere in the port."""
    S = torch.sparse_csr_tensor(op.rowptr, op.cols.to(torch.int64), op.vals,
                                size=op.shape)
    ref = op.mult(rhs) if rhs.dim() == 1 else torch.stack(
        [op.mult(rhs[:, m].contiguous()) for m in range(rhs.shape[1])], dim=1)
    err = float(((S @ rhs) - ref).abs().max() / ref.abs().max())
    check(err <= (1e-12 if rhs.dtype == torch.float64 else 1e-5),
          f"library CSR product differs from the kernel by {err:.3e}")
    return cuda_ms(lambda: S @ rhs)


def rcm_order(L):
    """L reordered with reverse Cuthill-McKee (PETSc's MATORDERINGRCM)."""
    perm = reverse_cuthill_mckee(L, symmetric_mode=True)
    return L[perm][:, perm].tocsr()


def with_random_entries(A, seed=5):
    """A plus seeded symmetric random entries in ~5% of the rows, within
    +-2000 columns; 2000 of those rows get 40 each, past 32 entries (the
    gather-tier case of the JAX package's bench.py:260-272)."""
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    picked = rng.choice(n, n // 20, replace=False)
    k = rng.integers(1, 6, picked.size)
    k[:2000] = 40
    rows = np.repeat(picked, k)
    cols = np.clip(rows + rng.integers(-2000, 2001, rows.size), 0, n - 1)
    B = sp.csr_matrix((0.01 * rng.standard_normal(rows.size), (rows, cols)),
                      shape=A.shape)
    return (A + B + B.T).tocsr()


def pattern(op):
    """(bandwidth, distinct diagonal offsets, longest row) of a CSR operator."""
    off = op.cols.to(torch.int64) - row_of_entry(op.rowptr)
    return (int(off.abs().max()), int(torch.unique(off).numel()),
            int(op.rowptr.diff().max()))


def phase1_csr(dev, table, host):
    print("phase 1: K6 (CSR SpMV) vs plain PyTorch on the RCM-ordered "
          "flagship CSR", flush=True)
    t0 = time.perf_counter()
    L = stt.laplacian_3d(*FLAGSHIP, device="cpu").to_scipy()  # on the host
    host["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = rcm_order(L)
    host["rcm_s"] = time.perf_counter() - t0
    print(f"  host CSR: build {host['build_s']:.3f} s, RCM + permutation "
          f"{host['rcm_s']:.3f} s; n={A.shape[0]} nnz={A.nnz}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    ops = {"rcm": A, "rcm+random": with_random_entries(A)}
    for dt, tol in ((torch.float64, 1e-13), (torch.float32, 2e-6)):
        name = f"csr_spmv_{TAG[dt]}"
        worst_abs = worst_rel = 0.0
        for label, M in ops.items():
            op = stt.from_scipy(M, dtype=dt, device=dev)
            if dt == torch.float64:
                bw, noff, longest = pattern(op)
                print(f"  {label}: nnz={op.nnz} bandwidth={bw} "
                      f"distinct offsets={noff} longest row={longest}",
                      flush=True)
            x = torch.randn(op.shape[1], generator=gen, dtype=dt, device=dev)
            rows = row_of_entry(op.rowptr)
            y = csr_spmv(op.rowptr, op.cols, op.vals, x, op.shape[1])
            y_ref = csr_spmv_ref(op.rowptr, op.cols, op.vals, x, rows)
            err = float((y - y_ref).abs().max())
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / float(y_ref.abs().max()))
            if label == "rcm":  # time the flagship operator itself
                ms = cuda_ms(lambda: csr_spmv(op.rowptr, op.cols, op.vals, x,
                                              op.shape[1]))
                plain = cuda_ms(lambda: csr_spmv_ref(op.rowptr, op.cols,
                                                     op.vals, x, rows))
                elt = x.element_size()
                nbytes = (op.nnz * (elt + 4) + (op.shape[0] + 1) * 8
                          + 2 * op.shape[0] * elt)
                lib_ms = cusparse_ms(op, x)
            del op, x, rows, y, y_ref
        record(table, name, worst_abs, worst_rel, tol, ms, plain, nbytes,
               2 * A.nnz, dt, lib_ms, CUSPARSE)
    del ops
    torch.cuda.empty_cache()

    print("phase 1: routing: the un-permuted flagship CSR must run on the DIA "
          "kernel", flush=True)
    op = stt.from_scipy(L, device=dev)
    fast = op.fast_form()
    x = torch.randn(op.shape[1], generator=gen, dtype=torch.float64, device=dev)
    before = stt.launch_counts()
    y = fast.mult(x)
    counts = stt.launch_counts()
    delta = {k: counts[k] - before[k] for k in ("dia_spmv_f64", "csr_spmv_f64")}
    y6 = csr_spmv(op.rowptr, op.cols, op.vals, x, op.shape[1])
    err = float((y - y6).abs().max() / y.abs().max())
    print(f"  routed to {type(fast).__name__} offsets={fast.offsets}; one "
          f"SpMV launched {delta}; differs from K6 on the same CSR by "
          f"{err:.3e}", flush=True)
    check(isinstance(fast, stt.DIAOperator), "un-permuted CSR not routed to DIA")
    check(delta == {"dia_spmv_f64": 1, "csr_spmv_f64": 0},
          f"routed SpMV launched {delta}")
    check(err <= 1e-14, f"DIA route vs K6: {err:.3e}")
    del fast, x, y, y6
    print("phase 1: the library call beside K1/K2 and K5: cuSPARSE on the "
          "same matrix as a torch.sparse_csr_tensor", flush=True)
    n = op.shape[0]
    del op
    for dt in (torch.float64, torch.float32):
        op = stt.from_scipy(L, dtype=dt, device=dev)
        x = torch.randn(n, generator=gen, dtype=torch.float64,
                        device=dev).to(dt)
        X = torch.randn((n, 4), generator=gen, dtype=torch.float64,
                        device=dev).to(dt)
        for name, rhs in ((f"dia_spmv_{TAG[dt]}", x), (f"dia_spmm_{TAG[dt]}", X)):
            table[name]["library_ms"] = cusparse_ms(op, rhs)
            table[name]["library"] = CUSPARSE
            print(f"  {name}: library {table[name]['library_ms']:.4f} ms "
                  f"(kernel {table[name]['ms']:.4f} ms)", flush=True)
        del op, x, X
        torch.cuda.empty_cache()
    return L, A


def family_counts(counts, tag, spmv="dia_spmv"):
    return {"SpMV": counts[f"{spmv}_{tag}"],
            "K3": min(counts[f"panel_dots_{tag}"], counts[f"panel_update_{tag}"],
                      counts[f"panel_update_dots_{tag}"]),
            "K4": counts[f"rotate_{tag}"]}


F64_F32 = ((torch.float64, 1e-9), (torch.float32, 1e-5))


def small_solves(dev, label, paths, setup=None, max_it=400, dtypes=F64_F32):
    """EPS on laplacian_2d(95, 97), nev=6, ncv=28, as each (kind, SpMV
    counter) of ``paths`` in each (dtype, tol) of ``dtypes`` (f64 at 1e-9
    and f32 at 1e-5 unless given); ``setup`` configures the EPS.  Gates:
    nconv >= 6, |lam - exact| <= 1e-9 (f64) or relative 1e-4 (f32), and
    the path's kernels launched."""
    exact = stt.laplacian_2d_eigs(95, 97, k=6)
    csr = rcm_order(stt.laplacian_2d(95, 97).to_scipy())
    for kind, spmv in paths:
        for dt, tol in dtypes:
            before = stt.launch_counts()
            A = (stt.laplacian_2d(95, 97, dtype=dt, device=dev) if kind == "DIA"
                 else stt.from_scipy(csr, dtype=dt, device=dev))
            eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=6,
                          ncv=28, tol=tol, max_it=max_it,
                          options=stt.Options())
            if setup is not None:
                setup(eps)
            t0 = time.perf_counter()
            eps.solve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k = min(eps.nconv, 6)
            lam = np.sort(np.asarray(eps.eigenvalues[:k], np.float64))
            err = np.abs(lam - exact[:k]) if k else np.array([np.inf])
            counts = stt.launch_counts()
            delta = {k: counts[k] - before[k] for k in counts}
            fam = family_counts(delta, TAG[dt], spmv)
            where = f"{label} {kind} {TAG[dt]} (tol {tol:.0e})"
            print(f"  {where}: nconv={eps.nconv} its={eps.its} wall={wall:.3f} s "
                  f"max|lam-exact|={err.max():.3e} "
                  f"rel={np.max(err / exact[:max(k, 1)]):.3e} "
                  f"launches={fam}", flush=True)
            check(eps.nconv >= 6, f"{where}: nconv {eps.nconv} < 6")
            if dt == torch.float64:
                check(err.max() <= 1e-9,
                      f"{where}: |lam - exact| {err.max():.3e}")
            else:
                check(np.max(err / exact) <= 1e-4,
                      f"{where}: relative error {np.max(err / exact):.3e}")
            check(all(v > 0 for v in fam.values()),
                  f"{where}: a kernel did not launch: {fam}")


def phase2(dev):
    print("phase 2: plain Krylov-Schur through EPS, laplacian_2d(95, 97), as "
          "DIA (K1/K2) and as RCM-ordered CSR (K6)", flush=True)
    small_solves(dev, "phase 2", (("DIA", "dia_spmv"), ("CSR", "csr_spmv")))


def flagship_solve(A, where, spmv, cheb_block=1):
    """The flagship EPS solve on operator A; checks the certification gates
    and that the path's kernels launched (counts read as deltas).  Returns
    (wall, launch deltas, cheb stats)."""
    dev = A.device
    before = stt.launch_counts()
    eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=20,
                  tol=1e-8, options=stt.Options.from_cli(
                      "-eps_ncv 48 -eps_cheb_degree 450"))
    eps.cheb_keep_den = 3
    eps.cheb_block = cheb_block
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    st = eps.cheb_stats
    k = min(eps.nconv, 20)
    resid = np.array([eps.compute_error(i) for i in range(k)])
    exact = stt.laplacian_3d_eigs(*FLAGSHIP, k=20)
    lam = np.sort(np.asarray(eps.eigenvalues[:k], np.float64))
    eig_err = np.abs(lam - exact[:k])
    counts = stt.launch_counts()
    delta = {key: counts[key] - before[key] for key in counts}
    fam = family_counts(delta, "f64", spmv)
    print(f"  nconv={eps.nconv} wall={wall:.3f} s cycles={st['cycles']} "
          f"cols={st['cols']} adaptations={st['adaptations']} "
          f"certs={st['certs']} polish_rounds={st.get('polish_rounds', 0)} "
          f"cert_s={st.get('cert_s', 0.0):.3f} probe_s={st['probe_s']:.3f} "
          f"hi={st['hi']:.6g} peak_mem={peak / 1e9:.2f} GB", flush=True)
    print(f"  max true rel resid={resid.max() if k else np.inf:.3e} "
          f"max|lam-exact|={eig_err.max() if k else np.inf:.3e}", flush=True)
    print(f"  launches={delta}", flush=True)
    check(eps.nconv == 20, f"{where}: nconv {eps.nconv} != 20")
    check(resid.max() <= 1e-8, f"{where}: true residual {resid.max():.3e}")
    check(eig_err.max() <= 1e-9, f"{where}: |lam - exact| {eig_err.max():.3e}")
    check(all(v > 0 for v in fam.values()),
          f"{where}: a kernel did not launch: {fam}")
    return wall, delta, st


def phase3(dev):
    print("phase 3: flagship through EPS: 200x225x230 3-D Laplacian, k=20, "
          "tol 1e-8, f64, Chebyshev degree 450, ncv 48", flush=True)
    t0 = time.perf_counter()
    A = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    print(f"  operator built on the card in {time.perf_counter() - t0:.3f} s; "
          f"n={A.shape[0]}", flush=True)
    return flagship_solve(A, "phase 3", "dia_spmv")[0]


def phase5(dev):
    print("phase 5: the blocked flagship through EPS: phase 3's solve with "
          "cheb_block = 4 (the blocked filtered cycle on K5)", flush=True)
    A = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    b, degree, ncv_probe = 4, 450, 32
    wall, delta, st = flagship_solve(A, "phase 5", "dia_spmm", cheb_block=b)
    # every filtered column went through K5: each block step is one filtered
    # block apply = degree K5 launches, and the probe's 32 columns are plain
    want = degree * (st["cols"] - ncv_probe) // b
    print(f"  K5 launches {delta['dia_spmm_f64']} (degree x filtered "
          f"columns / b = {want}); K2 launches {delta['dia_spmv_f64']} "
          f"(probe, window adaptations, certification, polish)", flush=True)
    check(delta["dia_spmm_f64"] == want,
          f"phase 5: K5 ran {delta['dia_spmm_f64']} times, not {want}")
    return wall


def phase4(dev, A_csr, host):
    print("phase 4: the AIJ flagship through EPS: the RCM-ordered CSR of the "
          "same Laplacian from from_scipy, same settings", flush=True)
    t0 = time.perf_counter()
    A = stt.from_scipy(A_csr, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    print(f"  host CSR build {host['build_s']:.3f} s, RCM + permutation "
          f"{host['rcm_s']:.3f} s, from_scipy upload {upload_s:.3f} s; "
          f"n={A.shape[0]} nnz={A.nnz}", flush=True)
    wall, delta, _ = flagship_solve(A, "phase 4", "csr_spmv")
    check(delta["dia_spmv_f64"] == 0,
          f"phase 4: the DIA kernel ran {delta['dia_spmv_f64']} times")
    return wall


def phase6(dev):
    print("phase 6: small paths: blocked EPS (block_size 4) as DIA (K5) and "
          "as RCM-ordered CSR (K6 per row); partial reorthogonalization; "
          "Chebyshev with partial reorthogonalization", flush=True)
    # block Krylov depth per restart is ncv/b = 7: the blocked cycle needs
    # several hundred restarts here where the plain one needs ~56.  In f32
    # the blocked error estimates of the six wanted pairs level off (2e-6 to
    # 5e-5 with the plain versions on a CPU, 2e-5 to 2e-4 with the kernels;
    # lambda_1 ~ 2e-3 against ||A|| ~ 8): at tol 1e-5 the solve ran 3000
    # restarts on the card without converging, so the f32 solve runs at
    # tol 1e-4 (the gate on the eigenvalues is phase 2's)
    small_solves(dev, "phase 6 blocked",
                 (("DIA", "dia_spmm"), ("CSR", "csr_spmv")),
                 setup=lambda eps: setattr(eps, "block_size", 4), max_it=3000,
                 dtypes=((torch.float64, 1e-9), (torch.float32, 1e-4)))
    # f64 only: at tol 1e-5 the f32 semi-orthogonal basis (drift up to
    # sqrt(eps_f32) ~ 3e-4) never certifies this case, in the JAX package
    # either (its EPS stalls at nconv 0 after 400 cycles on the CPU)
    small_solves(dev, "phase 6 partial", (("DIA", "dia_spmv"),),
                 setup=lambda eps: eps.set_reorthogonalization("partial"),
                 dtypes=F64_F32[:1])
    # tests/test_round5.py:55-64 of the JAX package
    before = stt.launch_counts()
    t0 = time.perf_counter()
    res = ks_cheb_smallest(stt.laplacian_2d(80, 80, device=dev), nev=10,
                           tol=1e-8, ncv=32, degree=80, reorth="partial")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = stt.launch_counts()
    fam = family_counts({k: counts[k] - before[k] for k in counts}, "f64")
    err = np.abs(np.sort(res["lam"][:10]) - stt.laplacian_2d_eigs(80, 80, k=10))
    print(f"  cheb partial f64: nconv={res['nconv']} wall={wall:.3f} s "
          f"cols={res['stats']['cols']} cycles={res['stats']['cycles']} "
          f"max|lam-exact|={err.max():.3e} "
          f"max resid={np.max(res['resid'][:10]):.3e} launches={fam}",
          flush=True)
    check(res["nconv"] >= 10, f"phase 6 cheb partial: nconv {res['nconv']}")
    check(err.max() <= 1e-10, f"phase 6 cheb partial: |lam - exact| "
          f"{err.max():.3e}")
    check(np.max(res["resid"][:10]) <= 1e-8, "phase 6 cheb partial: residual")
    check(all(v > 0 for v in fam.values()),
          f"phase 6 cheb partial: a kernel did not launch: {fam}")


SINVERT_GRID = (100, 102, 104)  # 1,060,800 rows
SINVERT_ITERS = 800
# The cycle's estimate ||M u - theta u|| / theta lives in the transformed
# space (M = D^1/2 A^-1 D^1/2, theta = 1/lambda ~ 358); the residual of the
# original pencil is ||A D^-1/2 r_u|| / ||x||, up to ||A|| / lambda_1 ~ 4e3
# times larger.  At the deployment's tol 1e-8 the solve stopped after 2
# cycles with a true residual of 4.1e-7 (GHEP) / 1.8e-7 (standard) although
# 800 CG steps solve to 1.1e-14; one more cycle at tol 1e-10 gives 2.1e-12
# (H100 80GB HBM3, 700 W).  The gate on the true residual stays 1e-8.
SINVERT_TOL = 1e-10


def sinvert_kernels(dev):
    """K2, K3 and K4 against their plain versions at the shapes phases 7
    and 8 give them (f64, phase 1's tolerances): K2 on each path's operator;
    K3's three sweeps against 1, ncv and ncv + 1 basis rows of its length
    (the first column, the last, and the basis with its residual row); K4
    at (ncv, ncv) (the fast path's restart), (ncv, ncv // 2) (the general
    loop keeps half) and (ncv, 1) (one Ritz vector).  Run before the
    paths' launch counts are reset: these launches are not theirs."""
    print("phases 7-8: K2, K3, K4 vs plain PyTorch at the shift-and-invert "
          "paths' shapes", flush=True)
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(8)
    for where, A, ncv in (
            ("phase 7, 100x102x104", stt.laplacian_3d(
                *SINVERT_GRID, dtype=f64, device=dev), 32),
            ("phase 8 MINRES, 8x9x10", stt.laplacian_3d(
                8, 9, 10, dtype=f64, device=dev), 20),
            ("phase 8 general loop, 95x97", stt.laplacian_2d(
                95, 97, dtype=f64, device=dev), 21),
            ("phase 8 slicing, 95x97", stt.laplacian_2d(
                95, 97, dtype=f64, device=dev), 64),
            ("phase 8 slicing, 1-D 1,000,000", stt.laplacian_1d(
                1_000_000, dtype=f64, device=dev), 64)):
        n = A.shape[0]
        x = torch.randn(n, generator=gen, dtype=f64, device=dev)
        worst = {"K2": spmv_errors(A.offsets, A.diags, x)[1], "K3": 0.0,
                 "K4": 0.0}
        V = torch.randn((ncv + 1, n), generator=gen, dtype=f64, device=dev)
        C = torch.randn((ncv + 1, 1), generator=gen, dtype=f64, device=dev)
        for K in (1, ncv, ncv + 1):
            errs = panel_errors(V[:K], x[None], C[:K])
            worst["K3"] = max(worst["K3"], *(rel for _, rel in errs.values()))
        for P in (ncv, ncv // 2, 1):
            worst["K4"] = max(worst["K4"], rotate_errors(
                random_q(ncv, P, dev, f64), V[:ncv])[1])
        print(f"  {where}: n={n} nd={len(A.offsets)} ncv={ncv}  "
              + "  ".join(f"{k} {v:.3e}" for k, v in worst.items()),
              flush=True)
        check(worst["K2"] <= 1e-14, f"{where}: K2 error {worst['K2']:.3e}")
        check(worst["K3"] <= 1e-13, f"{where}: K3 error {worst['K3']:.3e}")
        check(worst["K4"] <= 1e-14, f"{where}: K4 error {worst['K4']:.3e}")
        del A, x, V, C
    torch.cuda.empty_cache()


def sinvert_solve(dev, where, generalized, tol=SINVERT_TOL, gate=True):
    """The device shift-and-invert solve at full size: sigma = 0, fixed
    CG inner solves on K2, nev 10, ncv 32, ``tol`` on the transformed
    estimate.  ``gate``: hold nconv and the true residual to phase 7's
    gates.  Returns (eps, wall, launch deltas)."""
    n = SINVERT_GRID[0] * SINVERT_GRID[1] * SINVERT_GRID[2]
    A = stt.laplacian_3d(*SINVERT_GRID, dtype=torch.float64, device=dev)
    mats = [A]
    if generalized:
        bd = 1.0 + 0.5 * torch.sin(
            torch.arange(n, dtype=torch.float64, device=dev) * 1e-3)
        mats.append(stt.DIAOperator((0,), bd[None, :]))
    before = stt.launch_counts()
    eps = stt.EPS(*mats, problem_type="ghep" if generalized else "hep",
                  which="target_magnitude", nev=10, ncv=32, tol=tol,
                  options=stt.Options())
    eps.set_target(0.0)
    eps.set_st(stt.STSinvertDevice(mats, sigma=0.0, iters=SINVERT_ITERS))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    counts = stt.launch_counts()
    delta = {k: counts[k] - before[k] for k in counts}
    fam = family_counts(delta, "f64")
    cols = delta["dia_spmv_f64"] // SINVERT_ITERS
    k = min(eps.nconv, 10)
    # true residual ||A x - lam B x|| / (|lam| ||x||), recomputed with K2
    resid = np.array([eps.compute_error(i) for i in range(k)])
    print(f"  {where}: nconv={eps.nconv} wall={wall:.3f} s cycles={eps.its} "
          f"columns={cols} ({wall / max(cols, 1) * 1e3:.1f} ms each, "
          f"{wall / max(cols * SINVERT_ITERS, 1) * 1e6:.1f} us per CG step) "
          f"launches={fam} peak_mem={peak / 1e9:.2f} GB", flush=True)
    print(f"  {where}: max true rel resid="
          f"{resid.max() if k else np.inf:.3e} lam={np.sort(eps.eigenvalues[:k])}",
          flush=True)
    if gate:
        check(eps.nconv >= 10, f"{where}: nconv {eps.nconv} < 10")
        check(resid.max() <= 1e-8, f"{where}: true residual {resid.max():.3e}")
    check(all(v > 0 for v in fam.values()),
          f"{where}: a kernel did not launch: {fam}")
    return eps, wall, delta


def sinvert_tol_study(dev):
    """What bounds phase 7's true residual: the relative residual of the
    inner solve (cg_fixed on the 100x102x104 Laplacian, seeded random b)
    after 400 and 800 steps, and the ungated solves at the deployment's
    tol 1e-8 beside SINVERT_TOL."""
    from slepc_tpu_torch.ksp.iterative_jit import cg_fixed

    print("profile: phase 7's inner solve and EPS tolerance", flush=True)
    A = stt.laplacian_3d(*SINVERT_GRID, dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = torch.randn(A.shape[0], generator=gen, dtype=torch.float64, device=dev)
    for iters in (400, SINVERT_ITERS):
        x = cg_fixed(A.mult, b, iters)
        r = float(torch.linalg.vector_norm(b - A.mult(x))
                  / torch.linalg.vector_norm(b))
        print(f"  cg_fixed iters={iters}: ||b - A x|| / ||b|| = {r:.3e}",
              flush=True)
    del A, b, x
    for generalized in (True, False):
        sinvert_solve(dev, f"tol 1e-8 {'GHEP' if generalized else 'standard'}",
                      generalized, tol=1e-8, gate=False)


def phase7(dev):
    print("phase 7: the shift-and-invert slice at full size: 100x102x104 "
          "Laplacian (1,060,800 rows), f64, sigma = 0, CG iters = 800, "
          f"nev 10, ncv 32, tol {SINVERT_TOL:g} on the transformed estimate, "
          "gate 1e-8 on the true residual", flush=True)
    _, wall_g, _ = sinvert_solve(dev, "phase 7 GHEP", generalized=True)
    eps, wall_s, _ = sinvert_solve(dev, "phase 7 standard", generalized=False)
    exact = stt.laplacian_3d_eigs(*SINVERT_GRID, k=10)
    err = np.abs(np.sort(eps.eigenvalues[:10]) - exact)
    print(f"  phase 7 standard: max|lam-exact|={err.max():.3e}", flush=True)
    check(err.max() <= 1e-9, f"phase 7 standard: |lam - exact| {err.max():.3e}")
    return wall_g, wall_s


def near(exact, target, k):
    return np.sort(exact[np.argsort(np.abs(exact - target))][:k])


def report(where, eps, want, t0, tol, resid_tol=1e-8):
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k = len(want)
    check(eps.nconv >= k, f"{where}: nconv {eps.nconv} < {k}")
    got = np.sort(np.asarray(eps.eigenvalues[:k], np.float64))  # best-first
    err = np.abs(got - want).max()
    resid = max(eps.compute_error(i) for i in range(k))
    print(f"  {where}: nconv={eps.nconv} its={eps.its} wall={wall:.3f} s "
          f"max|lam-ref|={err:.3e} max true rel resid={resid:.3e}", flush=True)
    check(err <= tol, f"{where}: |lam - ref| {err:.3e} > {tol:.0e}")
    check(resid <= resid_tol, f"{where}: true residual {resid:.3e}")


def phase8(dev):
    print("phase 8: small shift-and-invert paths on the card", flush=True)
    check(ldl_available(), "the native LDL^T library did not build (g++): "
          "the host-direct paths would run on splu alone")
    f64 = torch.float64
    # interior target, MINRES inner solves (tests/test_round4.py:299-316 of
    # the JAX package)
    A = stt.laplacian_3d(8, 9, 10, dtype=f64, device=dev)
    lam_all = stt.laplacian_3d_eigs(8, 9, 10)
    sigma = float(0.5 * (lam_all[7] + lam_all[8]))
    t0 = time.perf_counter()
    eps = stt.EPS(A, problem_type="hep", which="target_magnitude", nev=4,
                  ncv=20, tol=1e-9, options=stt.Options())
    eps.set_target(sigma)
    eps.set_st(stt.STSinvertDevice([A], sigma=sigma, iters=600,
                                   method="minres"))
    eps.solve()
    report("device sinvert, interior, MINRES", eps, near(lam_all, sigma, 4),
           t0, 1e-7, resid_tol=1e-6)

    # host-factorized STSinvert through the general loop
    A = stt.laplacian_2d(95, 97, dtype=f64, device=dev)
    n = A.shape[0]
    exact = stt.laplacian_2d_eigs(95, 97)
    target = 2.0
    t0 = time.perf_counter()
    eps = stt.EPS(A, problem_type="hep", nev=6, options=stt.Options())
    eps.set_target(target)
    eps.solve()
    check(eps.st.name == "sinvert" and eps.st.ksp.method == "direct",
          "HEP target did not take the direct shift-and-invert")
    print(f"  factorization backend: {eps.st.ksp._direct.backend}", flush=True)
    report("STSinvert HEP, general loop", eps, near(exact, target, 6), t0, 1e-9)

    bd = 1.0 + 0.5 * torch.sin(torch.arange(n, dtype=f64, device=dev) * 1e-2)
    B = stt.DIAOperator((0,), bd[None, :])
    import scipy.sparse.linalg as spla
    ref = np.sort(spla.eigsh(A.to_scipy().tocsc(), k=6,
                             M=sp.diags(bd.cpu().numpy()).tocsc(),
                             sigma=target, which="LM",
                             return_eigenvectors=False))
    t0 = time.perf_counter()
    eps = stt.EPS(A, B, problem_type="ghep", nev=6, options=stt.Options())
    eps.set_target(target)
    eps.solve()
    report("STSinvert GHEP (diagonal B) vs scipy eigsh", eps, ref, t0, 1e-9)
    X = eps._eigenvectors[:6]
    G = (X * bd) @ X.T
    orth = float((G - torch.eye(6, dtype=f64, device=dev)).abs().max())
    print(f"  B-orthonormality of the eigenvectors: {orth:.3e}", flush=True)
    check(orth <= 1e-8, f"GHEP eigenvectors not B-orthonormal: {orth:.3e}")

    t0 = time.perf_counter()
    eps = stt.EPS(A, problem_type="hep", nev=6, options=stt.Options())
    eps.set_target(target)
    eps.set_st(stt.STCayley([A], sigma=target, nu=1.0))
    eps.solve()
    report("STCayley HEP", eps, near(exact, target, 6), t0, 1e-9)

    # spectrum slicing: block-tridiagonal LDL^T, then the scanned one
    for label, A, exact, lo, backend in (
            ("laplacian_2d(95, 97)", A, exact, 2000, "btridiag_device"),
            ("laplacian_1d(1,000,000)",
             stt.laplacian_1d(1_000_000, dtype=f64, device=dev),
             stt.laplacian_1d_eigs(1_000_000), 500_000, "tridiag_device")):
        a = 0.5 * (exact[lo - 1] + exact[lo])
        b = 0.5 * (exact[lo + 29] + exact[lo + 30])
        want = exact[lo: lo + 30]
        stt.log_begin()
        t0 = time.perf_counter()
        eps = stt.EPS(A, problem_type="hep", tol=1e-8, options=stt.Options())
        eps.set_interval(a, b)
        eps.solve()
        check(eps.nconv == 30, f"slicing {label}: found {eps.nconv} of 30 "
              f"eigenvalues in [{a}, {b}]")
        report(f"slicing {label}, 30 eigenvalues in [{a:.6f}, {b:.6f}]", eps,
               want, t0, 1e-9)
        from slepc_tpu_torch.sys.events import get_event

        fac = get_event("Slice_Factorization")
        print(f"  factorizations={eps.slice_factorizations} "
              f"({fac['time']:.3f} s) backends={eps.slice_backends}",
              flush=True)
        # inertia and solves on the card: a host backend would pass the
        # closed-form gates unseen
        check(eps.slice_backends == (backend,), f"slicing {label}: factorized "
              f"with {eps.slice_backends}, not {backend}")
        stt.log_reset()
        del A


def plain_solve(A, ncv, restarts, cycles=None):
    """The plain EPS(krylovschur, hep) solve of phase 9, stopped after
    ``restarts`` restarts.  ``cycles`` collects, at each restart, (converged
    count, Ritz values, host clock, launch counts).  Returns (eps, wall)."""
    eps = stt.EPS(A, problem_type="hep", which="largest_real", nev=4,
                  ncv=ncv, tol=1e-8, max_it=restarts, options=stt.Options())
    if cycles is not None:
        eps.monitor.add(lambda _e, _its, k2, theta, _err: cycles.append(
            (int(k2), np.array(theta, np.float64), time.perf_counter(),
             stt.launch_counts())))
    t0 = time.perf_counter()
    eps.solve()
    torch.cuda.synchronize()
    return eps, time.perf_counter() - t0


def phase9(dev, table):
    """The plain Krylov-Schur cycle at 10.35M rows: one K2 call and three
    K3 sweeps a column, one K4 call a restart.  Returns the wall and the
    solve's launch counts."""
    ncv, restarts = 48, 3
    print("phase 9: the plain (unfiltered) Krylov-Schur cycle at full width: "
          f"200x225x230 Laplacian, f64, ncv {ncv}, largest_real, stopped "
          f"after {restarts} restarts (it need not converge)", flush=True)
    A = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    cycles = []
    before = stt.launch_counts()
    eps, wall = plain_solve(A, ncv, restarts, cycles)
    counts = stt.launch_counts()
    delta = {k: counts[k] - before[k] for k in counts}
    fam = family_counts(delta, "f64")
    check(len(cycles) > 1, "phase 9: no restarted cycle ran")
    # a cycle's columns are its K2 launches; it extends a basis of
    # ncv - columns kept rows, so its columns meet kept + 1 .. ncv rows
    marks = [before] + [c[3] for c in cycles]
    cols = [m1["dia_spmv_f64"] - m0["dia_spmv_f64"]
            for m0, m1 in zip(marks, marks[1:])]
    check(sum(cols) == delta["dia_spmv_f64"] and cols[0] == ncv,
          f"phase 9: columns per restart {cols}")
    # the restarted cycles alone: the first one's window also holds the
    # solve's set-up (the start vector is drawn on the host)
    later = [K for c in cols[1:] for K in range(ncv - c + 1, ncv + 1)]
    later_ms = (cycles[-1][2] - cycles[0][2]) * 1e3
    # an estimate, not this solve's device time: phase 1's sweeps at K = 49,
    # b = 1, scaled by the bytes of a K-row sweep
    per49 = sum(table[f"panel_{s}_f64"]["ms"]
                for s in ("dots", "update_dots", "update"))
    k3_ms = sum(per49 * (K + 2) / 51 for K in later)
    theta = cycles[-1][1]
    print(f"  nconv={eps.nconv} (not required) restarts={eps.its} "
          f"wall={wall:.3f} s columns={sum(cols)} launches={fam}", flush=True)
    print(f"  restarts 2..{len(cycles)}: {len(later)} columns against "
          f"{min(later)}..{max(later)} rows in {later_ms:.1f} ms (host clock) "
          f"= {later_ms / len(later):.3f} ms per column; K3 estimated from "
          f"phase 1's sweeps (K = 49: {per49:.4f} ms, scaled by rows) "
          f"{k3_ms:.1f} ms = {100 * k3_ms / later_ms:.1f}% of it; K2 estimated "
          f"{len(later) * table['dia_spmv_f64']['ms']:.1f} ms", flush=True)
    print(f"  Ritz values in [{theta.min():.6f}, {theta.max():.6f}]",
          flush=True)
    check(eps.its == restarts or eps.nconv >= 4, f"phase 9: {eps.its} restarts")
    check(theta.min() >= 0.0 and theta.max() <= 12.0,
          f"phase 9: Ritz values outside [0, 12]: {theta.min()}, {theta.max()}")
    check(all(v > 0 for v in fam.values()),
          f"phase 9: a kernel did not launch: {fam}")
    del eps
    # the basis gate: the solve frees its basis, so the same restarts are
    # driven once more through the cycle function on a basis held here
    V = torch.zeros((ncv + 1, A.shape[0]), dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    V[0] = torch.randn(A.shape[0], generator=gen, dtype=torch.float64,
                       device=dev)
    V[0] /= torch.linalg.vector_norm(V[0])
    H, j0 = np.zeros((ncv + 1, ncv)), 0
    for _ in range(restarts):
        V, H, j0 = ks_hep_cycle(A, V, H, j0, 1e-8, gen, ncv=ncv,
                                which="largest")[:3]
    B = V[: j0 + 1]
    orth = float((B @ B.T - torch.eye(j0 + 1, dtype=B.dtype,
                                      device=dev)).abs().max())
    print(f"  {restarts} restarts through ks_hep_cycle: kept basis rows "
          f"{j0 + 1}, max|V V^T - I| = {orth:.3e}", flush=True)
    check(orth <= 1e-12, f"phase 9: basis not orthonormal: {orth:.3e}")
    return wall, delta


def csr_spmv_at(op, x, lanes):
    """K6 on op's CSR at a given lane count: the library entry itself, which
    the wrapper csr_spmv calls with lanes_for (uncounted; for the sweep)."""
    y = torch.empty(op.shape[0], dtype=x.dtype, device=x.device)
    rc = _build.load().slepc_csr_spmv(
        _build.dtype_code(x), lanes, op.rowptr.data_ptr(), op.cols.data_ptr(),
        op.vals.data_ptr(), x.data_ptr(), y.data_ptr(), op.shape[0],
        _build.stream_handle(x))
    _build.check(rc, "csr_spmv")
    return y


def lane_sweep(dev, L, A):
    print("profile: K6 at each lane count (ms, CUDA events, median of 20), "
          "natural and RCM order, beside the DIA kernel", flush=True)
    gen = torch.Generator(device=dev).manual_seed(4)
    for dt, tol in ((torch.float64, 1e-13), (torch.float32, 2e-6)):
        for label, M in (("natural", L), ("RCM", A)):
            op = stt.from_scipy(M, dtype=dt, device=dev)
            x = torch.randn(op.shape[1], generator=gen, dtype=dt, device=dev)
            y = csr_spmv(op.rowptr, op.cols, op.vals, x, op.shape[1])
            times = []
            for lanes in (2, 4, 8, 16, 32):
                err = float((csr_spmv_at(op, x, lanes) - y).abs().max()
                            / y.abs().max())
                check(err <= tol, f"K6 at {lanes} lanes: {err:.3e}")
                ms = cuda_ms(lambda: csr_spmv_at(op, x, lanes))
                times.append(f"L{lanes}={ms:.4f}")
            fast = op.fast_form()
            if isinstance(fast, stt.DIAOperator):
                times.append(f"DIA={cuda_ms(lambda: fast.mult(x)):.4f}")
            print(f"  {label} {TAG[dt]}: {' '.join(times)} (lanes_for picks "
                  f"{lanes_for(op.shape[0], op.nnz)})", flush=True)
            del op, x, y, fast
            torch.cuda.empty_cache()


def profile_solve(where, solve, plain_wall=None):
    """torch.profiler over ``solve()``, which returns the wall time.
    ``plain_wall``: the same solve's wall without the profiler (its host
    overhead stretches a launch-bound solve; kernel times stay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"profile: torch.profiler over one {where} solve", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = solve()
    averages = prof.key_averages()
    # a log_event annotation has a host row and a device-side row spanning
    # its kernels; a kernel has a device-side row only
    host_keys = {e.key for e in averages if e.device_type == DeviceType.CPU}
    rows = sorted((e for e in averages if e.self_device_time_total > 0
                   and not (e.device_type == DeviceType.CUDA
                            and e.key in host_keys)),
                  key=lambda e: -e.self_device_time_total)
    # device-side rows only: an aten op's row repeats its kernels' time
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  profiled wall {wall:.3f} s; device rows sum to {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}% of the wall)", flush=True)
    if plain_wall is not None:
        print(f"  the same solve without the profiler took {plain_wall:.3f} s:"
              f" device busy {100 * busy / (plain_wall * 1e3):.1f}% of it",
              flush=True)
    for e in rows[:16]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:10.1f} ms {e.count:7d} calls {ms / e.count:8.4f} ms/call "
              f"{100 * ms / (wall * 1e3):5.1f}% {e.device_type.name:<5} "
              f"{e.key[:90]}", flush=True)


def kernel_resources(log):
    """Registers and spills of every compiled kernel (nvcc -Xptxas -v)."""
    names = (("panel_kernelI([df])Li(\\d)ELi(\\d)ELb([01])ELb([01])E",
              "K3 panel<{}, B={}, VW={}, update={}, dots={}>"),
             ("rotate_f64_kernelILi(\\d)ELb([01])E", "K4 rotate_f64<MT={}, vec={}>"),
             ("rotate_f32_kernelILb([01])E", "K4 rotate_f32<vec={}>"))
    entry, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+?)'", line)
        if m:
            entry, spill = m.group(1), ""
            for pat, fmt in names:
                hit = re.search(pat, entry)
                if hit:
                    entry = fmt.format(*hit.groups())
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and entry is not None:
            regs = re.search(r"Used (\d+) registers", line)
            print(f"    {entry[:80]}: {regs.group(1) if regs else '?'} "
                  f"registers; {spill}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="after phase 9: phase 7's tolerance study, a "
                             "K6 lane sweep and a torch.profiler split of a "
                             "phase-7, a phase-4 and a phase-5 solve")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="    %(message)s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave no output"
    print(f"phase 0: device {kind}; nvidia-smi: {smi_line}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"  kernels built+loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.2f} s)",
          flush=True)
    kernel_resources(_build.build_log)

    table, host = {}, {}
    rates, stream_path = phase1_stream(dev, table)
    phase1(dev, table)
    phase1_planning(dev)
    phase1_block(dev, table)
    L_csr, A_csr = phase1_csr(dev, table, host)
    if not args.profile:
        del L_csr
    # the comparisons above do not count: each path is read from zero
    stt.reset_launch_counts()
    phase2(dev)
    wall = phase3(dev)
    dia_path = stt.launch_counts()
    stt.reset_launch_counts()
    wall_aij = phase4(dev, A_csr, host)
    aij_path = stt.launch_counts()
    stt.reset_launch_counts()
    wall_blk = phase5(dev)
    blk_path = stt.launch_counts()
    stt.reset_launch_counts()
    phase6(dev)
    small_path = stt.launch_counts()
    sinvert_kernels(dev)
    stt.reset_launch_counts()
    wall_sinv, wall_sinv_std = phase7(dev)
    phase8(dev)
    sinv_path = stt.launch_counts()
    fam = family_counts(sinv_path, "f64")
    print(f"  phases 7-8 launches: {fam}", flush=True)
    check(all(v > 0 for v in fam.values()),
          f"phases 7-8: a kernel did not launch: {fam}")
    stt.reset_launch_counts()
    wall_plain, plain_path = phase9(dev, table)
    if args.profile:
        A = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
        profile_solve("phase 9", lambda: plain_solve(A, 48, 3)[1],
                      plain_wall=wall_plain)
        del A
        profile_solve("phase 7 GHEP", lambda: sinvert_solve(
            dev, "profiled phase 7 GHEP", generalized=True)[1],
            plain_wall=wall_sinv)
        sinvert_tol_study(dev)
        lane_sweep(dev, L_csr, A_csr)
        A = stt.from_scipy(A_csr, device=dev)
        profile_solve("phase 4", lambda: flagship_solve(
            A, "profiled phase 4", "csr_spmv")[0])
        A = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
        profile_solve("phase 5", lambda: flagship_solve(
            A, "profiled phase 5", "dia_spmm", cheb_block=4)[0])
    paths = (stream_path, dia_path, aij_path, blk_path, small_path, sinv_path,
             plain_path)
    counts = {k: sum(p[k] for p in paths) for k in dia_path}
    missing = [k for k in KERNELS if counts[k] == 0]
    check(not missing, f"kernels never launched on the main path: {missing}")
    kernels = []
    for key, (knum, src, replaces) in KERNELS.items():
        row = table[key]
        kernels.append({"name": f"{key} ({knum})", "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": counts[key],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "stream_ms": row["bytes"] / rates[row["dtype"]] / 1e6,
                        "library_ms": row["library_ms"],
                        "library": row["library"] or None})
    print("kernel table (ms): kernel (PERF.md's earlier reading, not measured "
          "here) / plain / bound / stream / library", flush=True)
    for k in kernels:
        lib = "-" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        print(f"  {k['name']:<28} {k['ms']:.4f} "
              f"({BEFORE_MS[k['name'].split()[0]]:.4f}) / "
              f"{k['plain_ms']:.4f} / "
              f"{k['bound_ms']:.4f} ({k['bound_by']}) / {k['stream_ms']:.4f} / "
              f"{lib}  launches {k['launches']}", flush=True)
    print(f"flagship wall {wall:.3f} s (DIA), {wall_aij:.3f} s (AIJ, K6), "
          f"{wall_blk:.3f} s (blocked, K5); sinvert 1.06M rows "
          f"{wall_sinv:.3f} s (GHEP), {wall_sinv_std:.3f} s (standard); plain "
          f"cycle 10.35M rows {wall_plain:.3f} s on "
          f"{smi_line}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
