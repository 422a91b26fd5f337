#!/usr/bin/env python3
"""Drive the slepc_tpu_torch port once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each failing check raises; the script then exits non-zero):
  0. device: card name, nvidia-smi name and power limit; build the CUDA
     kernels from slepc_tpu_torch/csrc and report the build time;
  1. each kernel against its plain PyTorch version on the card, at the
     flagship shapes (200x225x230 3-D Laplacian, 10.35M rows): error and
     CUDA-event times (median of 20) of kernel and plain version.  The CSR
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
     f64 against the closed form.

Phase 1 also times K5 at b = 2, 4, 8 beside b single K1/K2 calls on the
same block, and K3's three sweeps at panel width b = 4 (K = 52).

    python3 chip_smoke.py --profile

adds, after phase 6, a lane sweep of K6 (every lane count the kernel is
built for, natural and RCM order, f64 and f32, beside the DIA kernel on the
same matrix) and a torch.profiler split by kernel of one more phase-4
solve and one more phase-5 solve.  Its launches are not counted.

Launch counters are reset to 0 before phase 2 and read after phase 3 (the
DIA path), reset again before phase 4 and read after it (the AIJ path),
before phase 5 and after it (the blocked path), and before phase 6 and
after it (the small blocked and partial paths); every kernel of each path
must have launched.  The last three lines
are the kernel table as JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Needs one card; imports no JAX.
"""

import argparse
import json
import logging
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
                                    panel_update_ref)
from slepc_tpu_torch.eps.cheb_accel import ks_cheb_smallest
from slepc_tpu_torch.ops.dia import (dia_spmm, dia_spmm_ref, dia_spmv,
                                     dia_spmv_ref)
from slepc_tpu_torch.ops.rotate import rotate, rotate_ref

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
}


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


def record(table, name, err_abs, err_rel, tol, ms, plain_ms, nbytes):
    check(np.isfinite(err_rel) and err_rel <= tol,
          f"{name}: relative error {err_rel:.3e} > {tol:.0e}")
    table[name] = {"max_abs_err": err_abs, "rel_err": err_rel, "ms": ms,
                   "plain_ms": plain_ms, "bytes": nbytes}
    print(f"  {name:<22} err {err_rel:.3e} (tol {tol:.0e})  kernel {ms:.4f} ms"
          f"  plain {plain_ms:.4f} ms  {nbytes / 1e9:.3f} GB -> "
          f"{nbytes / ms / 1e6:.1f} GB/s", flush=True)


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
            y = dia_spmv(lap.offsets, diags, x)
            y_ref = dia_spmv_ref(lap.offsets, diags, x)
            err = float((y - y_ref).abs().max())
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / float(y_ref.abs().max()))
            if i == 0:  # time the flagship operator itself
                ms = cuda_ms(lambda: dia_spmv(lap.offsets, diags, x))
                plain = cuda_ms(lambda: dia_spmv_ref(lap.offsets, diags, x))
        nbytes = (len(lap.offsets) + 2) * n * x.element_size()
        record(table, name, worst_abs, worst_rel, tol, ms, plain, nbytes)
        del diags, x, y, y_ref
    del lap, rnd

    K, b = 49, 1
    for dt, tol in ((torch.float64, 1e-13), (torch.float32, 1e-5)):
        t = TAG[dt]
        V = torch.randn((K, n), generator=gen, dtype=dt, device=dev)
        W = torch.randn((b, n), generator=gen, dtype=dt, device=dev)
        C = torch.randn((K, b), generator=gen, dtype=dt, device=dev)
        elt = V.element_size()
        # error scales: the kernel and torch sum in different orders
        dscale = V.abs() @ W.abs().T
        uscale = W.abs() + C.abs().T @ V.abs()
        D = panel_dots(V, W)
        err = (D - panel_dots_ref(V, W)).abs()
        record(table, f"panel_dots_{t}", float(err.max()),
               float((err / dscale).max()), tol,
               cuda_ms(lambda: panel_dots(V, W)),
               cuda_ms(lambda: panel_dots_ref(V, W)), (K + b) * n * elt)
        U = panel_update(V, C, W)
        U_ref = panel_update_ref(V, C, W)
        err = (U - U_ref).abs()
        record(table, f"panel_update_{t}", float(err.max()),
               float((err / uscale).max()), tol,
               cuda_ms(lambda: panel_update(V, C, W)),
               cuda_ms(lambda: panel_update_ref(V, C, W)), (K + 2 * b) * n * elt)
        U2, D2 = panel_update_dots(V, C, W)
        U2_ref, D2_ref = panel_update_dots_ref(V, C, W)
        err_u = (U2 - U2_ref).abs()
        err_d = (D2 - D2_ref).abs()
        d2scale = V.abs() @ U2_ref.abs().T
        record(table, f"panel_update_dots_{t}",
               max(float(err_u.max()), float(err_d.max())),
               max(float((err_u / uscale).max()), float((err_d / d2scale).max())),
               tol, cuda_ms(lambda: panel_update_dots(V, C, W)),
               cuda_ms(lambda: panel_update_dots_ref(V, C, W)),
               (K + 2 * b) * n * elt)
        del D, U, U_ref, U2, U2_ref, D2, D2_ref, err, err_u, err_d, uscale

        Kr, P = 48, 40
        Qm, _ = np.linalg.qr(np.random.default_rng(2).standard_normal((Kr, Kr)))
        Q = torch.from_numpy(np.ascontiguousarray(Qm[:, :P])).to(dev, dt)
        Vr = V[:Kr]
        out = rotate(Q, Vr)
        err = (out - rotate_ref(Q, Vr)).abs()
        rscale = Q.abs().T @ Vr.abs()
        record(table, f"rotate_{t}", float(err.max()),
               float((err / rscale).max()), 1e-14 if dt == torch.float64 else 1e-5,
               cuda_ms(lambda: rotate(Q, Vr)), cuda_ms(lambda: rotate_ref(Q, Vr)),
               (Kr + P) * n * elt)
        del V, W, C, Vr, out, err, rscale, dscale
        torch.cuda.empty_cache()


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
                record(table, name, err, rel, tol, ms, plain, nbytes)
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
    L = stt.laplacian_3d(*FLAGSHIP).to_scipy()  # built on the host CPU
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
            del op, x, rows, y, y_ref
        record(table, name, worst_abs, worst_rel, tol, ms, plain, nbytes)
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
    del op, fast, x, y, y6
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


def profile_solve(A, where, spmv, cheb_block=1):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"profile: torch.profiler over one {where} solve", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = flagship_solve(A, f"profiled {where}", spmv,
                              cheb_block=cheb_block)[0]
    rows = sorted((e for e in prof.key_averages()
                   if e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    # device-side rows only: an aten op's row repeats its kernels' time
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and not e.key.startswith("Command Buffer Full")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  profiled wall {wall:.3f} s; device rows sum to {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}% of the wall)", flush=True)
    for e in rows[:16]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:10.1f} ms {e.count:7d} calls {ms / e.count:8.4f} ms/call "
              f"{100 * ms / (wall * 1e3):5.1f}% {e.device_type.name:<5} "
              f"{e.key[:90]}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="after phase 6: K6 lane sweep and a "
                             "torch.profiler split of a phase-4 and a "
                             "phase-5 solve")
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
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip())

    table, host = {}, {}
    phase1(dev, table)
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
    if args.profile:
        lane_sweep(dev, L_csr, A_csr)
        profile_solve(stt.from_scipy(A_csr, device=dev), "phase 4", "csr_spmv")
        profile_solve(stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64,
                                       device=dev), "phase 5", "dia_spmm",
                      cheb_block=4)
    paths = (dia_path, aij_path, blk_path, small_path)
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
                        "plain_ms": row["plain_ms"]})
    print(f"flagship wall {wall:.3f} s (DIA), {wall_aij:.3f} s (AIJ, K6), "
          f"{wall_blk:.3f} s (blocked, K5) on {smi_line}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
