#!/usr/bin/env python3
"""Drive the slepc_tpu_torch port once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each failing check raises; the script then exits non-zero):
  0. device: card name, nvidia-smi name and power limit; build the CUDA
     kernels from slepc_tpu_torch/csrc and report the build time;
  1. each kernel against its plain PyTorch version on the card, at the
     flagship shapes (200x225x230 3-D Laplacian, 10.35M rows): error and
     CUDA-event times (median of 20) of kernel and plain version;
  2. the plain Krylov-Schur cycle through EPS on laplacian_2d(95, 97),
     nev=6, ncv=28, in f64 (tol 1e-9) and f32 (tol 1e-5);
  3. the flagship through EPS: the k=20 smallest eigenpairs of the
     200x225x230 Laplacian in f64 to tol 1e-8, Chebyshev degree 450,
     ncv 48, certified against the closed-form spectrum.

Launch counters are reset before phase 2 and read after each of phases 2
and 3; every kernel of the path must have launched.  The last three lines
are the kernel table as JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Needs one card; imports no JAX.
"""

import json
import logging
import subprocess
import sys
import time

import numpy as np
import torch

import slepc_tpu_torch as stt
from slepc_tpu_torch.ops import _build
from slepc_tpu_torch.ops.bv import (panel_dots, panel_dots_ref, panel_update,
                                    panel_update_dots, panel_update_dots_ref,
                                    panel_update_ref)
from slepc_tpu_torch.ops.dia import dia_spmv, dia_spmv_ref
from slepc_tpu_torch.ops.rotate import rotate, rotate_ref

FLAGSHIP = (200, 225, 230)
TAG = {torch.float32: "f32", torch.float64: "f64"}
SRC = "slepc_tpu_torch/csrc/"
# kernel entry -> (K#, source, the Pallas kernel function it replaces)
KERNELS = {
    "dia_spmv_f32": ("K1", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:463"),
    "dia_spmv_f64": ("K2", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:720"),
    "panel_dots_f32": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:74"),
    "panel_dots_f64": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:74"),
    "panel_update_f32": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:115"),
    "panel_update_f64": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:115"),
    "panel_update_dots_f32": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:160"),
    "panel_update_dots_f64": ("K3", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:160"),
    "rotate_f32": ("K4", SRC + "rotate.cu", "slepc_tpu/ops/rotate_pallas.py:100"),
    "rotate_f64": ("K4", SRC + "rotate.cu", "slepc_tpu/ops/rotate_pallas.py:100"),
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


def family_counts(counts, tag):
    return {"K1/K2": counts[f"dia_spmv_{tag}"],
            "K3": min(counts[f"panel_dots_{tag}"], counts[f"panel_update_{tag}"],
                      counts[f"panel_update_dots_{tag}"]),
            "K4": counts[f"rotate_{tag}"]}


def phase2(dev):
    print("phase 2: plain Krylov-Schur through EPS, laplacian_2d(95, 97)",
          flush=True)
    exact = stt.laplacian_2d_eigs(95, 97, k=6)
    for dt, tol in ((torch.float64, 1e-9), (torch.float32, 1e-5)):
        before = stt.launch_counts()
        A = stt.laplacian_2d(95, 97, dtype=dt, device=dev)
        eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=6,
                      ncv=28, tol=tol, max_it=400, options=stt.Options())
        t0 = time.perf_counter()
        eps.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lam = np.sort(np.asarray(eps.eigenvalues[:6], np.float64))
        err = np.abs(lam - exact)
        counts = stt.launch_counts()
        delta = {k: counts[k] - before[k] for k in counts}
        fam = family_counts(delta, TAG[dt])
        print(f"  {TAG[dt]}: nconv={eps.nconv} its={eps.its} wall={wall:.3f} s "
              f"max|lam-exact|={err.max():.3e} rel={np.max(err / exact):.3e} "
              f"launches={fam}", flush=True)
        check(eps.nconv >= 6, f"phase 2 {TAG[dt]}: nconv {eps.nconv} < 6")
        if dt == torch.float64:
            check(err.max() <= 1e-9, f"phase 2 f64: |lam - exact| {err.max():.3e}")
        else:
            check(np.max(err / exact) <= 1e-4,
                  f"phase 2 f32: relative error {np.max(err / exact):.3e}")
        check(all(v > 0 for v in fam.values()),
              f"phase 2 {TAG[dt]}: a kernel did not launch: {fam}")


def phase3(dev):
    print("phase 3: flagship through EPS: 200x225x230 3-D Laplacian, k=20, "
          "tol 1e-8, f64, Chebyshev degree 450, ncv 48", flush=True)
    before = stt.launch_counts()
    t0 = time.perf_counter()
    A = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=20,
                  tol=1e-8, options=stt.Options.from_cli(
                      "-eps_ncv 48 -eps_cheb_degree 450"))
    eps.cheb_keep_den = 3
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
    fam = family_counts(delta, "f64")
    print(f"  operator built on the card in {build_s:.3f} s; n={A.shape[0]}",
          flush=True)
    print(f"  nconv={eps.nconv} wall={wall:.3f} s cycles={st['cycles']} "
          f"cols={st['cols']} adaptations={st['adaptations']} "
          f"certs={st['certs']} polish_rounds={st.get('polish_rounds', 0)} "
          f"cert_s={st.get('cert_s', 0.0):.3f} probe_s={st['probe_s']:.3f} "
          f"peak_mem={peak / 1e9:.2f} GB", flush=True)
    print(f"  max true rel resid={resid.max() if k else np.inf:.3e} "
          f"max|lam-exact|={eig_err.max() if k else np.inf:.3e}", flush=True)
    print(f"  launches={delta}", flush=True)
    check(eps.nconv == 20, f"phase 3: nconv {eps.nconv} != 20")
    check(resid.max() <= 1e-8, f"phase 3: true residual {resid.max():.3e}")
    check(eig_err.max() <= 1e-9, f"phase 3: |lam - exact| {eig_err.max():.3e}")
    check(all(v > 0 for v in fam.values()),
          f"phase 3: a kernel did not launch: {fam}")
    return wall


def main():
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

    table = {}
    phase1(dev, table)
    stt.reset_launch_counts()  # the comparisons above do not count
    phase2(dev)
    wall = phase3(dev)
    counts = stt.launch_counts()
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
    print(f"flagship wall {wall:.3f} s on {smi_line}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
