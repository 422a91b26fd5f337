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
     the SpMV kernels; for K3 / K4, torch.addmm(W, C.mT, V, alpha=-1) for
     the update, the fastest of a few one-call forms of the dots (each
     form's time printed), the update's call plus the dots' for
     update+dots, which no one call computes, and Q.mT @ V for the
     rotation; einsum for K7).  The CSR
     kernel K6 runs, beside its plain version and cuSPARSE, on the flagship
     built as a scipy CSR matrix and reordered with reverse Cuthill-McKee
     (an irregular pattern), on that matrix plus seeded symmetric random
     entries (rows past 32 entries), and on a seeded random graph Laplacian
     with hub rows of more than 10^5 entries; the un-permuted CSR must
     route to the DIA kernel;
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
     800 fixed CG steps per inner solve on K2, nev 10, ncv 32, the
     deployment's tol 1e-8 (each candidate confirmed on the original pencil
     by the fast path's true-residual test), through
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
     basis held here, its kept rows orthonormal to 1e-12;
 10. the non-Hermitian arm at full width: the reference's complex
     tridiagonal deployment (bench.py:1001-1077, 2^20 rows, default_rng(5))
     in real form, a DIA operator of 2,097,152 rows with offsets -3..3,
     through EPS(nhep, largest magnitude, nev 12, ncv 64) in f64 at tol
     1e-8 and f32 at tol 1e-4 (K2 / K1, K3, K4).  Gates: nconv >= 12; every
     complex value's conjugate returned (f64, 1e-10 relative); every |lam|
     above 0.75 max|d|; the true residual, recomputed with the kernel SpMV
     on Re x and Im x, <= 1e-8 (f64) / 1e-3 (f32); each f32 value within
     1e-4 relative of one of the f64 run's twelve; and the operator build,
     at 2^10 complex rows, against numpy.linalg.eigvals to 1e-9.  Before
     it, K2 and K1 on its operator, and K3 and K4 at its basis shapes, in
     f64 and f32, against their plain versions;
 11. small non-Hermitian paths, each with its gate: markov(100) on K6
     (SLEPc ex5), harmonic extraction (laplacian_2d(95, 97) against the
     closed form; the 2^12 real-form deployment's pairs), balancing on a
     badly scaled non-normal dense matrix (n = 2,000), regions (RGInterval,
     RGEllipse) and arbitrary selection on the 2^12 deployment, STFilter
     over [1.0, 1.05] on laplacian_2d(95, 97) as DIA and as RCM-ordered
     CSR, subspace (ncv 20: K5 in chunks of 8), power, arnoldi and
     lanczos (ncv 10, a dozen restarts) on a 100,000-row gapped DIA
     operator, power + shift-and-invert and lapack on small 1-D Laplacians,
     and GNHEP with a CSR A and a diagonal SPD B against scipy;
 12. the complex slice (item 11a-ii), every kernel of it complex:
     (a) the reference's non-Hermitian deployment natively complex: the
     2^20-row complex tridiagonal as a 3-diagonal complex DIA operator,
     EPS(nhep, largest magnitude, nev 6, ncv 32) in complex128 at tol 1e-8
     and complex64 at the deployment's tol 1e-4 (K2c / K1c, K3c, K4c).
     Gates: nconv >= 6; every |lam| above 0.75 max|d|; the true residual
     with the kernel SpMV <= 1e-8 (c128) / 1e-3 (c64); each c128 value
     within 1e-10 relative of one of phase 10's f64 twelve (the real form's
     spectrum is lambda(A) and its conjugates); each c64 value within 1e-4
     of the c128 run's; the same build at 2^10 rows against
     numpy.linalg.eigvals to 1e-9.  (b) complex Hermitian at full width:
     the flagship operator gauge-transformed, U L U^H with U = diag(e^{i
     phi}), phi = 2 pi u, u from default_rng(11) (L's 7 offsets, L's
     spectrum): phase 9's plain cycle in complex128 through EPS (ncv 48,
     three restarts; ms per column) and the same restarts through
     ks_hep_cycle on a basis held here, orthonormal to 1e-12; then
     laplacian_2d(95, 97) gauge-transformed certified (nev 6, ncv 28) in
     complex128 at tol 1e-8 (|lam - exact| <= 1e-9, true residual <= 1e-8)
     and complex64 at tol 1e-5, as DIA (K2c / K1c) and as RCM-ordered
     complex CSR through from_scipy (K6c).  (c) small complex paths: a
     complex shift (STSinvert, host LU, target 0.5 + 0.01i) of the real
     laplacian_2d(95, 97); complex GHEP with a diagonal SPD B (the same
     values as the real pencil's); arnoldi, power and subspace on the 2^12
     complex deployment, lanczos on the gauge-transformed 95 x 97
     Laplacian; harmonic extraction (target 2.6 + 0.8i) and a region (the
     first quadrant) on the 2^12 deployment.  Before each part, its
     kernels against their plain versions at its shapes;
 13. the preconditioned and contour-integral solvers (items 11b, 11c), f64,
     after K2, K3, K4 at the GD cycle's shapes (2^20 rows, ncv 24), K5 at
     3 and 8 rows (2^20 and 2^18) and K6 on the CSR case, each against its
     plain version: (a) the reference's GD deployment (bench.py:498-516,
     nothing cut): 2^20 rows, DIA offsets (-1, 0, 1), diagonal
     linspace(10, 30) with its first entries 1, 2, 3, off-diagonals -1;
     nev 3, ncv 24, tol 1e-6, STPrecond; the GD cycle (max_it 200) and the
     host loop (max_it 120), each solved twice and the second timed (wall,
     its, expansions, ms an expansion, peak device memory).  Gates: nconv
     >= 3, each true residual <= 1e-6 (K2), each value within 1e-10
     relative of numpy.linalg.eigvalsh of the leading 256 x 256 block, the
     two paths within 1e-10 of each other.  (b) on the same operator and
     gates: JD (STPrecond, target 0, inner maxit 24), LOBPCG's chunk (no
     preconditioner) and host loop (STPrecond), RQCG; and the GD cycle on
     laplacian_2d(95, 97) plus seeded random entries as CSR (9,215 rows,
     K6) against scipy's eigsh to 1e-9.  (c) CISS batched (``auto`` on the
     card) on the (a) construction cut to 2^18 rows for the time limit,
     RGEllipse(2, 3, 0.3), tol 1e-8, Rayleigh-Ritz and Hankel: inner
     iterations, buckets, refactored points, wall, peak memory; gates
     nconv = 3 and the values within 1e-10 (Rayleigh-Ritz) or 1e-7
     (Hankel: values of the moment pencil, first order in the residual)
     relative of the leading block's; then the factorized mode on
     laplacian_1d(100) against the closed form;
 14. the structured variants (item 11d), after every kernel of its paths
     at their shapes (K2c, K3c, K4c at 14a's; K2, K3, K4 at 14b's and K6
     on its anti-identity; K3 / K3c, K4 / K4c at test18's and the BSE
     bases', a real Q on the projected c128 basis' real view) and the
     adjoint DIA route (DIAOperator.mult_h: one K2c / K2 launch on the
     adjoint's diagonals) against the slice-update form on the 2^20
     deployment in c128 and in f64 (its real form); each part's launch
     counts are read from zero around its solves alone: (a) phase
     12a's c128 solve with set_two_sided() (2^20 rows, nev 6, ncv 32, tol
     1e-8): nconv >= 6, right residuals (K2c) and left residuals ||A^H y -
     conj(lam) y|| / (|lam| ||y||) (the adjoint route) <= 1e-8, the values
     within 1e-10 of phase 12a's, max |y_i^H x_j| / (|y_i| |x_j|) over i !=
     j <= 2 tol max|lam| / min gap, K2c launches >= 2 x the columns of a
     side, K3c and K4c launched; the build at 2^10 rows against
     scipy.linalg.eig(left=True) (values 1e-9, each left vector within sin
     1e-8); wall, restarts, columns, ms a column, the coupling's share,
     peak memory and phase 12a's wall printed.  (b) GHIEP: the reference's
     test18 pencil (dense, target 0, nev 4, ncv 20) to its published
     digits; the same pencil on laplacian_2d(95, 97) (A DIA on K2, B the
     anti-identity as CSR on K6), host-factorized STSinvert at target 0,
     nev 4, ncv 20, tol 1e-8 with the true-residual test: nconv >= 4, ||A
     x - lam B x|| / (|lam| ||x||) <= 1e-8 with the kernels, the values
     within 1e-9 of ARPACK on A^-1 B; whether the GNHEP re-solve ran; a
     2,000-row pencil with complex pairs (A tridiagonal, B = diag(-1, 1,
     ...), both DIA, largest real, nev 3, ncv 16): the GNHEP re-solve ran
     on the card and the CPU, residual <= 1e-8, values within 1e-9 of the
     CPU's and 1e-8 of ARPACK on B A.  (c)
     BSE at n = 8,192 (H 16,384 x 16,384), R and C dense on the card by
     the reference's recipe (default_rng(3)): Shao and projected (real),
     the complex definite variant (M factored on the card), nev 4, tol
     1e-9: nconv >= 4, ||H z - lam z|| / (|lam| ||z||) <= 1e-9, values
     within 1e-8 of the truth computed on the card (real: eigvalsh(L^T (R
     - C) L), R + C = L L^T; complex: the positive eigvalsh(L^H J L), M =
     L L^H), K3 / K3c and K4 / K4c launched;
 12d. (run after 12c) the complex blocked cycle (item 11a-iii), after K5c,
     K3c at panel width 4 and K4c at (4, 4) and (ncv, ncv) against their
     plain versions at its shapes: three restarts of EPS(block_size = 4,
     ncv = 48, largest_real) on the gauge-transformed 200x225x230
     Laplacian in c128 (the twin of phases 9 and 12b; it need not
     converge): ms per column, K5c / K3c / K4c launched and no single-row
     K2c, every Ritz value inside [0, 12], and the same restarts through
     ks_hep_cycle_blocked on a basis held here, its kept rows orthonormal
     to 1e-12; the gauge-transformed laplacian_2d(95, 97) with block_size
     4, ncv 28, nev 6 certified in c128 at tol 1e-9 (|lam - exact| <=
     1e-9) and c64 at tol 1e-5 (relative 1e-4); cheb_block = 4 with degree
     20 on it runs the plain cycle (the same values and restarts as
     cheb_block = 1, no Chebyshev statistics, no K5c launch); the complex
     STSinvertDevice refuses, with no launch;
 15. SVD (item 12) at full width: the discrete gradient G = [I (x) I (x)
     D_x; I (x) D_y (x) I; D_z (x) I (x) I] of phase 7's 100x102x104 grid
     (D_d the (n_d + 1) x n_d difference matrix with Dirichlet boundary
     edges, unknowns x fastest: G^T G is phase 7's 7-point Laplacian, so
     sigma = sqrt(laplacian_3d_eigs)), 3,213,608 x 1,060,800, nnz
     6,364,800, f64, built with scipy and taken through from_scipy (CSR:
     K6 for G and for its adjoint).  After K6 on G and G^H and K3 / K4 at
     the bases' shapes against their plain versions: SVD(nsv 10, ncv 32,
     tol 1e-8, largest) with trlanczos and with cross (EPS on G^T G, two
     K6 launches an apply).  Gates: nconv >= 10; the ten sigma within
     1e-9 sigma_1 of the ten largest of the closed form; compute_error <=
     1e-7 (K6); V^H V orthonormal to 1e-10, U^H U to 1e-8; K6, K3, K4
     launched.  Wall, restarts, GK steps, launches and peak memory
     printed.  Then the small paths on the card, each against numpy /
     scipy: cyclic, randomized and lapack on tests/test_modules.py's 120 x
     80 matrix, both GSVD routes (joint bidiagonalization, cross pencil)
     and the HSVD on tests/test_modules_advanced.py's pairs, the Grcar
     values to four decimals, and a c128 trlanczos on the gradient of a
     30x32x34 grid with phases on its unknowns (G U^H: the same sigma, on
     K6c); their kernels against their plain versions at their shapes
     first;
 16. matrix functions and equations (item 13), after K2 / K1 / K2c, K3 /
     K3c, K4 / K4c at MFN's shapes, K2, K3, K4, K5 at the Lyapunov
     equation's and K2 on the Sylvester operators and their adjoints'
     diagonals against their plain versions: (a) MFN y = exp(-t L) b,
     t = 1, on phase 7's 100x102x104 Laplacian (1,060,800 rows), b =
     kron(b_z, b_y, b_x) seeded, against the closed form kron(e^{-t T_z}
     b_z, e^{-t T_y} b_y, e^{-t T_x} b_x) (scipy expm on each 1-D second
     difference T_d): krylov and expokit at ncv 30, tol 1e-10, krylov at
     ncv 10 (restarted: its >= 2), f32 krylov at tol 1e-5 (K1), and c128
     exp(-t G) b for the separable gauge G = D L D^H against D e^{-t L}
     D^H b (K2c); gates: relative error <= 1e-9 (f64, c128), 1e-4 (f32);
     (b) LME: the Lyapunov equation A X + X A^T + C C^T = 0 with A =
     -(laplacian_2d(1000, 1000) + 0.1 I) (10^6 rows), C of rank 2, ncv 30,
     tol 1e-8, gate: the factored residual (one thin QR of [A Z, Z, C],
     A Z on K5) <= 1e-8; the Krylov Sylvester equation on
     tests/test_modules.py:227's tridiagonals at 2^20 and 2^20 - 4,096
     rows (DIA: K2 and its adjoint), gate: the factored residual of
     [A L, L, c1] [R, B^H R, c2]^H <= 1e-8; and the small paths at the
     reference tests' sizes (Stein, generalized Lyapunov, dense
     Sylvester, the complex Lyapunov at <= 1e-12); (c) lyapii on
     tests/test_eps_advanced.py:91's matrix and on banded DIA matrices of
     200 and 2^20 rows (K5), the rightmost value within 1e-6 of numpy's
     (the big one's from its leading 200 x 200 block);
 17. polynomial eigenproblems (item 14), after K2, K3 (with Q-Arnoldi's
     two-row panel), K4 at the damped quadratic's shapes, K3 / K4 at the
     linear solve's 180,000-row bases and K2c, K3c, K4c at the acoustic
     QEP's against their plain versions: (a) bench.py:1169-1185's damped
     quadratic (K = laplacian_2d(300, 300), C = diag(0.1 + 0.05 sin(10^-2
     i)), M = I; 90,000 rows, f64 DIA), nev 3, largest magnitude, tol
     1e-6, by toar, qarnoldi and linear (linear with target 0, the shift
     the other two take); gates: nconv >= 3, compute_error <= 1e-6 (K2),
     values within 1e-6 relative of scipy eigs(sigma=0) on the
     180,000-row companion pencil; (b) examples/ex_pep_acoustic.py's
     boundary-damped acoustic QEP at n = 2^20 in c128, toar at 0.5i, nev
     4, ncv 40, tol 1e-9; gates: nconv >= 4, compute_error <= 1e-9,
     values within 1e-9 of the port's own solve on the CPU; (c) the small
     paths at the reference tests' sizes: the four extraction kinds,
     jd, stoar, qslice, the Chebyshev basis (ComplexWarning an error),
     both refinements, diagonal scaling (CSR: K6), test1.c's digits, and
     ciss raising with no launch.  Each run prints its wall, restarts,
     TOAR steps, the P(sigma) solves' seconds (KSP_Solve_direct, with
     their KSP_HostSolve_d2h / _h2d transfers) and peak memory.

Phase 1 also times K5 at b = 1, 2, 4, 8 beside b single K1/K2 calls on the
same block and beside cuSPARSE on the (n, b) block, K3's three sweeps at
panel width b = 4 (K = 52), and K4 in place (out = V[:P]) and at (K, P) =
(48, 1) and (4, 4), and the host time of K3's and K4's launch planning
beside a whole wrapper call at the small paths' size.  The printed rows
show, in brackets, each kernel's time on the tree before the redesign of
K5 and K6 (BEFORE_MS: PERF.md's earlier reading, a constant, so not in the
JSON line, which holds only what this run measured).

    python3 chip_smoke.py --profile

adds, after phase 11, a torch.profiler split by kernel of one more phase-10
f64 solve (K2 / K3 / K4), of one more phase-9
solve (K3's measured share of the device time), of one more phase-7 GHEP solve
(the device-busy share of the launch-bound inner solve), the residual of
phase 7's inner solve after 400 and 800 CG steps with the ungated solves
at EPS tol 1e-10 (phase 7's setting before the fast path's true-residual
test), a sweep of K6's row-block budget (natural, RCM, RCM + random and
hub order, f64 and f32, beside the DIA kernel on the same matrix) and of
K5's tile (b = 1, 4, 8), the blocked f32 study (phase 6's f32 blocked solve
at tol 1e-5 with each of K5, K3, K4 in turn swapped for its plain
version), a torch.profiler split by kernel of one more phase-4 solve
and one more phase-5 solve, K4c's ring-depth sweep at (48, 40) and a
torch.profiler split of one more phase-12b c128 cycle (K3c's and K4c's
shares of its device time), of one more phase-12d c128 blocked cycle
(K5c's, K3c's, K4c's shares) and of one more phase-15 trlanczos solve
(K6's, K3's, K4's shares); after phase 13, a torch.profiler split and a
cProfile split (host seconds by function) of one more solve of each of
phase 13a's two GD paths; after phase 17, a torch.profiler split of one
more phase-17a toar solve (K2's, K3's, K4's shares).  Its launches are not
counted.

Phase 1 holds the complex instantiations too: K5c (c128, c64) at b = 4
on the gauge-transformed flagship beside the four K2c / K1c launches it
replaces and cuSPARSE's complex CSR product with the (n, 4) block; K2c /
K1c on the
gauge-transformed flagship (timed; the library call is cuSPARSE on the
same matrix as a complex torch.sparse_csr_tensor) and on the 2^20-row
complex deployment, K3c at K = 49 (in complex128 also at panel widths 2
and 4, with update+dots as its route and, where that is the fused kernel,
as the two sweeps) and K4c at (48, 40), in place too (K4c's bound counts
its operations too: 8 K P n flops), and K6c on the gauge-transformed RCM
flagship CSR (nnz 72,164,500; the complex torch.sparse_csr_tensor
product beside it, or the error torch raises).

Launch counters are reset to 0 before phase 2 and read after phase 3 (the
DIA path), reset again before phase 4 and read after it (the AIJ path),
before phase 5 and after it (the blocked path), before phase 6 and after
it (the small blocked and partial paths), before phase 7 and after
phase 8 (the shift-and-invert paths: K2, K3, K4), before phase 9 and
after it (the plain cycle at full width), before phase 10 and after it (the
non-Hermitian path: K2 / K1, K3, K4), before phase 11 and after it (its
small paths: K2, K5, K6, K3, K4), and before and after each of phase
12a, 12b and 12c (the complex paths: K2c / K1c, K6c, K3c, K4c) and of
phase 13a, 13b and 13c (K2, K3, K4, K5; K6; K5) and of phase 14a, 14b
and 14c (K2c, K3c, K4c; K2, K6, K3, K4; K3, K4, K3c, K4c), of phase 12d
(K5c, K3c, K4c; K2c) and of phase 15's full-width and small parts (K6, K3,
K4; K6c, K3c, K4c), of phase 16a, 16b and 16c (K2 / K1 / K2c, K3 /
K3c, K4 / K4c; K2, K5, K3, K4; K5, K3, K4) and of phase 17a, 17b and 17c
(K2, K3, K4; K2c, K3c, K4c; K6, K3, K4); K7's launches are read around
its yardstick measurement in phase 1.  Every kernel of each path must
have launched.  The JSON kernel table's ``launches_p13`` /
``launches_p14`` / ``launches_p12d`` / ``launches_p15`` /
``launches_p16`` / ``launches_p17`` are those phases' shares of
``launches``.  The last three lines
are the kernel table as JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Needs one card; imports no JAX.
"""

import argparse
import ctypes
import json
import logging
import re
import subprocess
import sys
import time

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

import slepc_tpu_torch as stt
from slepc_tpu_torch.ops import _build
from slepc_tpu_torch.ops.csr import (CSR_BUDGET, csr_plan, csr_spmv,
                                     csr_spmv_ref, row_of_entry)
from slepc_tpu_torch.ops.bv import (fused_update_dots, panel_dots,
                                    panel_dots_ref, panel_update,
                                    panel_update_dots, panel_update_dots_ref,
                                    panel_update_ref, plan_panel)
from slepc_tpu_torch.eps.base import op_mult_block
from slepc_tpu_torch.eps.cheb_accel import ks_cheb_smallest
from slepc_tpu_torch.eps.ks_jit import ks_hep_cycle, ks_hep_cycle_blocked
from slepc_tpu_torch.ops.dia import (SPMM_TILE, dia_spmm, dia_spmm_ref,
                                     dia_spmv, dia_spmv_ref, plan_spmm)
from slepc_tpu_torch.ops.rotate import plan_rotate, rotate, rotate_ref
from slepc_tpu_torch.ops.stream import (stream_bandwidth, stream_sum,
                                        stream_sum_ref)
from slepc_tpu_torch.native.ldl import ldl_available

FLAGSHIP = (200, 225, 230)
TAG = {torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64",
       torch.complex128: "c128"}
SRC = "slepc_tpu_torch/csrc/"
# kernel entry -> (K#, source, the Pallas kernel function it replaces)
KERNELS = {
    "dia_spmv_f32": ("K1", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:463"),
    "dia_spmv_f64": ("K2", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:720"),
    "dia_spmm_f32": ("K5", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:280"),
    "dia_spmm_f64": ("K5", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:280"),
    "dia_spmm_c64": ("K5c", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:280"),
    "dia_spmm_c128": ("K5c", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:280"),
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
    # the complex instantiations: the TPU ran complex operators through the
    # same Pallas kernels on split real planes (slepc_tpu/ops/complex_split.py)
    "dia_spmv_c64": ("K1c", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:463"),
    "dia_spmv_c128": ("K2c", SRC + "dia_spmv.cu", "slepc_tpu/ops/dia_pallas.py:720"),
    "panel_dots_c64": ("K3c", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:74"),
    "panel_dots_c128": ("K3c", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:74"),
    "panel_update_c64": ("K3c", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:115"),
    "panel_update_c128": ("K3c", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:115"),
    "panel_update_dots_c64": ("K3c", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:160"),
    "panel_update_dots_c128": ("K3c", SRC + "bv_panel.cu", "slepc_tpu/ops/bv_pallas.py:160"),
    "rotate_c64": ("K4c", SRC + "rotate.cu", "slepc_tpu/ops/rotate_pallas.py:100"),
    "rotate_c128": ("K4c", SRC + "rotate.cu", "slepc_tpu/ops/rotate_pallas.py:100"),
    "csr_spmv_c64": ("K6c", SRC + "csr_spmv.cu", "slepc_tpu/ops/ell_pallas.py:197"),
    "csr_spmv_c128": ("K6c", SRC + "csr_spmv.cu", "slepc_tpu/ops/ell_pallas.py:197"),
}
# Each kernel's time before its last redesign, same script and shapes
# (PERF.md's kernel table: the real kernels as read before the redesign of
# K5 and K6, K3c / K4c as read before theirs; NVIDIA H100 80GB HBM3, 700.00
# W), ms
BEFORE_MS = {
    "dia_spmv_f32": 0.1786, "dia_spmv_f64": 0.2782,
    "dia_spmm_f32": 0.3912, "dia_spmm_f64": 0.5675,
    "panel_dots_f32": 0.7986, "panel_dots_f64": 1.3711,
    "panel_update_f32": 0.8016, "panel_update_f64": 1.5338,
    "panel_update_dots_f32": 0.8312, "panel_update_dots_f64": 1.5186,
    "rotate_f32": 1.6316, "rotate_f64": 2.8121,
    "csr_spmv_f32": 0.7137, "csr_spmv_f64": 0.6377,
    "stream_sum_f32": 0.1428, "stream_sum_f64": 0.2646,
    "panel_dots_c64": 1.5188, "panel_dots_c128": 3.1399,
    "panel_update_c64": 1.6131, "panel_update_c128": 3.2063,
    "panel_update_dots_c64": 1.7635, "panel_update_dots_c128": 3.3712,
    "rotate_c64": 6.4573, "rotate_c128": 14.2526,
    # K5c's earlier route: a complex block as four K1c / K2c launches, one a
    # row (PERF.md: 4 x 0.3017 / 4 x 0.5507 ms)
    "dia_spmm_c64": 1.207, "dia_spmm_c128": 2.203,
}
# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM;
# 67 TFLOP/s float32 outside the tensor cores (TF32 is not float32) and 67
# TFLOP/s float64 on them (mma.sync, as K4 f64 and K4c c128 run; 34
# outside).  A
# complex kernel's real operations run at its real type's rate.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12,
              torch.complex64: 67e12, torch.complex128: 67e12}


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
        if library_ms is not None else f"  library: {library}" if library \
        else ""
    before = f" (PERF.md's earlier {BEFORE_MS[name]:.4f})" \
        if name in BEFORE_MS else ""
    print(f"  {name:<22} err {err_rel:.3e} (tol {tol:.0e})  kernel {ms:.4f} ms"
          f"{before}  plain {plain_ms:.4f} ms  bound {max(t_bytes, t_flops):.4f} ms"
          f" ({'bytes' if t_bytes >= t_flops else 'operations'})"
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
    """(max abs, max scaled by sum |products|) error of K4 (a real Q on a
    complex V: K4 on V's real view, against the product in V's dtype)."""
    err = (rotate(Q, V) - rotate_ref(Q.to(V.dtype), V)).abs()
    return float(err.max()), float((err / (Q.abs().T @ V.abs())).max())


def dots_forms(V, W):
    """One-call library forms of K3's dots D = V^H W (used nowhere in the
    port): a trailing .conj() or .mH is a view, not a kernel."""
    if not V.dtype.is_complex:
        forms = {"V @ W.mT": lambda: V @ W.mT}
        if W.shape[0] == 1:
            forms["torch.mv(V, W[0])"] = lambda: torch.mv(V, W[0])
        return forms
    forms = {"V.conj() @ W.mT": lambda: V.conj() @ W.mT,
             "(V @ W.mH).conj()": lambda: (V @ W.mH).conj(),
             "(W.conj() @ V.mT).mH": lambda: (W.conj() @ V.mT).mH}
    if W.shape[0] == 1:
        forms["torch.mv(V, W[0].conj()).conj()"] = \
            lambda: torch.mv(V, W[0].conj()).conj()
    return forms


def library_panel(V, W, C, tol):
    """The library's time for each of K3's three functions on these inputs
    (used nowhere in the port): {sweep: (ms, what)}.  The update is one
    call, torch.addmm(W, C.mT, V, alpha=-1); the dots, the fastest of the
    one-call forms of dots_forms, each held against the plain version first
    (every form's time is printed); update+dots has no single call: the
    update's call plus the fastest dots call, two calls summed."""
    D_ref = panel_dots_ref(V, W)
    scale = V.abs() @ W.abs().T
    times = {}
    for what, fn in dots_forms(V, W).items():
        got = fn().reshape(D_ref.shape)
        err = float(((got - D_ref).abs() / scale).max())
        check(err <= tol, f"library dots form {what}: error {err:.3e}")
        times[what] = cuda_ms(fn)
    best = min(times, key=times.get)
    U_ref = panel_update_ref(V, C, W)
    U = torch.addmm(W, C.mT, V, alpha=-1)
    err = float(((U - U_ref).abs() / (W.abs() + C.abs().T @ V.abs())).max())
    check(err <= tol, f"library update torch.addmm: error {err:.3e}")
    upd = cuda_ms(lambda: torch.addmm(W, C.mT, V, alpha=-1))
    print("  library dots forms (ms): " + ", ".join(
        f"{w} {t:.4f}" for w, t in times.items()), flush=True)
    return {"panel_dots": (times[best], best),
            "panel_update": (upd, "torch.addmm(W, C.mT, V, alpha=-1)"),
            "panel_update_dots": (
                upd + times[best],
                f"torch.addmm + {best}: two calls, their times summed")}


def library_rotate(Q, V):
    """The library's time for K4's function, one call Q.mT @ V (used
    nowhere in the port): (ms, what)."""
    return cuda_ms(lambda: Q.mT @ V), "Q.mT @ V"


def random_q(K, P, dev, dtype, seed=2):
    """P orthonormal columns of length K (a restart's rotation; complex
    unitary columns for a complex dtype)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((K, K))
    if dtype.is_complex:
        M = M + 1j * rng.standard_normal((K, K))
    Qm, _ = np.linalg.qr(M)
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
        lib = library_panel(V, W, C, tol)
        record(table, f"panel_dots_{t}", *errs["panel_dots"], tol,
               cuda_ms(lambda: panel_dots(V, W)),
               cuda_ms(lambda: panel_dots_ref(V, W)),
               (K + b) * n * elt, 2 * K * b * n, dt, *lib["panel_dots"])
        record(table, f"panel_update_{t}", *errs["panel_update"], tol,
               cuda_ms(lambda: panel_update(V, C, W)),
               cuda_ms(lambda: panel_update_ref(V, C, W)),
               (K + 2 * b) * n * elt, 2 * K * b * n, dt, *lib["panel_update"])
        record(table, f"panel_update_dots_{t}", *errs["panel_update_dots"],
               tol, cuda_ms(lambda: panel_update_dots(V, C, W)),
               cuda_ms(lambda: panel_update_dots_ref(V, C, W)),
               (K + 2 * b) * n * elt, 4 * K * b * n, dt,
               *lib["panel_update_dots"])

        Kr, P = 48, 40
        Q = random_q(Kr, P, dev, dt)
        Vr = V[:Kr]
        record(table, f"rotate_{t}", *rotate_errors(Q, Vr),
               1e-14 if dt == torch.float64 else 1e-5,
               cuda_ms(lambda: rotate(Q, Vr)),
               cuda_ms(lambda: rotate_ref(Q, Vr)),
               (Kr + P) * n * elt, 2 * Kr * P * n, dt, *library_rotate(Q, Vr))
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
    """K5 at b = 1, 2, 4, 8 against its plain version and b K1/K2 calls;
    returns its times {(dtype, b): ms} (cuSPARSE beside them: phase1_csr)."""
    print("phase 1: K5 (block DIA SpMM) vs plain PyTorch on the flagship "
          "operator, beside b single K1/K2 calls; K3 at b = 4", flush=True)
    gen = torch.Generator(device=dev).manual_seed(6)
    lap = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    n, nd = lap.shape[0], len(lap.offsets)
    k5_ms = {}
    for dt, tol in ((torch.float64, 1e-13), (torch.float32, 1e-6)):
        diags = lap.diags.to(dt)
        # X is a slice of a taller basis, as the blocked cycle hands it over
        V = torch.randn((12, n), generator=gen, dtype=dt, device=dev)
        plan = plan_spmm(lap.offsets, n, 4, dt)
        print(f"  {TAG[dt]}: tile {plan.tile}, halo {plan.halo}, diagonals "
              f"(d direct, n near) {''.join('dn'[w] for w in plan.where)}, "
              f"{plan.smem} bytes staged a block at b = 4", flush=True)
        for b in (1, 2, 4, 8):
            X = V[3:3 + b]
            Y = dia_spmm(lap.offsets, diags, X)
            Y_ref = dia_spmm_ref(lap.offsets, diags, X)
            err = float((Y - Y_ref).abs().max())
            rel = err / float(Y_ref.abs().max())
            ms = cuda_ms(lambda: dia_spmm(lap.offsets, diags, X))
            k5_ms[(dt, b)] = ms
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
    return k5_ms


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


def hub_graph_laplacian(n=2_097_152, degree=4, hubs=4, hub_edges=150_000,
                        seed=11):
    """Seeded random graph Laplacian L = D - W (the irregular, power-user
    case of an AIJ matrix): ``degree`` uniform random edges per node, plus
    ``hubs`` nodes joined to ``hub_edges`` random nodes each, so a few rows
    hold more than 10^5 entries; unit weights, summed duplicates."""
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(n), degree)
    j = rng.integers(0, n, i.size)
    hub = rng.choice(n, hubs, replace=False)
    i = np.concatenate([i, np.repeat(hub, hub_edges)])
    j = np.concatenate([j, rng.integers(0, n, hubs * hub_edges)])
    keep = i != j
    W = sp.csr_matrix((np.ones(int(keep.sum())), (i[keep], j[keep])),
                      shape=(n, n))
    W = (W + W.T).tocsr()
    return (sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W).tocsr()


def pattern(op):
    """(bandwidth, distinct diagonal offsets, longest row) of a CSR operator."""
    off = op.cols.to(torch.int64) - row_of_entry(op.rowptr)
    return (int(off.abs().max()), int(torch.unique(off).numel()),
            int(op.rowptr.diff().max()))


def phase1_csr(dev, table, host, k5_ms):
    print("phase 1: K6 (CSR SpMV) vs plain PyTorch and cuSPARSE on the "
          "RCM-ordered flagship CSR, on it plus random entries and on a hub "
          "graph Laplacian", flush=True)
    t0 = time.perf_counter()
    L = stt.laplacian_3d(*FLAGSHIP, device="cpu").to_scipy()  # on the host
    host["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = rcm_order(L)
    host["rcm_s"] = time.perf_counter() - t0
    print(f"  host CSR: build {host['build_s']:.3f} s, RCM + permutation "
          f"{host['rcm_s']:.3f} s; n={A.shape[0]} nnz={A.nnz}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    t0 = time.perf_counter()
    ops = {"rcm": A, "rcm+random": with_random_entries(A),
           "hub": hub_graph_laplacian()}
    print(f"  host: random entries and the hub graph built in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for dt, tol in ((torch.float64, 1e-13), (torch.float32, 2e-6)):
        name = f"csr_spmv_{TAG[dt]}"
        worst_abs = worst_rel = 0.0
        for label, M in ops.items():
            op = stt.from_scipy(M, dtype=dt, device=dev)
            if dt == torch.float64:
                bw, noff, longest = pattern(op)
                print(f"  {label}: n={op.shape[0]} nnz={op.nnz} "
                      f"bandwidth={bw} distinct offsets={noff} "
                      f"longest row={longest} row blocks="
                      f"{op.row_plan().nblocks} (budget "
                      f"{op.row_plan().budget})",
                      flush=True)
            x = torch.randn(op.shape[1], generator=gen, dtype=dt, device=dev)
            rows = row_of_entry(op.rowptr)
            y = op.mult(x)
            y_ref = csr_spmv_ref(op.rowptr, op.cols, op.vals, x, rows)
            # the plain version's own f32 sums (index_add_'s atomics, in no
            # fixed order) are off by up to 6e-6 on a hub row of 1.5e5
            # entries: the f32 kernel is held against the plain version on
            # the same inputs in f64
            y_ref64 = y_ref if dt == torch.float64 else csr_spmv_ref(
                op.rowptr, op.cols, op.vals.double(), x.double(), rows)
            err = float((y.double() - y_ref64).abs().max())
            err_plain = float((y - y_ref).abs().max() / y_ref.abs().max())
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / float(y_ref64.abs().max()))
            ms = cuda_ms(lambda: op.mult(x))
            plain = cuda_ms(lambda: csr_spmv_ref(op.rowptr, op.cols,
                                                 op.vals, x, rows))
            lib_ms = cusparse_ms(op, x)
            elt = x.element_size()
            # the bound counts rowptr, cols, vals and x once, y once
            nbytes = (op.nnz * (elt + 4) + (op.shape[0] + 1) * 8
                      + 2 * op.shape[0] * elt)
            print(f"  {label} {TAG[dt]}: err {err / float(y_ref64.abs().max()):.3e}"
                  f" (against the {TAG[dt]} plain version {err_plain:.3e})"
                  f"  kernel {ms:.4f} ms  plain {plain:.4f} ms  cuSPARSE "
                  f"{lib_ms:.4f} ms  bound {nbytes / PEAK_BYTES * 1e3:.4f} ms"
                  f"  {nbytes / ms / 1e6:.1f} GB/s", flush=True)
            if label == "rcm":  # the flagship operator goes into the table
                row = (ms, plain, nbytes, lib_ms, 2 * op.nnz)
            del op, x, rows, y, y_ref, y_ref64
            torch.cuda.empty_cache()
        ms, plain, nbytes, lib_ms, flops = row
        record(table, name, worst_abs, worst_rel, tol, ms, plain, nbytes,
               flops, dt, lib_ms, CUSPARSE)
    ops.pop("rcm")
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
    print("phase 1: the library call beside K1/K2 and K5 (b = 1, 2, 4, 8): "
          "cuSPARSE on the same matrix as a torch.sparse_csr_tensor",
          flush=True)
    n = op.shape[0]
    del op
    for dt in (torch.float64, torch.float32):
        op = stt.from_scipy(L, dtype=dt, device=dev)
        x = torch.randn(n, generator=gen, dtype=torch.float64,
                        device=dev).to(dt)
        name = f"dia_spmv_{TAG[dt]}"
        table[name]["library_ms"] = cusparse_ms(op, x)
        table[name]["library"] = CUSPARSE
        print(f"  {name}: library {table[name]['library_ms']:.4f} ms "
              f"(kernel {table[name]['ms']:.4f} ms)", flush=True)
        for b in (1, 2, 4, 8):
            X = torch.randn((n, b), generator=gen, dtype=torch.float64,
                            device=dev).to(dt)
            lib = cusparse_ms(op, X)
            name = f"dia_spmm_{TAG[dt]}"
            if b == 4:
                table[name]["library_ms"] = lib
                table[name]["library"] = CUSPARSE
            print(f"  {name} b={b}: library {lib:.4f} ms (kernel "
                  f"{k5_ms[(dt, b)]:.4f} ms)", flush=True)
            del X
        del op, x
        torch.cuda.empty_cache()
    return L, A, ops


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
    # several hundred restarts here where the plain one needs ~56.  The f32
    # solve runs at phase 2's tol 1e-5: with K3's update subtracting the
    # summed projection once, its estimates reach the tol in ~400 restarts
    # (blocked_f32_study, under --profile, swaps each kernel for its plain
    # version)
    small_solves(dev, "phase 6 blocked",
                 (("DIA", "dia_spmm"), ("CSR", "csr_spmv")),
                 setup=lambda eps: setattr(eps, "block_size", 4), max_it=3000)
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
# times larger.  The fast path confirms each candidate on the original
# pencil before it counts (eps/ks_jit.py _true_residual_confirm), so the
# solve runs at the deployment's tol 1e-8 and the gate on the true residual
# is that same 1e-8 (without the test the solve stopped at 4.1e-7).
SINVERT_TOL = 1e-8


PATH_TOL = {torch.float64: {"K2": 1e-14, "K3": 1e-13, "K4": 1e-14},
            torch.float32: {"K1": 2e-6, "K3": 1e-5, "K4": 1e-5},
            torch.complex128: {"K2c": 1e-14, "K3c": 1e-13, "K4c": 1e-14},
            torch.complex64: {"K1c": 2e-6, "K3c": 1e-5, "K4c": 1e-5}}


def path_kernels(dev, title, cases, dtype=torch.float64):
    """K2 (K1 in f32), K3 and K4 against their plain versions at the shapes
    a path gives them (phase 1's tolerances, ``PATH_TOL``): the SpMV on
    each case's operator (made in ``dtype``), and K3 and K4 as
    ``basis_errors`` runs them.  ``cases``: (where, operator maker, ncv).
    Run before the paths' launch counts are reset: these launches are not
    theirs."""
    print(title, flush=True)
    tol = PATH_TOL[dtype]
    spmv, k3, k4 = tol
    gen = torch.Generator(device=dev).manual_seed(8)
    for where, make, ncv in cases:
        A = make()
        check(A.diags.dtype == dtype, f"{where}: operator in {A.diags.dtype}")
        n = A.shape[0]
        x = torch.randn(n, generator=gen, dtype=dtype, device=dev)
        worst = {spmv: spmv_errors(A.offsets, A.diags, x)[1]}
        worst[k3], worst[k4] = basis_errors(dev, gen, x, ncv)
        print(f"  {where}: n={n} nd={len(A.offsets)} ncv={ncv} "
              f"{TAG[dtype]}  "
              + "  ".join(f"{k} {v:.3e}" for k, v in worst.items()),
              flush=True)
        for k, v in worst.items():
            check(v <= tol[k], f"{where}: {k} error {v:.3e} > {tol[k]:g}")
        del A, x
    torch.cuda.empty_cache()


def basis_errors(dev, gen, x, ncv, q_dtype=None):
    """Worst scaled errors (K3, K4) against the plain versions on a random
    basis of ncv + 1 rows of x's length and dtype: K3's three sweeps
    against 1, ncv and ncv + 1 rows (the first column, the last, and the
    basis with its residual row), K4 at (ncv, ncv) (the fast path's
    restart), (ncv, ncv // 2) (the general loop keeps half) and (ncv, 1)
    (one Ritz vector), with Q in ``q_dtype`` (x's by default; a real Q on a
    complex basis is K4 on the basis' real view)."""
    n, dtype = x.shape[0], x.dtype
    V = torch.randn((ncv + 1, n), generator=gen, dtype=dtype, device=dev)
    C = torch.randn((ncv + 1, 1), generator=gen, dtype=dtype, device=dev)
    k3 = k4 = 0.0
    for K in (1, ncv, ncv + 1):
        errs = panel_errors(V[:K], x[None], C[:K])
        k3 = max(k3, *(rel for _, rel in errs.values()))
    for P in (ncv, ncv // 2, 1):
        k4 = max(k4, rotate_errors(random_q(ncv, P, dev, q_dtype or dtype),
                                   V[:ncv])[1])
    return k3, k4


def basis_kernels(dev, title, cases):
    """K3 and K4 against their plain versions (``basis_errors``) at the
    shapes of paths whose operators are dense, so have no SpMV kernel.
    ``cases``: (where, rows, ncv, basis dtype, Q dtype).  Run before the
    paths' launch counts are reset."""
    print(title, flush=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    for where, n, ncv, dtype, q_dtype in cases:
        x = torch.randn(n, generator=gen, dtype=dtype, device=dev)
        _, k3, k4 = PATH_TOL[dtype]
        if q_dtype != dtype:
            k4 = "K4"  # the real view
        tol = {k3: PATH_TOL[dtype][k3], k4: PATH_TOL[q_dtype][k4]}
        worst = dict(zip(tol, basis_errors(dev, gen, x, ncv, q_dtype)))
        print(f"  {where}: n={n} ncv={ncv} basis {TAG[dtype]} Q "
              f"{TAG[q_dtype]}  "
              + "  ".join(f"{k} {v:.3e}" for k, v in worst.items()),
              flush=True)
        for k, v in worst.items():
            check(v <= tol[k], f"{where}: {k} error {v:.3e} > {tol[k]:g}")
    torch.cuda.empty_cache()


def sinvert_kernels(dev):
    """K2, K3, K4 at the shapes phases 7 and 8 give them."""
    f64 = torch.float64
    path_kernels(dev, "phases 7-8: K2, K3, K4 vs plain PyTorch at the "
                 "shift-and-invert paths' shapes", (
                     ("phase 7, 100x102x104", lambda: stt.laplacian_3d(
                         *SINVERT_GRID, dtype=f64, device=dev), 32),
                     ("phase 8 MINRES, 8x9x10", lambda: stt.laplacian_3d(
                         8, 9, 10, dtype=f64, device=dev), 20),
                     ("phase 8 general loop, 95x97", lambda: stt.laplacian_2d(
                         95, 97, dtype=f64, device=dev), 21),
                     ("phase 8 slicing, 95x97", lambda: stt.laplacian_2d(
                         95, 97, dtype=f64, device=dev), 64),
                     ("phase 8 slicing, 1-D 1,000,000", lambda: stt.laplacian_1d(
                         1_000_000, dtype=f64, device=dev), 64)))


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
    after 400 and 800 steps, and the ungated solves at tol 1e-10 (phase
    7's setting before the fast path's true-residual test) beside phase
    7's."""
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
        sinvert_solve(dev, f"tol 1e-10 {'GHEP' if generalized else 'standard'}",
                      generalized, tol=1e-10, gate=False)


def phase7(dev):
    print("phase 7: the shift-and-invert slice at full size: 100x102x104 "
          "Laplacian (1,060,800 rows), f64, sigma = 0, CG iters = 800, "
          f"nev 10, ncv 32, tol {SINVERT_TOL:g} (candidates confirmed on the "
          "original pencil), gate 1e-8 on the true residual", flush=True)
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


def plain_solve(A, ncv, restarts, cycles=None, block_size=1):
    """The plain EPS(krylovschur, hep) solve of phase 9, stopped after
    ``restarts`` restarts (phase 12d: the blocked cycle, ``block_size``).
    ``cycles`` collects, at each restart, (converged count, Ritz values,
    host clock, launch counts).  Returns (eps, wall)."""
    eps = stt.EPS(A, problem_type="hep", which="largest_real", nev=4,
                  ncv=ncv, tol=1e-8, max_it=restarts, options=stt.Options())
    eps.block_size = block_size
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


NHEP_LOG2 = 20  # complex rows of the non-Hermitian deployment
NHEP_NEV, NHEP_NCV = 12, 64


def spiral_diags(n):
    """The reference's non-Hermitian deployment (bench.py:1001-1077), a
    complex tridiagonal of n rows from default_rng(5): the diagonal spiral
    r e^{i theta} with eight detached top-magnitude outliers at 3.0 -> 2.4,
    complex off-diagonals 0.05 N(0,1), lo = 0.3 hi.  Returns the (3, n)
    complex diagonals (offsets -1, 0, 1), rounded to complex64 as the
    deployment builds them."""
    rng = np.random.default_rng(5)
    th = np.linspace(0, 4 * np.pi, n)
    r = np.linspace(0.5, 2.0, n)
    d = (r * np.exp(1j * th)).astype(np.complex64)
    d[:8] = (np.linspace(3.0, 2.4, 8)
             * np.exp(1j * np.linspace(0.3, 5.5, 8))).astype(np.complex64)
    off = 0.05 * (rng.standard_normal(n)
                  + 1j * rng.standard_normal(n)).astype(np.complex64)
    lo = np.zeros(n, np.complex64)
    hi = np.zeros(n, np.complex64)
    hi[: n - 1] = off[: n - 1]
    lo[1:] = off[: n - 1] * 0.3
    return np.stack([lo, d, hi]).astype(np.complex128)


def spiral_operator(log2n, dtype, dev):
    """The deployment in real form: 2 * 2^log2n rows, offsets -3..3."""
    return stt.from_complex_dia((-1, 0, 1), spiral_diags(1 << log2n),
                                dtype=dtype, device=dev)


def nhep_solve(A, tol, nev=NHEP_NEV, ncv=NHEP_NCV, setup=None, **kw):
    """EPS(A, nhep, largest magnitude) on the card; returns (eps, wall,
    launch deltas), the deltas read before any residual is recomputed."""
    before = stt.launch_counts()
    eps = stt.EPS(A, problem_type="nhep", nev=nev, ncv=ncv, tol=tol,
                  options=stt.Options(), **kw)
    if setup is not None:
        setup(eps)
    t0 = time.perf_counter()
    eps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = stt.launch_counts()
    return eps, wall, {k: counts[k] - before[k] for k in counts}


def pair_gates(where, eps, rel):
    """Every returned value with Im != 0 has its conjugate among the
    returned values, to ``rel`` relative."""
    lam = np.asarray(eps.eigenvalues[:eps.nconv])
    for v in lam:
        if v.imag != 0:
            gap = np.min(np.abs(lam - np.conj(v))) / abs(v)
            check(gap <= rel, f"{where}: {v} has no conjugate ({gap:.3e})")


def nhep_kernels(dev):
    """The kernels of phase 10's two solves at their shapes: K2 (f64) and
    K1 (f32) on the 2,097,152-row operator with offsets -3..3, K3 on a
    basis of 1, 64 and 65 rows, K4 with Q (64, kl), in f64 and in f32."""
    for dt in (torch.float64, torch.float32):
        path_kernels(dev, f"phase 10: {', '.join(PATH_TOL[dt])} "
                     f"({TAG[dt]}) vs plain PyTorch at the non-Hermitian "
                     f"path's shapes", (
                         ("phase 10, 2^20 complex rows in real form",
                          lambda: spiral_operator(NHEP_LOG2, dt, dev),
                          NHEP_NCV),), dtype=dt)


def phase10(dev):
    """The non-Hermitian arm at full width: the reference's complex
    deployment (2^20 rows) in real form, 2,097,152 rows, twelve eigenvalues
    in six conjugate pairs, f64 at tol 1e-8 and f32 at tol 1e-4.  Returns
    ({dtype tag: (wall, restarts, columns)}, the f64 run's twelve values)."""
    n_c = 1 << NHEP_LOG2
    print(f"phase 10: non-Hermitian Krylov-Schur at full width: the "
          f"{n_c:,}-row complex tridiagonal deployment in real form "
          f"({2 * n_c:,} rows, offsets -3..3), nev {NHEP_NEV} (six conjugate "
          f"pairs), ncv {NHEP_NCV}, largest magnitude", flush=True)
    # the operator build, at a size the host solves densely
    small = spiral_diags(1 << 10)
    Ac = sp.diags([small[0, 1:], small[1], small[2, :-1]], [-1, 0, 1])
    w = np.linalg.eigvals(Ac.toarray())
    top = w[np.argsort(-np.abs(w))][:NHEP_NEV // 2]
    want = np.sort_complex(np.concatenate([top, top.conj()]))
    eps, wall, _ = nhep_solve(spiral_operator(10, torch.float64, dev), 1e-8)
    check(eps.nconv >= NHEP_NEV, f"phase 10 2^10: nconv {eps.nconv}")
    got = np.sort_complex(np.asarray(eps.eigenvalues[:NHEP_NEV]))
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"  build check, 2^10 complex rows: nconv={eps.nconv} its={eps.its} "
          f"wall={wall:.3f} s, max rel |lam - eigvals| = {rel:.3e}",
          flush=True)
    check(rel <= 1e-9, f"phase 10 2^10: eigenvalues off by {rel:.3e}")
    dmax = float(np.abs(spiral_diags(1 << 4)[1]).max())  # the outliers
    out = {}
    for dt, tol, gate in ((torch.float64, 1e-8, 1e-8),
                          (torch.float32, 1e-4, 1e-3)):
        t = TAG[dt]
        where = f"phase 10 {t} (tol {tol:.0e})"
        t0 = time.perf_counter()
        A = spiral_operator(NHEP_LOG2, dt, dev)
        torch.cuda.synchronize()
        build = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        eps, wall, delta = nhep_solve(A, tol)
        peak = torch.cuda.max_memory_allocated(dev)
        fam = family_counts(delta, t)
        cols = fam["SpMV"]
        k = eps.nconv
        lam = np.asarray(eps.eigenvalues[:k])
        # true residuals with the kernel SpMV on Re x and Im x
        resid = np.array([eps.compute_error(i) for i in range(k)])
        print(f"  {where}: operator {build:.3f} s; nconv={k} restarts="
              f"{eps.its} columns={cols} wall={wall:.3f} s "
              f"({wall / max(cols, 1) * 1e3:.3f} ms per column) launches="
              f"{fam} peak_mem={peak / 1e9:.2f} GB", flush=True)
        print(f"  {where}: max true rel resid={resid.max() if k else np.inf:.3e}"
              f" min|lam|={np.abs(lam).min() if k else 0:.6f} "
              f"lam={np.array2string(lam[:NHEP_NEV], precision=6)}",
              flush=True)
        check(k >= NHEP_NEV, f"{where}: nconv {k} < {NHEP_NEV}")
        if dt == torch.float64:
            pair_gates(where, eps, 1e-10)
        check(np.all(np.abs(lam) > 0.75 * dmax),
              f"{where}: a value below the top band: {np.abs(lam).min()}")
        check(resid.max() <= gate, f"{where}: true residual {resid.max():.3e}")
        if dt == torch.float64:
            lam64 = lam[:NHEP_NEV]
        else:
            # the f32 operator is the f64 one exactly (complex64 entries):
            # its twelve values are the f64 run's, to the f32 tolerance
            far = max(float(np.min(np.abs(lam64 - v))) / abs(v)
                      for v in lam[:NHEP_NEV])
            print(f"  {where}: max rel distance to the f64 values "
                  f"{far:.3e}", flush=True)
            check(far <= 1e-4, f"{where}: a value {far:.3e} from the f64 "
                  f"run's")
        check(all(v > 0 for v in fam.values()),
              f"{where}: a kernel did not launch: {fam}")
        out[t] = (wall, eps.its, cols)
        del eps, A
        torch.cuda.empty_cache()
    return out, lam64


def phase11(dev):
    """Small paths of the non-Hermitian slice on the card, each with its
    own gate."""
    f64 = torch.float64
    print("phase 11: small non-Hermitian paths: Markov (K6), harmonic, "
          "balancing, regions, arbitrary selection, STFilter, the other "
          "solvers, GNHEP", flush=True)
    # Markov chain (SLEPc ex5) on the CSR kernel
    t0 = time.perf_counter()
    A = stt.markov(MARKOV_M, device=dev)
    eps, wall, delta = nhep_solve(A, 1e-9, nev=4, ncv=None, max_it=300)
    resid = max(eps.compute_error(i) for i in range(4))
    top = float(np.max(np.abs(eps.eigenvalues[:4])))
    print(f"  markov({MARKOV_M}) ({A.shape[0]} rows, CSR): nconv={eps.nconv} "
          f"its={eps.its} wall={wall:.3f} s |max|lam| - 1|={abs(top - 1):.3e} "
          f"max true rel resid={resid:.3e} K6={delta['csr_spmv_f64']}",
          flush=True)
    check(eps.nconv >= 4 and abs(top - 1) <= 1e-8 and resid <= 1e-8,
          "markov: gates")
    check(delta["csr_spmv_f64"] > 0, "markov: K6 did not launch")

    # harmonic extraction: HEP on the Schur machinery, closed form
    A = stt.laplacian_2d(95, 97, dtype=f64, device=dev)
    t0 = time.perf_counter()
    eps = stt.EPS(A, problem_type="hep", nev=4, ncv=28, tol=1e-9,
                  max_it=2000, options=stt.Options())
    eps.set_target(0.0)
    eps.set_st(stt.STShift([A]))
    eps.set_which("target_magnitude")
    eps.set_extraction("harmonic")
    eps.solve()
    report("harmonic HEP, target 0, laplacian_2d(95, 97)", eps,
           stt.laplacian_2d_eigs(95, 97, k=4), t0, 1e-9)

    # the phase-10 operator at 2^12 complex rows: plain, then harmonic,
    # regions and arbitrary selection against its values
    A = spiral_operator(12, f64, dev)
    ref, _, _ = nhep_solve(A, 1e-10)
    lam_ref = np.asarray(ref.eigenvalues[:ref.nconv])

    def held(where, eps, count, inside=None):
        k = eps.nconv
        lam = np.asarray(eps.eigenvalues[:k])
        resid = max(eps.compute_error(i) for i in range(k)) if k else np.inf
        dist = max(np.min(np.abs(lam_ref - v)) for v in lam) if k else np.inf
        print(f"  {where}: nconv={k} its={eps.its} "
              f"max true rel resid={resid:.3e} max|lam - plain|={dist:.3e} "
              f"lam={np.array2string(lam, precision=6)}", flush=True)
        check(k >= count, f"{where}: nconv {k} < {count}")
        check(resid <= 1e-8 and dist <= 1e-9, f"{where}: gates")
        pair_gates(where, eps, 1e-10)
        if inside is not None:
            check(np.all(inside.check_inside(lam) >= 0),
                  f"{where}: a value outside the region")

    def harmonic(eps):
        eps.set_target(3.1)
        eps.set_st(stt.STShift([eps.A]))
        eps.set_which("target_magnitude")
        eps.set_extraction("harmonic")

    eps, _, _ = nhep_solve(A, 1e-9, nev=2, ncv=32, setup=harmonic)
    held("harmonic NHEP pairs, target 3.1, 2^12 spiral", eps, 2)
    check(np.min(np.abs(eps.eigenvalues[:2] - lam_ref[0])) < 1e-9,
          "harmonic NHEP: not the pair nearest 3.1")
    for rg, nev in ((stt.RGInterval(1.0, np.inf, -np.inf, np.inf), 4),
                    (stt.RGEllipse(center=2.0, radius=1.5), 2)):
        eps, _, _ = nhep_solve(A, 1e-9, nev=nev, ncv=32,
                               setup=lambda e: e.set_rg(rg))
        held(f"region {type(rg).__name__}, 2^12 spiral", eps, nev, rg)

    def by_real_part(eps):
        eps.set_arbitrary_selection(lambda lam, x: -abs(complex(lam).real))

    eps, _, _ = nhep_solve(A, 1e-9, nev=4, ncv=32, setup=by_real_part)
    held("arbitrary selection (largest |Re|), 2^12 spiral", eps, 4)
    # the returned pairs hold the four of largest |Re| (EPS.solve orders
    # what it returns by the sort criterion, largest magnitude)
    want = lam_ref[np.argsort(-np.abs(lam_ref.real), kind="stable")][:4]
    got = np.asarray(eps.eigenvalues[:eps.nconv])
    check(all(np.min(np.abs(got - v)) <= 1e-9 for v in want),
          "arbitrary selection: not the largest |Re|")
    del A, ref

    # balancing on a badly scaled non-normal matrix
    # (tests/test_eps_advanced.py:161-177 at n = 2,000)
    rng = np.random.default_rng(0)
    n = 2000
    D = 10.0 ** rng.uniform(-3, 3, n)
    M0 = rng.standard_normal((n, n)) / np.sqrt(n)
    w_ref = np.linalg.eigvals(M0)
    A = stt.DenseOperator((M0 / D[:, None]) * D[None, :], device=dev)
    t0 = time.perf_counter()
    eps, wall, _ = nhep_solve(A, 1e-8, nev=3, ncv=40, max_it=2000,
                              setup=lambda e: e.set_balance())
    lam = np.asarray(eps.eigenvalues[:3])
    err = max(np.min(np.abs(w_ref - v)) for v in lam)
    resid = max(eps.compute_error(i) for i in range(3))
    print(f"  balanced NHEP, n={n}: nconv={eps.nconv} its={eps.its} "
          f"wall={wall:.3f} s max|lam - eigvals(M0)|={err:.3e} "
          f"max true rel resid={resid:.3e}", flush=True)
    check(eps.nconv >= 3 and err <= 1e-7 and resid <= 1e-6,
          "balancing: gates")
    del A

    # STFilter over an interior interval, as DIA and as RCM-ordered CSR
    exact = stt.laplacian_2d_eigs(95, 97)
    a, b = FILTER_INTERVAL
    inside = exact[(exact > a) & (exact < b)]
    csr = rcm_order(stt.laplacian_2d(95, 97, device=dev).to_scipy())
    for kind, spmv in (("DIA", "dia_spmv_f64"), ("CSR", "csr_spmv_f64")):
        A = (stt.laplacian_2d(95, 97, dtype=f64, device=dev) if kind == "DIA"
             else stt.from_scipy(csr, device=dev))
        before = stt.launch_counts()
        t0 = time.perf_counter()
        eps = stt.EPS(A, problem_type="hep", which="largest_real",
                      nev=len(inside), ncv=2 * len(inside) + 10, tol=1e-8,
                      options=stt.Options())
        eps.set_st(stt.STFilter([A], interval=(a, b), degree=FILTER_DEGREE,
                                spectral_range=(0.0, 8.0)))
        eps.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k = eps.nconv
        got = np.sort(np.asarray(eps.eigenvalues[:k], np.float64))
        err = max(np.min(np.abs(exact - v)) for v in got) if k else np.inf
        resid = max(eps.compute_error(i) for i in range(k)) if k else np.inf
        n_spmv = stt.launch_counts()[spmv] - before[spmv]
        print(f"  STFilter [{a}, {b}] degree {FILTER_DEGREE} {kind}: "
              f"nconv={k} of {len(inside)} inside its={eps.its} "
              f"wall={wall:.3f} s max|lam - exact|={err:.3e} "
              f"max true rel resid={resid:.3e} SpMV launches={n_spmv}",
              flush=True)
        check(k == len(inside) and err <= 1e-9 and resid <= 1e-6
              and np.all((got > a) & (got < b)), f"STFilter {kind}: gates")
        check(n_spmv > 0, f"STFilter {kind}: the SpMV kernel did not launch")
        del A

    # the other solvers on the reference's test problems, scaled up
    solvers_small(dev)

    # GNHEP: a nonsymmetric CSR A with an SPD diagonal B
    n = 2000
    rng = np.random.default_rng(4)
    As = (sp.diags(3.0 * 0.9 ** np.arange(n))
          + 0.01 * sp.random(n, n, density=2e-3, random_state=rng)).tocsr()
    bd = 1.0 + 0.5 * np.sin(np.arange(n))
    import scipy.linalg as sla
    w = sla.eigvals(As.toarray(), np.diag(bd))
    w = w[np.argsort(-np.abs(w))]
    A = stt.from_scipy(As, device=dev)
    B = stt.DIAOperator((0,), torch.from_numpy(bd[None, :]).to(dev))
    before = stt.launch_counts()
    t0 = time.perf_counter()
    eps = stt.EPS(A, B, problem_type="gnhep", nev=4, tol=1e-10,
                  options=stt.Options())
    eps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k6 = stt.launch_counts()["csr_spmv_f64"] - before["csr_spmv_f64"]
    got = np.asarray(eps.eigenvalues[:4])
    err = max(np.min(np.abs(w - v)) / abs(v) for v in got)
    resid = max(eps.compute_error(i) for i in range(4))
    print(f"  GNHEP n={n} (CSR A, diagonal B): nconv={eps.nconv} its={eps.its}"
          f" wall={wall:.3f} s max rel|lam - scipy eigvals|={err:.3e} "
          f"max true rel resid={resid:.3e} K6={k6}", flush=True)
    check(eps.nconv >= 4 and err <= 1e-9 and resid <= 1e-8 and k6 > 0,
          "GNHEP: gates")


MARKOV_M = 100
FILTER_INTERVAL = (1.0, 1.05)  # 43 eigenvalues of laplacian_2d(95, 97)
FILTER_DEGREE = 500


def solvers_small(dev):
    """power (with and without shift-and-invert), subspace (ncv > 8 on a
    DIA operator: K5 in chunks), arnoldi, lanczos and lapack on the
    reference's test problems (tests/test_eps_solvers.py), scaled up: the
    gapped spectrum to 100,000 rows (subspace, power, arnoldi, lanczos),
    the 1-D Laplacian to 300 rows (inverse iteration) and 500 (lapack,
    dense by design)."""
    f64 = torch.float64
    import scipy.linalg as sla

    # a gapped spectrum: a tridiagonal DIA, geometric diagonal
    n = 100_000
    dg = np.where(np.arange(n) < 80, 3.0 * 0.8 ** np.arange(n), 1e-6)
    off = np.full(n, 1e-3)
    top = sla.eigh_tridiagonal(dg, off[:-1], select="i",
                               select_range=(n - 4, n - 1),
                               eigvals_only=True)[::-1]
    G = stt.DIAOperator((-1, 0, 1), torch.from_numpy(np.stack(
        [off, dg, off])).to(dev, f64))
    lap = stt.laplacian_1d(SOLVER_N, dtype=f64, device=dev)
    lap_exact = stt.laplacian_1d_eigs(SOLVER_N)
    for solver, A, kw, want, launched in (
            ("subspace", G, dict(which="largest_real", nev=4, ncv=20,
                                 max_it=500), top, ("dia_spmm",)),
            ("power", G, dict(which="largest_magnitude", nev=2, max_it=5000,
                              tol=1e-9), top[:2], ("dia_spmv",)),
            # ncv 10: a dozen explicit restarts, K3 / K4 on a basis of
            # 100,000-row columns
            ("arnoldi", G, dict(which="largest_real", nev=4, ncv=10,
                                max_it=2000), top,
             ("dia_spmv", "panel_", "rotate")),
            ("lanczos", G, dict(which="largest_real", nev=4, ncv=10,
                                max_it=2000), top,
             ("dia_spmv", "panel_", "rotate")),
            ("lapack", stt.laplacian_1d(500, dtype=f64, device=dev),
             dict(which="largest_real", nev=4),
             stt.laplacian_1d_eigs(500)[::-1][:4], ("dia_spmv",))):
        before = stt.launch_counts()
        t0 = time.perf_counter()
        eps = stt.EPS(A, problem_type="hep", solver=solver,
                      options=stt.Options(), **kw)
        eps.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = stt.launch_counts()  # the solve's, before the residuals'
        n_launch = {f: sum(after[key] - before[key] for key in after
                           if key.startswith(f) and key.endswith("f64"))
                    for f in launched}
        k = len(want)
        got = np.sort(np.asarray(eps.eigenvalues[:k], np.float64))[::-1]
        err = float(np.max(np.abs(got - want) / np.abs(want))) \
            if eps.nconv >= k else np.inf
        resid = max(eps.compute_error(i) for i in range(min(k, eps.nconv)))
        print(f"  {solver} n={A.shape[0]}: nconv={eps.nconv} its={eps.its} "
              f"wall={wall:.3f} s max rel|lam - ref|={err:.3e} max true rel "
              f"resid={resid:.3e} launches={n_launch}", flush=True)
        check(eps.nconv >= k and err <= 1e-8 and resid <= 1e-7,
              f"{solver}: gates")
        check(all(v > 0 for v in n_launch.values()),
              f"{solver}: a kernel did not launch: {n_launch}")
    # power + shift-and-invert: inverse iteration toward a target
    for shift in ("constant", "rayleigh"):
        t0 = time.perf_counter()
        eps = stt.EPS(lap, problem_type="hep", nev=1, solver="power",
                      max_it=2000, options=stt.Options())
        eps.set_target(1.01)
        eps.power_shift_type = shift
        eps.solve()
        torch.cuda.synchronize()
        want = lap_exact[np.argmin(np.abs(lap_exact - 1.01))]
        err = abs(float(eps.eigenvalues[0]) - want) / want
        print(f"  power + sinvert ({shift}), target 1.01, n={SOLVER_N}: "
              f"nconv={eps.nconv} its={eps.its} wall="
              f"{time.perf_counter() - t0:.3f} s rel|lam - exact|={err:.3e} "
              f"resid={eps.compute_error(0):.3e}", flush=True)
        check(eps.nconv >= 1 and err <= 1e-9, f"power sinvert {shift}: gates")


SOLVER_N = 300


def budget_sweep(dev, L, A, more):
    """K6 at each row-block budget (ms, CUDA events, median of 20): the
    natural and RCM-ordered flagship, RCM + random entries and the hub
    graph, f64 and f32, beside the DIA kernel on the same matrix; every
    budget's result against the default plan's."""
    print("profile: K6 at each row-block budget (ms, CUDA events, median of "
          "20), beside the DIA kernel where the matrix routes to it",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(4)
    for dt, tol in ((torch.float64, 1e-13), (torch.float32, 2e-6)):
        for label, M in (("natural", L), ("RCM", A), *more.items()):
            op = stt.from_scipy(M, dtype=dt, device=dev)
            x = torch.randn(op.shape[1], generator=gen, dtype=dt, device=dev)
            y = op.mult(x)
            times = []
            for budget in (512, 1024, 2048, 4096, 8192):
                plan = csr_plan(op.rowptr, budget)
                run = lambda: csr_spmv(op.rowptr, op.cols, op.vals, x,
                                       op.shape[1], plan=plan)
                err = float((run() - y).abs().max() / y.abs().max())
                check(err <= tol, f"K6 at budget {budget}: {err:.3e}")
                times.append(f"B{budget}={cuda_ms(run):.4f}")
            fast = op.fast_form()
            if isinstance(fast, stt.DIAOperator):
                times.append(f"DIA={cuda_ms(lambda: fast.mult(x)):.4f}")
            print(f"  {label} {TAG[dt]}: {' '.join(times)} (default "
                  f"{CSR_BUDGET[dt]})", flush=True)
            del op, x, y, fast
            torch.cuda.empty_cache()


def tile_sweep(dev):
    """K5 at each tile (rows a block stages) on the flagship operator,
    b = 1, 4, 8, f64 and f32 (ms, CUDA events, median of 20); the plan's
    diagonals printed as d(irect) and n(ear)."""
    print("profile: K5 at each tile (ms, CUDA events, median of 20) on the "
          "flagship operator", flush=True)
    gen = torch.Generator(device=dev).manual_seed(10)
    lap = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    n = lap.shape[0]
    for dt, tiles in ((torch.float64, (512, 1024, 2048, 4096)),
                      (torch.float32, (1024, 2048, 4096, 8192))):
        diags = lap.diags.to(dt)
        V = torch.randn((9, n), generator=gen, dtype=dt, device=dev)
        for b in (1, 4, 8):
            X = V[1:1 + b]
            Y = dia_spmm(lap.offsets, diags, X)
            times = []
            for tile in tiles:
                run = lambda: dia_spmm(lap.offsets, diags, X, tile=tile)
                err = float((run() - Y).abs().max() / Y.abs().max())
                check(err == 0.0, f"K5 at tile {tile}: differs by {err:.3e}")
                plan = plan_spmm(lap.offsets, n, b, dt, tile)
                where = "".join("dn"[w] for w in plan.where)
                times.append(f"T{tile}({where})={cuda_ms(run):.4f}")
            print(f"  {TAG[dt]} b={b}: {' '.join(times)} (default "
                  f"{SPMM_TILE[dt]})", flush=True)
            del X, Y
        del diags, V
        torch.cuda.empty_cache()


def _swapped(what):
    """Context: the blocked cycle's K5, K3 or K4 call sites take the plain
    version (``what``: a subset of {"K5", "K3", "K4"})."""
    import contextlib

    from slepc_tpu_torch.eps import ks_jit
    from slepc_tpu_torch.mat import linop

    def rotate_plain(Q, V, out=None):
        r = rotate_ref(Q, V)
        return r if out is None else out.copy_(r)

    swaps = []
    if "K5" in what:
        swaps.append((linop, "dia_spmm",
                      lambda o, d, X: dia_spmm_ref(o, d, X)))
    if "K3" in what:
        swaps += [(ks_jit, "panel_dots", panel_dots_ref),
                  (ks_jit, "panel_update", panel_update_ref),
                  (ks_jit, "panel_update_dots", panel_update_dots_ref)]
    if "K4" in what:
        swaps.append((ks_jit, "rotate", rotate_plain))

    @contextlib.contextmanager
    def ctx():
        saved = [(m, k, getattr(m, k)) for m, k, _ in swaps]
        for m, k, f in swaps:
            setattr(m, k, f)
        try:
            yield
        finally:
            for m, k, f in saved:
                setattr(m, k, f)

    return ctx()


def blocked_f32_study(dev, max_it=1000):
    """Phase 6's f32 blocked solve (laplacian_2d(95, 97), block_size 4,
    ncv 28, nev 6) at tol 1e-5, with every kernel, with each of K5, K3 and
    K4 swapped for its plain version, and with all three swapped: nconv,
    restarts, and where the six wanted error estimates level off (their
    least value over the run and their value at the end)."""
    print(f"profile: the f32 blocked solve at tol 1e-5 with kernels swapped "
          f"for their plain versions ({max_it} restarts at most)", flush=True)
    A = stt.laplacian_2d(95, 97, dtype=torch.float32, device=dev)
    for what in ((), ("K5",), ("K3",), ("K4",), ("K5", "K3", "K4")):
        eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=6,
                      ncv=28, tol=1e-5, max_it=max_it, options=stt.Options())
        eps.block_size = 4
        errs = []
        eps.monitor.add(lambda _e, _its, _k2, _theta, err: errs.append(
            np.array(err[:6], np.float64)))
        t0 = time.perf_counter()
        with _swapped(what):
            eps.solve()
        torch.cuda.synchronize()
        E = np.array(errs)
        print(f"  plain {'+'.join(what) or 'none':<9} nconv={eps.nconv} "
              f"its={eps.its} wall={time.perf_counter() - t0:.2f} s; "
              f"least estimates {np.array2string(E.min(axis=0), precision=2)}"
              f", last {np.array2string(E[-1], precision=2)}", flush=True)


def profile_solve(where, solve, plain_wall=None, shares=None):
    """torch.profiler over ``solve()``, which returns the wall time.
    ``plain_wall``: the same solve's wall without the profiler (its host
    overhead stretches a launch-bound solve; kernel times stay).
    ``shares``: {label: name fragments}, each label's share of the device
    time (the kernels whose names hold one of its fragments)."""
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
    for label, parts in (shares or {}).items():
        ms = sum(e.self_device_time_total for e in kernels
                 if any(p in e.key for p in parts)) / 1e3
        print(f"  {label}: {ms:.1f} ms, {100 * ms / max(busy, 1e-9):.1f}% of "
              f"the device time", flush=True)


# ---- the complex slice (item 11a-ii) -------------------------------------

GAUGE_SEED = 11


def gauge_phases(n):
    """phi = 2 pi u, u from numpy default_rng(11): the phases of the gauge
    transform U = diag(e^{i phi})."""
    return 2 * np.pi * np.random.default_rng(GAUGE_SEED).random(n)


def gauge_dia(A, dtype, phi=None):
    """U A U^H of a real DIA operator A: entry (i, i + o) times
    e^{i (phi_i - phi_{i+o})}.  It keeps A's offsets and spectrum, and is
    complex Hermitian for a symmetric A.  Built on A's device; ``phi``
    (host, n) defaults to gauge_phases(n)."""
    n = A.shape[0]
    phi = torch.from_numpy(gauge_phases(n) if phi is None else phi).to(
        A.device)
    d = A.diags.to(torch.complex128)
    for k, o in enumerate(A.offsets):
        lo, hi = max(0, -o), min(n, n - o)
        if hi > lo:
            d[k, lo:hi] *= torch.polar(torch.ones_like(phi[lo:hi]),
                                       phi[lo:hi] - phi[lo + o:hi + o])
    return stt.DIAOperator(A.offsets, d.to(dtype))


def gauge_csr(M):
    """U M U^H of a host scipy CSR matrix, with gauge_dia's phases."""
    M = sp.csr_matrix(M)
    phi = gauge_phases(M.shape[0])
    rows = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
    vals = M.data * np.exp(1j * (phi[rows] - phi[M.indices]))
    return sp.csr_matrix((vals, M.indices.copy(), M.indptr.copy()),
                         shape=M.shape)


def dia_as_torch_csr(A):
    """A DIA operator's matrix as a torch.sparse_csr_tensor on its device:
    the library call beside K1c / K2c (used nowhere in the port)."""
    n = A.shape[0]
    rows, cols, vals = [], [], []
    for k, o in enumerate(A.offsets):
        lo, hi = max(0, -o), min(n, n - o)
        r = torch.arange(lo, hi, device=A.device)
        rows.append(r)
        cols.append(r + o)
        vals.append(A.diags[k, lo:hi])
    S = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                torch.cat(vals), (n, n)).coalesce()
    return S.to_sparse_csr()


def library_sparse_ms(S, x, ref):
    """(ms, what) of the library's complex CSR product S @ x, held against
    the kernel's ref; (None, the error) when torch raises for it."""
    try:
        y = S @ x
    except RuntimeError as exc:  # the library call only, never the port
        return None, f"torch.sparse_csr_tensor @ x raised: {exc}"[:200]
    err = float((y - ref).abs().max() / ref.abs().max())
    check(err <= (1e-12 if x.dtype == torch.complex128 else 1e-5),
          f"library complex CSR product differs from the kernel by {err:.3e}")
    return cuda_ms(lambda: S @ x), CUSPARSE


def phase1_complex(dev, table, A_rcm):
    """K1c / K2c, K3c, K4c and K6c against their plain versions."""
    print("phase 1: the complex instantiations vs plain PyTorch: K2c / K1c on "
          "the gauge-transformed flagship and the 2^20-row complex "
          "deployment, K3c at K = 49, K4c at (48, 40), K6c on the "
          "gauge-transformed RCM flagship CSR", flush=True)
    gen = torch.Generator(device=dev).manual_seed(12)
    lap = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    n = lap.shape[0]
    for dt, tol in ((torch.complex128, 1e-14), (torch.complex64, 2e-6)):
        name = f"dia_spmv_{TAG[dt]}"
        G = gauge_dia(lap, dt)
        x = torch.randn(n, generator=gen, dtype=dt, device=dev)
        err, rel = spmv_errors(G.offsets, G.diags, x)
        ms = cuda_ms(lambda: dia_spmv(G.offsets, G.diags, x))
        plain = cuda_ms(lambda: dia_spmv_ref(G.offsets, G.diags, x))
        lib, what = library_sparse_ms(dia_as_torch_csr(G), x,
                                      dia_spmv(G.offsets, G.diags, x))
        elt = x.element_size()
        S = stt.DIAOperator((-1, 0, 1), torch.from_numpy(
            spiral_diags(1 << NHEP_LOG2)).to(dev, dt))
        xs = torch.randn(S.shape[0], generator=gen, dtype=dt, device=dev)
        err_s, rel_s = spmv_errors(S.offsets, S.diags, xs)
        ms_s = cuda_ms(lambda: dia_spmv(S.offsets, S.diags, xs))
        nb_s = (3 + 2) * S.shape[0] * elt
        print(f"  {name} on the 2^20-row deployment (3 diagonals): err "
              f"{rel_s:.3e}  kernel {ms_s:.4f} ms  bound "
              f"{nb_s / PEAK_BYTES * 1e3:.4f} ms  {nb_s / 1e6:.1f} MB -> "
              f"{nb_s / ms_s / 1e6:.1f} GB/s", flush=True)
        record(table, name, max(err, err_s), max(rel, rel_s), tol, ms, plain,
               (len(G.offsets) + 2) * n * elt, 8 * G.nnz, dt, lib, what)
        del G, x, S, xs
        torch.cuda.empty_cache()
    del lap

    K, b, Kr, P = 49, 1, 48, 40
    for dt, tol in ((torch.complex128, 1e-13), (torch.complex64, 1e-5)):
        t = TAG[dt]
        V = torch.randn((K, n), generator=gen, dtype=dt, device=dev)
        W = torch.randn((b, n), generator=gen, dtype=dt, device=dev)
        C = torch.randn((K, b), generator=gen, dtype=dt, device=dev)
        elt = V.element_size()
        errs = panel_errors(V, W, C)
        lib = library_panel(V, W, C, tol)
        record(table, f"panel_dots_{t}", *errs["panel_dots"], tol,
               cuda_ms(lambda: panel_dots(V, W)),
               cuda_ms(lambda: panel_dots_ref(V, W)),
               (K + b) * n * elt, 8 * K * b * n, dt, *lib["panel_dots"])
        record(table, f"panel_update_{t}", *errs["panel_update"], tol,
               cuda_ms(lambda: panel_update(V, C, W)),
               cuda_ms(lambda: panel_update_ref(V, C, W)),
               (K + 2 * b) * n * elt, 8 * K * b * n, dt, *lib["panel_update"])
        record(table, f"panel_update_dots_{t}", *errs["panel_update_dots"],
               tol, cuda_ms(lambda: panel_update_dots(V, C, W)),
               cuda_ms(lambda: panel_update_dots_ref(V, C, W)),
               (K + 2 * b) * n * elt, 16 * K * b * n, dt,
               *lib["panel_update_dots"])
        Q = random_q(Kr, P, dev, dt)
        Vr = V[:Kr]
        record(table, f"rotate_{t}", *rotate_errors(Q, Vr),
               1e-14 if dt == torch.complex128 else 1e-5,
               cuda_ms(lambda: rotate(Q, Vr)),
               cuda_ms(lambda: rotate_ref(Q, Vr)),
               (Kr + P) * n * elt, 8 * Kr * P * n, dt, *library_rotate(Q, Vr))
        # in place (the restart's call: out = V[:P]) on a copy of the basis,
        # bitwise the out-of-place result, and the same bits a second time
        Vw = Vr.clone()
        same = torch.equal(rotate(Q, Vw, out=Vw[:P]), rotate(Q, Vr))
        check(same, f"rotate_{t} in place differs from out of place")
        check(torch.equal(rotate(Q, Vr), rotate(Q, Vr)),
              f"rotate_{t}: two calls differ")
        ms_in = cuda_ms(lambda: rotate(Q, Vw, out=Vw[:P]))
        print(f"  rotate_{t} in place ({Kr}, {P}): {ms_in:.4f} ms "
              f"({(Kr + P) * n * elt / ms_in / 1e6:.1f} GB/s)", flush=True)
        if dt == torch.complex128:
            wide_panels(V, gen, tol)
        del V, W, C, Q, Vr, Vw
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    Ac = gauge_csr(A_rcm)
    print(f"  host: the gauge-transformed RCM flagship CSR in "
          f"{time.perf_counter() - t0:.3f} s (nnz {Ac.nnz})", flush=True)
    for dt, tol in ((torch.complex128, 1e-13), (torch.complex64, 2e-6)):
        name = f"csr_spmv_{TAG[dt]}"
        op = stt.from_scipy(Ac, dtype=dt, device=dev)
        x = torch.randn(op.shape[1], generator=gen, dtype=dt, device=dev)
        rows = row_of_entry(op.rowptr)
        y = op.mult(x)
        y_ref = csr_spmv_ref(op.rowptr, op.cols, op.vals, x, rows)
        err = float((y - y_ref).abs().max())
        rel = err / float(y_ref.abs().max())
        ms = cuda_ms(lambda: op.mult(x))
        plain = cuda_ms(lambda: csr_spmv_ref(op.rowptr, op.cols, op.vals, x,
                                             rows))
        S = torch.sparse_csr_tensor(op.rowptr, op.cols.to(torch.int64),
                                    op.vals, size=op.shape)
        lib, what = library_sparse_ms(S, x, y)
        elt = x.element_size()
        nbytes = (op.nnz * (elt + 4) + (op.shape[0] + 1) * 8
                  + 2 * op.shape[0] * elt)
        print(f"  {name}: budget {CSR_BUDGET[dt]} entries a block",
              flush=True)
        record(table, name, err, rel, tol, ms, plain, nbytes, 8 * op.nnz, dt,
               lib, what)
        del op, x, rows, y, y_ref, S
        torch.cuda.empty_cache()


def wide_panels(V, gen, tol):
    """K3c in complex128 at panel widths 2 and 4 on the first 49 rows of V:
    each sweep, checked against its plain version, beside its bound and the
    library's calls, and update+dots as the route fused_update_dots gives
    it, beside the two sweeps where that route is the fused kernel."""
    n, dt = V.shape[1], V.dtype
    for K, b in ((49, 2), (49, 4)):
        Vk = V[:K]
        W = torch.randn((b, n), generator=gen, dtype=dt, device=V.device)
        C = torch.randn((K, b), generator=gen, dtype=dt, device=V.device)
        errs = panel_errors(Vk, W, C)
        worst = max(e[1] for e in errs.values())
        check(worst <= tol, f"K3c c128 K={K} b={b}: error {worst:.3e}")
        lib = library_panel(Vk, W, C, tol)
        fused = fused_update_dots(K, b, dt)
        ms = {"panel_dots": cuda_ms(lambda: panel_dots(Vk, W)),
              "panel_update": cuda_ms(lambda: panel_update(Vk, C, W)),
              "panel_update_dots": cuda_ms(lambda: panel_update_dots(Vk, C, W))}
        elt = V.element_size()
        nbytes = {"panel_dots": (K + b) * n * elt,
                  "panel_update": (K + 2 * b) * n * elt,
                  "panel_update_dots": (K + 2 * b) * n * elt}
        for name, t in ms.items():
            print(f"  {name}_c128 K={K} b={b}: kernel {t:.4f} ms  bound "
                  f"{nbytes[name] / PEAK_BYTES * 1e3:.4f} ms  library "
                  f"{lib[name][0]:.4f} ms ({lib[name][1]})"
                  + ("" if name != "panel_update_dots" else
                     f"  [{'fused' if fused else 'two sweeps'}]"), flush=True)
        if fused:  # the other route: the update sweep, then the dots sweep
            two = cuda_ms(lambda: panel_dots(Vk, panel_update(Vk, C, W)))
            print(f"  update+dots_c128 K={K} b={b} as two sweeps: {two:.4f} ms"
                  f" (fused {ms['panel_update_dots']:.4f})", flush=True)
        del W, C


def ring_sweep(dev):
    """K4c at the restart shape (48, 40), n = 10.35M, at every ring depth
    that fits, each with the blocks an SM the compiled kernel holds at it
    and the grid the planner gives that occupancy: the study behind
    plan_rotate's choice for the complex types (the most blocks an SM, the
    deepest ring of those)."""
    lib = _build.load()
    n, K, P = FLAGSHIP[0] * FLAGSHIP[1] * FLAGSHIP[2], 48, 40
    gen = torch.Generator(device=dev).manual_seed(14)
    print("profile: K4c's ring depth at (48, 40), n = 10,350,000", flush=True)
    for dt in (torch.complex128, torch.complex64):
        code = _build.DTYPE_CODE[str(dt)]
        V = torch.randn((K, n), generator=gen, dtype=dt, device=dev)
        Q = random_q(K, P, dev, dt)
        out = torch.empty((P, n), dtype=dt, device=dev)
        want = rotate(Q, V)

        def blocks(stages):
            got = ctypes.c_int(0)
            _build.check(lib.slepc_rotate_occupancy(
                code, 1, K, P, stages, ctypes.byref(got)), "occupancy")
            return got.value

        plan = plan_rotate(K, P, n, dt, blocks_per_sm=lambda vec, k, p, s:
                           blocks(s))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for stages in (2, 3, 4):
            if lib.slepc_rotate_smem(code, K, P, stages) > 232_448:
                continue
            per_sm = blocks(stages)
            grid = min(-(-n // plan["tile"]), sms * per_sm)

            def launch():
                _build.check(lib.slepc_rotate(
                    code, 1, Q.data_ptr(), K, P, V.data_ptr(), n,
                    out.data_ptr(), n, n, stages, grid,
                    _build.stream_handle(V)), "rotate")

            launch()
            check(torch.equal(out, want), f"K4c {TAG[dt]} ring {stages}: "
                  f"differs from the planned launch")
            print(f"  rotate_{TAG[dt]} ring depth {stages}: {per_sm} blocks an "
                  f"SM, grid {grid}: {cuda_ms(launch):.4f} ms"
                  + (" (the planner's)" if stages == plan["stages"] else ""),
                  flush=True)
        del V, Q, out, want
        torch.cuda.empty_cache()


def phase12a(dev, lam_f64, nhep_walls):
    """The reference's non-Hermitian deployment natively complex: 2^20 rows,
    3 complex diagonals, nev 6, ncv 32, c128 at tol 1e-8 and c64 at 1e-4.
    Returns the launch counts of its solves (read from zero), the c128
    values and the c128 (wall, restarts, columns)."""
    n_c = 1 << NHEP_LOG2
    nev, ncv = NHEP_NEV // 2, 32
    for dt in (torch.complex128, torch.complex64):
        path_kernels(dev, f"phase 12a: {', '.join(PATH_TOL[dt])} vs plain "
                     f"PyTorch at the complex deployment's shapes", (
                         ("phase 12a, 2^20 complex rows",
                          lambda: stt.DIAOperator((-1, 0, 1), torch.from_numpy(
                              spiral_diags(n_c)).to(dev, dt)), ncv),),
                     dtype=dt)
    print(f"phase 12a: the non-Hermitian deployment natively complex: "
          f"{n_c:,} rows, 3 complex diagonals, nev {nev}, ncv {ncv}, largest "
          f"magnitude", flush=True)
    stt.reset_launch_counts()
    small = spiral_diags(1 << 10)
    Ac = sp.diags([small[0, 1:], small[1], small[2, :-1]], [-1, 0, 1])
    w = np.linalg.eigvals(Ac.toarray())
    top = w[np.argsort(-np.abs(w))][:nev]
    eps, wall, _ = nhep_solve(stt.DIAOperator((-1, 0, 1), torch.from_numpy(
        small).to(dev)), 1e-8, nev=nev, ncv=ncv)
    check(eps.nconv >= nev, f"phase 12a 2^10: nconv {eps.nconv}")
    got = np.asarray(eps.eigenvalues[:nev])
    rel = max(float(np.min(np.abs(top - v))) / abs(v) for v in got)
    print(f"  build check, 2^10 rows: nconv={eps.nconv} its={eps.its} "
          f"wall={wall:.3f} s, max rel |lam - eigvals| = {rel:.3e}",
          flush=True)
    check(rel <= 1e-9, f"phase 12a 2^10: eigenvalues off by {rel:.3e}")
    dmax = float(np.abs(spiral_diags(1 << 4)[1]).max())
    lam128 = None
    for dt, tol, gate in ((torch.complex128, 1e-8, 1e-8),
                          (torch.complex64, 1e-4, 1e-3)):
        t = TAG[dt]
        where = f"phase 12a {t} (tol {tol:.0e})"
        A = stt.DIAOperator((-1, 0, 1), torch.from_numpy(
            spiral_diags(n_c)).to(dev, dt))
        torch.cuda.reset_peak_memory_stats(dev)
        eps, wall, delta = nhep_solve(A, tol, nev=nev, ncv=ncv)
        peak = torch.cuda.max_memory_allocated(dev)
        fam = family_counts(delta, TAG[dt])
        cols, k = fam["SpMV"], eps.nconv
        lam = np.asarray(eps.eigenvalues[:k])
        resid = np.array([eps.compute_error(i) for i in range(k)])
        real = nhep_walls["f64" if dt == torch.complex128 else "f32"]
        print(f"  {where}: nconv={k} restarts={eps.its} columns={cols} "
              f"wall={wall:.3f} s ({wall / max(cols, 1) * 1e3:.3f} ms per "
              f"column) peak_mem={peak / 1e9:.2f} GB launches={fam}; phase "
              f"10's real form: {real[0]:.3f} s, {real[2]} columns "
              f"({real[0] / max(real[2], 1) * 1e3:.3f} ms per column)",
              flush=True)
        print(f"  {where}: max true rel resid={resid.max() if k else np.inf:.3e}"
              f" lam={np.array2string(lam[:nev], precision=6)}", flush=True)
        check(k >= nev, f"{where}: nconv {k} < {nev}")
        check(np.all(np.abs(lam) > 0.75 * dmax),
              f"{where}: a value below the top band: {np.abs(lam).min()}")
        check(resid.max() <= gate, f"{where}: true residual {resid.max():.3e}")
        if dt == torch.complex128:
            far = max(float(np.min(np.abs(lam_f64 - v))) / abs(v)
                      for v in lam[:nev])
            print(f"  {where}: max rel distance to phase 10's f64 twelve "
                  f"{far:.3e}", flush=True)
            check(far <= 1e-10, f"{where}: a value {far:.3e} from phase 10's")
            lam128 = lam[:nev]
            run128 = (wall, eps.its, cols)
        else:
            far = max(float(np.min(np.abs(lam128 - v))) / abs(v)
                      for v in lam[:nev])
            print(f"  {where}: max rel distance to the c128 values "
                  f"{far:.3e}", flush=True)
            check(far <= 1e-4, f"{where}: a value {far:.3e} from the c128 run's")
        check(all(v > 0 for v in fam.values()),
              f"{where}: a kernel did not launch: {fam}")
        del eps, A
        torch.cuda.empty_cache()
    return stt.launch_counts(), lam128, run128


def phase12b(dev, wall_plain):
    """Complex Hermitian at full width (the gauge-transformed flagship,
    phase 9's plain cycle in c128) and certified on the gauge-transformed
    laplacian_2d(95, 97) as DIA and as RCM-ordered CSR, c128 and c64.
    Returns the launch counts of its solves (read from zero) and the wall of
    the full-width cycle."""
    ncv, restarts = 48, 3
    lap = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    G = gauge_dia(lap, torch.complex128)
    del lap
    path_kernels(dev, "phase 12b: K2c, K3c, K4c vs plain PyTorch at the "
                 "complex Hermitian flagship's shapes",
                 (("phase 12b, gauge-transformed flagship", lambda: G, ncv),),
                 dtype=torch.complex128)
    print(f"phase 12b: complex Hermitian at full width: the gauge-transformed "
          f"200x225x230 Laplacian (c128, 10.35M rows), the plain cycle "
          f"through EPS, ncv {ncv}, largest_real, {restarts} restarts",
          flush=True)
    stt.reset_launch_counts()
    cycles = []
    torch.cuda.reset_peak_memory_stats(dev)
    eps, wall = plain_solve(G, ncv, restarts, cycles)
    peak = torch.cuda.max_memory_allocated(dev)
    delta = stt.launch_counts()
    fam = family_counts(delta, "c128")
    marks = [{k: 0 for k in delta}] + [c[3] for c in cycles]
    cols = [m1["dia_spmv_c128"] - m0["dia_spmv_c128"]
            for m0, m1 in zip(marks, marks[1:])]
    later = sum(cols[1:])
    later_ms = (cycles[-1][2] - cycles[0][2]) * 1e3
    theta = cycles[-1][1]
    print(f"  nconv={eps.nconv} (not required) restarts={eps.its} wall="
          f"{wall:.3f} s columns={sum(cols)} peak_mem={peak / 1e9:.2f} GB "
          f"launches={fam}; restarts 2..{len(cycles)}: {later} columns in "
          f"{later_ms:.1f} ms = {later_ms / max(later, 1):.3f} ms per column "
          f"(phase 9's f64 solve: {wall_plain:.3f} s)", flush=True)
    check(len(cycles) > 1, "phase 12b: no restarted cycle ran")
    check(theta.min() >= 0.0 and theta.max() <= 12.0,
          f"phase 12b: Ritz values outside [0, 12]: {theta.min()}, "
          f"{theta.max()}")
    check(all(v > 0 for v in fam.values()),
          f"phase 12b: a kernel did not launch: {fam}")
    del eps
    V = torch.zeros((ncv + 1, G.shape[0]), dtype=torch.complex128, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    V[0] = torch.randn(G.shape[0], generator=gen, dtype=torch.complex128,
                       device=dev)
    V[0] /= torch.linalg.vector_norm(V[0])
    H, j0 = np.zeros((ncv + 1, ncv), complex), 0
    for _ in range(restarts):
        V, H, j0 = ks_hep_cycle(G, V, H, j0, 1e-8, gen, ncv=ncv,
                                which="largest")[:3]
    B = V[: j0 + 1]
    orth = float((B.conj() @ B.T - torch.eye(j0 + 1, dtype=B.dtype,
                                             device=dev)).abs().max())
    print(f"  {restarts} restarts through ks_hep_cycle: kept basis rows "
          f"{j0 + 1}, max|V V^H - I| = {orth:.3e}", flush=True)
    check(orth <= 1e-12, f"phase 12b: basis not orthonormal: {orth:.3e}")
    del V, B, G
    torch.cuda.empty_cache()
    wall_cycle = wall

    print("phase 12b: the gauge-transformed laplacian_2d(95, 97), nev 6, "
          "ncv 28, smallest, as DIA (K2c / K1c) and as RCM-ordered complex "
          "CSR (K6c), c128 at tol 1e-8 and c64 at tol 1e-5", flush=True)
    exact = stt.laplacian_2d_eigs(95, 97, k=6)
    L = stt.laplacian_2d(95, 97, device=dev)
    csr = gauge_csr(rcm_order(stt.laplacian_2d(95, 97, device="cpu").to_scipy()))
    for kind, spmv in (("DIA", "dia_spmv"), ("CSR", "csr_spmv")):
        for dt, tol in ((torch.complex128, 1e-8), (torch.complex64, 1e-5)):
            A = gauge_dia(L, dt) if kind == "DIA" else stt.from_scipy(
                csr, dtype=dt, device=dev)
            before = stt.launch_counts()
            eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=6,
                          ncv=28, tol=tol, max_it=400, options=stt.Options())
            t0 = time.perf_counter()
            eps.solve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = stt.launch_counts()
            fam = family_counts({k: counts[k] - before[k] for k in counts},
                                TAG[dt], spmv)
            k = min(eps.nconv, 6)
            lam = np.sort(np.asarray(eps.eigenvalues[:k], np.float64))
            err = np.abs(lam - exact[:k]) if k else np.array([np.inf])
            resid = np.array([eps.compute_error(i) for i in range(k)])
            where = f"phase 12b 95x97 {kind} {TAG[dt]} (tol {tol:.0e})"
            print(f"  {where}: nconv={eps.nconv} its={eps.its} wall={wall:.3f}"
                  f" s max|lam-exact|={err.max():.3e} max true rel resid="
                  f"{resid.max() if k else np.inf:.3e} launches={fam}",
                  flush=True)
            check(eps.nconv >= 6, f"{where}: nconv {eps.nconv} < 6")
            if dt == torch.complex128:
                check(err.max() <= 1e-9, f"{where}: |lam - exact| "
                      f"{err.max():.3e}")
                check(resid.max() <= 1e-8, f"{where}: true residual "
                      f"{resid.max():.3e}")
            else:
                check(np.max(err / exact) <= 1e-4, f"{where}: relative "
                      f"error {np.max(err / exact):.3e}")
            check(all(v > 0 for v in fam.values()),
                  f"{where}: a kernel did not launch: {fam}")
    return stt.launch_counts(), wall_cycle


def phase12c(dev):
    """Small complex paths, each with its gate.  Returns the launch counts
    (read from zero)."""
    c128 = torch.complex128
    print("phase 12c: small complex paths: a complex shift of a real "
          "operator, complex GHEP, arnoldi / power / subspace / lanczos, "
          "harmonic extraction and a region", flush=True)
    stt.reset_launch_counts()
    exact = np.asarray(stt.laplacian_2d_eigs(95, 97))
    # the imaginary part stays below the eigenvalue spacing near 0.5 (about
    # 1e-3): at 0.5 + 0.1i every nearby value maps to 1 / (lam - sigma) of
    # nearly the same size (|lam - sigma| ~ 0.1 for all of them), and the
    # Krylov run cannot separate them (nconv 0 after 970 restarts, CPU)
    tgt = 0.5 + 0.01j
    eps = stt.EPS(stt.laplacian_2d(95, 97, device=dev), problem_type="hep",
                  nev=4, options=stt.Options())
    eps.set_target(tgt)
    eps.set_true_residual()
    t0 = time.perf_counter()
    eps.solve()
    torch.cuda.synchronize()
    want = np.sort(exact[np.argsort(np.abs(exact - tgt))[:4]])
    got = np.sort(np.asarray(eps.eigenvalues[:4]).real)
    resid = max((eps.compute_error(i) for i in range(min(eps.nconv, 4))),
                default=np.inf)
    err = float(np.abs(got - want).max()) if eps.nconv >= 4 else np.inf
    print(f"  complex shift {tgt} (STSinvert, host LU of the complex "
          f"matrix): nconv={eps.nconv} its={eps.its} wall="
          f"{time.perf_counter() - t0:.3f} s max|lam-exact|={err:.3e} "
          f"resid={resid:.3e} op dtype={eps.st.op().dtype}", flush=True)
    check(eps.nconv >= 4 and err <= 1e-9 and resid <= 1e-8,
          f"phase 12c complex shift: nconv {eps.nconv}, error {err:.3e}, "
          f"residual {resid:.3e}")

    L = stt.laplacian_2d(95, 97, device=dev)
    n = L.shape[0]
    b = torch.from_numpy(1.0 + 0.5 * np.sin(1e-3 * np.arange(n)))[None]
    B = stt.DIAOperator((0,), b.to(dev))
    vals = {}
    for label, A in (("real", L), ("complex", gauge_dia(L, c128))):
        eps = stt.EPS(A, B, problem_type="ghep", which="largest_real", nev=4,
                      options=stt.Options())
        t0 = time.perf_counter()
        eps.solve()
        torch.cuda.synchronize()
        resid = max((eps.compute_error(i) for i in range(min(eps.nconv, 4))),
                    default=np.inf)
        vals[label] = np.asarray(eps.eigenvalues[:4])
        print(f"  GHEP {label} A, diagonal SPD B: nconv={eps.nconv} its="
              f"{eps.its} wall={time.perf_counter() - t0:.3f} s resid="
              f"{resid:.3e} lam={np.array2string(vals[label], precision=9)}",
              flush=True)
        check(eps.nconv >= 4 and resid <= 1e-8,
              f"phase 12c GHEP {label}: nconv {eps.nconv}, residual "
              f"{resid:.3e}")
    gap = float(np.abs(vals["complex"] - vals["real"]).max())
    check(gap <= 1e-9, f"phase 12c GHEP: the gauge-transformed pencil's "
          f"values differ from the real one's by {gap:.3e}")

    S = stt.DIAOperator((-1, 0, 1), torch.from_numpy(
        spiral_diags(1 << 12)).to(dev))
    ref = stt.EPS(S, problem_type="nhep", nev=3, ncv=24, options=stt.Options())
    ref.solve()
    top = np.asarray(ref.eigenvalues[:3])
    for solver, nev in (("arnoldi", 3), ("power", 1), ("subspace", 3)):
        eps = stt.EPS(S, problem_type="nhep", nev=nev, ncv=16, max_it=3000,
                      solver=solver, options=stt.Options())
        t0 = time.perf_counter()
        eps.solve()
        torch.cuda.synchronize()
        k = min(eps.nconv, nev)
        resid = max((eps.compute_error(i) for i in range(k)), default=np.inf)
        far = max(float(np.min(np.abs(top - v))) for v in
                  np.asarray(eps.eigenvalues[:k])) if k else np.inf
        print(f"  {solver} on the 2^12 complex deployment: nconv={eps.nconv} "
              f"its={eps.its} wall={time.perf_counter() - t0:.3f} s resid="
              f"{resid:.3e} max|lam - krylovschur's| = {far:.3e}", flush=True)
        check(k >= nev and resid <= 1e-8 and far <= 1e-8,
              f"phase 12c {solver}: nconv {eps.nconv}, residual {resid:.3e}, "
              f"distance {far:.3e}")
    G = gauge_dia(L, c128)
    eps = stt.EPS(G, problem_type="hep", which="largest_real", nev=4, ncv=28,
                  solver="lanczos", max_it=400, options=stt.Options())
    eps.solve()
    err = float(np.abs(np.sort(np.asarray(eps.eigenvalues[:4]))[::-1]
                       - np.sort(exact)[::-1][:4]).max()) \
        if eps.nconv >= 4 else np.inf
    print(f"  lanczos on the gauge-transformed 95x97 Laplacian: nconv="
          f"{eps.nconv} its={eps.its} max|lam-exact|={err:.3e}", flush=True)
    check(err <= 1e-9, f"phase 12c lanczos: |lam - exact| {err:.3e}")

    eps = stt.EPS(S, problem_type="nhep", nev=2, ncv=24, max_it=300,
                  options=stt.Options.from_cli("-st_type shift"))
    eps.set_target(2.6 + 0.8j)
    eps.set_which("target_magnitude")
    eps.set_extraction("harmonic")
    eps.solve()
    resid = max((eps.compute_error(i) for i in range(min(eps.nconv, 2))),
                default=np.inf)
    print(f"  harmonic extraction, target 2.6+0.8i: nconv={eps.nconv} its="
          f"{eps.its} resid={resid:.3e} lam="
          f"{np.array2string(np.asarray(eps.eigenvalues[:2]), precision=6)}",
          flush=True)
    check(eps.nconv >= 2 and resid <= 1e-8,
          f"phase 12c harmonic: nconv {eps.nconv}, residual {resid:.3e}")
    region = stt.RGInterval(0.0, np.inf, 0.0, np.inf)  # the first quadrant
    eps = stt.EPS(S, problem_type="nhep", nev=2, ncv=24, max_it=300,
                  options=stt.Options())
    eps.set_rg(region)
    eps.solve()
    lam = np.asarray(eps.eigenvalues[:eps.nconv])
    resid = max((eps.compute_error(i) for i in range(min(eps.nconv, 2))),
                default=np.inf)
    print(f"  region (first quadrant): nconv={eps.nconv} its={eps.its} "
          f"resid={resid:.3e} lam={np.array2string(lam, precision=6)}",
          flush=True)
    check(eps.nconv >= 2 and resid <= 1e-8
          and np.all(region.check_inside(lam) >= 0),
          f"phase 12c region: nconv {eps.nconv}, residual {resid:.3e}")
    counts = stt.launch_counts()
    for key in ("dia_spmv_c128", "panel_dots_c128", "panel_update_c128",
                "panel_update_dots_c128", "rotate_c128"):
        check(counts[key] > 0, f"phase 12c: {key} did not launch")
    return counts


# ---- phase 13: the preconditioned and contour-integral solvers ----------

GD_LOG2 = 20   # the reference's GD deployment, bench.py:498-516: 2^20 rows
CISS_LOG2 = 18  # 13c: the same construction cut to 2^18 rows (time limit)
GD_NEV, GD_NCV, GD_TOL = 3, 24, 1e-6
GD_REL = 1e-10  # the values against the leading-block reference
CISS_TOL = 1e-8
# Hankel's values come from the moment pencil itself, not as Rayleigh
# quotients, so their error is first order in the residual (4.1e-8 at 2^18
# rows: 3.2e-8 relative; the reference's own Hankel test holds 1e-7,
# tests/test_eps_advanced.py:192); Rayleigh-Ritz holds GD_REL
HANKEL_REL = 1e-7
P13_TOL = {"K2": 1e-14, "K3": 1e-13, "K4": 1e-14, "K5": 1e-13, "K6": 1e-13}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def gd_operator(log2n, dev):
    """The reference's GD operator (bench.py:498-510): tridiagonal, the
    diagonal linspace(10, 30) with its first three entries 1, 2, 3, both
    off-diagonals -1; f64 DIA."""
    n = 1 << log2n
    dg = np.linspace(10.0, 30.0, n)
    dg[:3] = [1.0, 2.0, 3.0]
    lo = np.zeros(n)
    hi = np.zeros(n)
    hi[:-1] = -1.0
    lo[1:] = -1.0
    return stt.DIAOperator((-1, 0, 1), torch.from_numpy(
        np.stack([lo, dg, hi])).to(dev))


def gd_reference(log2n, k=GD_NEV, m=256):
    """The k smallest eigenvalues of the operator's leading m x m block
    (numpy.linalg.eigvalsh): its eigenvectors decay like 1/6 a row, so the
    cut is far below 1e-10."""
    n = 1 << log2n
    dg = np.linspace(10.0, 30.0, n)[:m]
    dg[:3] = [1.0, 2.0, 3.0]
    T = np.diag(dg) - np.diag(np.ones(m - 1), 1) - np.diag(np.ones(m - 1), -1)
    return np.linalg.eigvalsh(T)[:k]


def peak_gb(dev):
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" \
        else float("nan")


def timed_solve(dev, eps):
    """eps.solve() timed to the device's end; (wall s, peak device GB)."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    eps.solve()
    sync(dev)
    return time.perf_counter() - t0, peak_gb(dev)


def value_gates(where, eps, ref, k, rel, resid_tol):
    """nconv >= k, each of the k values within ``rel`` relative of ``ref``,
    each true residual ||A x - lam x|| / |lam| (the operator's kernel) at
    most ``resid_tol``.  Returns the sorted values."""
    check(eps.nconv >= k, f"{where}: nconv {eps.nconv} < {k}")
    lam = np.sort(np.asarray(eps.eigenvalues[:eps.nconv]).real)[:k]
    err = float(np.max(np.abs(lam - ref) / np.abs(ref)))
    resid = max(eps.compute_error(i) for i in range(k))
    print(f"  {where}: lam={np.array2string(lam, precision=10)} max rel "
          f"|lam - ref|={err:.3e} max true rel resid={resid:.3e}", flush=True)
    check(err <= rel, f"{where}: relative error {err:.3e} > {rel:g}")
    check(resid <= resid_tol, f"{where}: residual {resid:.3e} > {resid_tol:g}")
    return lam


def spmm_errors(A, X):
    """Relative error of K5 against its plain version on the rows of X."""
    Y_ref = dia_spmm_ref(A.offsets, A.diags, X)
    err = float((dia_spmm(A.offsets, A.diags, X) - Y_ref).abs().max())
    return err / float(Y_ref.abs().max())


def gd_kernels(dev, csr):
    """K2, K3, K4 at the GD cycle's shapes (2^20 rows, up to ncv = 24 basis
    rows), K5 at the block paths' heights (3 rows: LOBPCG's X; 8: a full
    launch of a Davidson basis or a CISS bucket's rows at 2^18) and K6 on
    the 13b CSR case, each against its plain version; before the counts of
    phase 13 are reset (these launches are not its)."""
    path_kernels(dev, "phase 13: K2, K3, K4 vs plain PyTorch at the GD "
                 "cycle's shapes", (("phase 13a, 2^20 rows",
                                     lambda: gd_operator(GD_LOG2, dev),
                                     GD_NCV),))
    gen = torch.Generator(device=dev).manual_seed(13)
    for log2n, b in ((GD_LOG2, 3), (GD_LOG2, 8), (CISS_LOG2, 8)):
        A = gd_operator(log2n, dev)
        V = torch.randn((b + 2, A.shape[0]), generator=gen,
                        dtype=torch.float64, device=dev)
        rel = spmm_errors(A, V[1:1 + b])  # a slice of a taller block
        print(f"  K5 at 2^{log2n} rows, b={b}: err {rel:.3e}", flush=True)
        check(rel <= P13_TOL["K5"], f"phase 13 K5 b={b}: {rel:.3e}")
        del A, V
    x = torch.randn(csr.shape[0], generator=gen, dtype=torch.float64,
                    device=dev)
    y_ref = csr_spmv_ref(csr.rowptr, csr.cols, csr.vals, x)
    y = csr_spmv(csr.rowptr, csr.cols, csr.vals, x, csr.shape[1],
                 plan=csr.row_plan())
    rel = float((y - y_ref).abs().max() / y_ref.abs().max())
    print(f"  K6 on the 13b CSR case (n={csr.shape[0]}, nnz={csr.nnz}): "
          f"err {rel:.3e}", flush=True)
    check(rel <= P13_TOL["K6"], f"phase 13 K6: {rel:.3e}")
    torch.cuda.empty_cache()


def launched(where, counts, keys):
    for key in keys:
        check(counts[key] > 0, f"{where}: {key} did not launch")


def gd_eps(A, solver, max_it, precond=True):
    eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=GD_NEV,
                  ncv=GD_NCV, tol=GD_TOL, max_it=max_it, solver=solver,
                  options=stt.Options())
    if precond:
        eps.set_st(stt.STPrecond([A]))
    return eps


def phase13a(dev):
    """The reference's GD deployment at full width: the GD cycle and the
    host loop.  Returns ({path: (wall, its, expansions, peak GB)}, launch
    counts)."""
    print(f"phase 13a: GD at 2^{GD_LOG2} rows (bench.py:498-516), nev "
          f"{GD_NEV}, ncv {GD_NCV}, tol {GD_TOL:g}, f64, STPrecond: the GD "
          f"cycle (max_it 200) and the host loop (max_it 120)", flush=True)
    A = gd_operator(GD_LOG2, dev)
    ref = gd_reference(GD_LOG2)
    print(f"  leading 256 x 256 block: {np.array2string(ref, precision=10)}",
          flush=True)
    stt.reset_launch_counts()
    out, lams = {}, {}
    for fused, max_it in ((True, 200), (False, 120)):
        where = "phase 13a GD " + ("cycle" if fused else "host loop")
        # two solves, the second timed (as bench.py:517-528 times them)
        for _ in range(2):
            eps = gd_eps(A, "gd", max_it)
            eps.gd_fused = fused
            wall, peak = timed_solve(dev, eps)
        out[where] = (wall, eps.its, eps.expansions, peak)
        print(f"  {where}: wall={wall:.3f} s its={eps.its} expansions="
              f"{eps.expansions} ({wall / max(eps.expansions, 1) * 1e3:.3f} "
              f"ms an expansion) peak {peak:.2f} GB", flush=True)
        lams[fused] = value_gates(where, eps, ref, GD_NEV, GD_REL, GD_TOL)
    agree = float(np.max(np.abs(lams[True] - lams[False]) / np.abs(ref)))
    print(f"  cycle vs host loop: max rel {agree:.3e}", flush=True)
    check(agree <= GD_REL, f"phase 13a: cycle and host loop differ {agree:.3e}")
    counts = stt.launch_counts()
    launched("phase 13a", counts, ("dia_spmv_f64", "dia_spmm_f64",
                                   "panel_dots_f64", "panel_update_f64",
                                   "panel_update_dots_f64", "rotate_f64"))
    return out, counts


def gd_csr_case(dev):
    """laplacian_2d(95, 97) plus seeded symmetric random entries: 9,215
    rows on the CSR kernel (too many distinct offsets for DIA routing)."""
    M = with_random_entries(stt.laplacian_2d(95, 97, device=dev).to_scipy(),
                            seed=5)
    return M, stt.from_scipy(M, device=dev)


def phase13b(dev, csr_pair):
    """JD, LOBPCG (chunk and host loop) and RQCG on 13a's operator, and the
    GD cycle on a CSR matrix.  Returns ({solve: wall}, launch counts)."""
    print(f"phase 13b: JD, LOBPCG (chunk, host loop), RQCG at 2^{GD_LOG2} "
          f"rows, 13a's gates; the GD cycle on laplacian_2d(95, 97) with "
          f"random entries as CSR (K6)", flush=True)
    A = gd_operator(GD_LOG2, dev)
    ref = gd_reference(GD_LOG2)
    stt.reset_launch_counts()
    walls = {}
    runs = (("JD (STPrecond, target 0, inner maxit 24)", "jd", 200, True,
             ("dia_spmv_f64", "dia_spmm_f64", "panel_dots_f64", "rotate_f64")),
            ("LOBPCG chunk (no preconditioner)", "lobpcg", 2000, False,
             ("dia_spmm_f64",)),
            ("LOBPCG host loop (STPrecond)", "lobpcg", 2000, True,
             ("dia_spmm_f64",)),
            ("RQCG", "rqcg", 5000, False, ("dia_spmv_f64", "dia_spmm_f64")))
    for name, solver, max_it, precond, keys in runs:
        where = f"phase 13b {name}"
        eps = gd_eps(A, solver, max_it, precond=precond)
        if solver == "jd":
            # without a target JD's fix rule shifts by the Rayleigh quotient
            # from the first step, and from a random start it converges
            # into the bulk near 8 (as the reference's does); the target 0
            # (which = target_magnitude: here the smallest) steers it
            eps.set_target(0.0)
            eps.jd_inner_maxit = 24
        before = stt.launch_counts()
        wall, peak = timed_solve(dev, eps)
        walls[name] = wall
        after = stt.launch_counts()
        print(f"  {where}: wall={wall:.3f} s its={eps.its} expansions="
              f"{eps.expansions} peak {peak:.2f} GB", flush=True)
        launched(where, {k: after[k] - before[k] for k in after}, keys)
        value_gates(where, eps, ref, GD_NEV, GD_REL, GD_TOL)
    del A
    M, Ac = csr_pair
    check(Ac.fast_form() is Ac, "phase 13b CSR: the matrix routed to DIA")
    import scipy.sparse.linalg as spla

    ref_csr = np.sort(spla.eigsh(M, k=GD_NEV, sigma=0.0,
                                 return_eigenvectors=False))
    where = "phase 13b GD cycle on CSR"
    eps = stt.EPS(Ac, problem_type="hep", which="smallest_real", nev=GD_NEV,
                  tol=GD_TOL, max_it=2000, solver="gd", options=stt.Options())
    before = stt.launch_counts()
    wall, peak = timed_solve(dev, eps)
    walls["GD cycle on CSR"] = wall
    after = stt.launch_counts()
    print(f"  {where}: n={M.shape[0]} nnz={M.nnz} wall={wall:.3f} s its="
          f"{eps.its} expansions={eps.expansions}", flush=True)
    launched(where, {k: after[k] - before[k] for k in after},
             ("csr_spmv_f64", "panel_dots_f64", "panel_update_f64",
              "panel_update_dots_f64", "rotate_f64"))
    lam = value_gates(where, eps, ref_csr, GD_NEV, np.inf, GD_TOL)
    err = float(np.max(np.abs(lam - ref_csr)))
    print(f"  {where}: max |lam - eigsh|={err:.3e}", flush=True)
    check(err <= 1e-9, f"{where}: |lam - eigsh| {err:.3e}")
    return walls, stt.launch_counts()


def phase13c(dev):
    """CISS batched on the card (the 13a construction cut to 2^18 rows),
    Rayleigh-Ritz and Hankel; the factorized mode once on laplacian_1d(100).
    Returns ({solve: (wall, peak GB)}, launch counts)."""
    print(f"phase 13c: CISS batched at 2^{CISS_LOG2} rows (13a's operator, "
          f"cut from 2^{GD_LOG2} for the time limit), RGEllipse(2, 3, 0.3), "
          f"tol {CISS_TOL:g}", flush=True)
    A = gd_operator(CISS_LOG2, dev)
    ref = gd_reference(CISS_LOG2)
    print(f"  leading 256 x 256 block: {np.array2string(ref, precision=10)}",
          flush=True)
    stt.reset_launch_counts()
    out = {}
    for extraction in ("rr", "hankel"):
        where = f"phase 13c CISS {extraction}"
        eps = stt.EPS(A, problem_type="hep", solver="ciss", tol=CISS_TOL,
                      options=stt.Options())
        eps.set_rg(stt.RGEllipse(center=2.0, radius=3.0, vscale=0.3))
        eps.ciss_extraction = extraction
        wall, peak = timed_solve(dev, eps)
        out[where] = (wall, peak)
        check(hasattr(eps, "ciss_inner_iters"),
              f"{where}: auto did not pick the batched solves on the card")
        print(f"  {where}: wall={wall:.3f} s its={eps.its} inner iters="
              f"{eps.ciss_inner_iters} buckets={eps.ciss_inner_buckets} "
              f"refactored points="
              f"{getattr(eps, 'ciss_refactored_points', [])} peak "
              f"{peak:.2f} GB", flush=True)
        check(eps.nconv == GD_NEV, f"{where}: nconv {eps.nconv} != {GD_NEV}")
        value_gates(where, eps, ref, GD_NEV,
                    HANKEL_REL if extraction == "hankel" else GD_REL,
                    100 * CISS_TOL)
    del A
    counts = stt.launch_counts()
    launched("phase 13c", counts, ("dia_spmm_f64",))
    L = stt.laplacian_1d(100, device=dev)
    exact = stt.laplacian_1d_eigs(100)
    inside = np.sort(exact[np.abs(exact - 0.65) < 0.16])
    eps = stt.EPS(L, problem_type="hep", solver="ciss", tol=1e-9,
                  options=stt.Options())
    eps.set_rg(stt.RGEllipse(center=0.65, radius=0.16, vscale=0.3))
    eps.ciss_solver = "factorized"
    wall, _ = timed_solve(dev, eps)
    lam = np.sort(np.asarray(eps.eigenvalues).real)
    err = float(np.abs(lam - inside).max()) if eps.nconv == len(inside) \
        else np.inf
    print(f"  phase 13c CISS factorized, laplacian_1d(100): nconv="
          f"{eps.nconv} (want {len(inside)}) max|lam - exact|={err:.3e} "
          f"wall={wall:.3f} s", flush=True)
    check(err <= 1e-8, f"phase 13c factorized: nconv {eps.nconv}, {err:.3e}")
    return out, counts


def host_profile(where, solve, top=12):
    """cProfile over ``solve()``: the host functions that take the most
    time of their own (a host-bound solve's split)."""
    import cProfile
    import io
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    solve()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
    print(f"profile: cProfile over one {where} solve (host seconds)",
          flush=True)
    for line in out.getvalue().splitlines():
        if line.strip() and ("/" in line or "{" in line or "ncalls" in line):
            print("  " + line.strip()[:150], flush=True)


def profile_gd(dev, gd_walls):
    """torch.profiler and cProfile over one more solve of each of 13a's
    paths (the GD cycle and the host loop)."""
    A = gd_operator(GD_LOG2, dev)
    for fused in (True, False):
        where = "phase 13a GD " + ("cycle" if fused else "host loop")

        def solve():
            eps = gd_eps(A, "gd", 200 if fused else 120)
            eps.gd_fused = fused
            wall, _ = timed_solve(dev, eps)
            print(f"  {where}: {wall:.4f} s, {eps.expansions} expansions",
                  flush=True)
            return wall

        profile_solve(where, solve, plain_wall=gd_walls[where][0])
        host_profile(where, solve)
    del A


# ---------------------------------------------------------------------------
# phase 14: the structured variants (item 11d)
# ---------------------------------------------------------------------------

TS_NEV, TS_NCV, TS_TOL = 6, 32, 1e-8  # phase 12a's c128 solve, two-sided
GHIEP_GRID = (95, 97)  # the small paths' grid (phases 2, 6, 8)
GHIEP_TOL = 1e-8
# a symmetric tridiagonal A against B = diag(-1, 1, -1, ...): the
# projection has complex pairs, so the GHIEP loop re-solves as GNHEP
PAIRS_N, PAIRS_NEV, PAIRS_NCV = 2000, 3, 16
# n = 8,192 transitions: H is 16,384 x 16,384 (R, C 0.5 GB each in f64,
# 1.07 GB in c128), a mid-size BSE whose dense truth fits the run's time
BSE_N = 8192
BSE_TOL = 1e-9


def dia_mult_h_slices(A, x):
    """A^H x by one slice update a diagonal (y[i + o] += conj(d[i]) x[i]):
    the plain version the adjoint DIA route is held against."""
    n = A.shape[0]
    y = torch.zeros_like(x)
    for k, off in enumerate(A.offsets):
        lo, hi = max(0, -off), min(n, n - off)
        if hi > lo:
            y[lo + off:hi + off] += A.diags[k, lo:hi].conj() * x[lo:hi]
    return y


def pairs_pencil(n, dev):
    """(A, B, B A as scipy CSR) of the complex-pairs pencil: A symmetric
    tridiagonal, diagonal linspace(-2, 2, n), couplings 0.2 N(0, 1) from
    default_rng(3); B = diag(-1, 1, -1, ...), so B^-1 A = B A."""
    rng = np.random.default_rng(3)
    lo = 0.2 * rng.standard_normal(n)
    lo[0] = 0.0
    d = np.stack([lo, np.linspace(-2.0, 2.0, n), np.roll(lo, -1)])
    om = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    A = stt.DIAOperator((-1, 0, 1), d, device=dev)
    B = stt.DIAOperator((0,), om[None], device=dev)
    As = sp.diags([lo[1:], d[1], lo[1:]], [-1, 0, 1])
    return A, B, (sp.diags(om) @ As).tocsr()


def spiral_dia(log2n, dev, dtype=torch.complex128):
    return stt.DIAOperator((-1, 0, 1), torch.from_numpy(
        spiral_diags(1 << log2n)).to(dev, dtype))


def phase14_kernels(dev):
    """Every kernel of phase 14 against its plain version at the shapes its
    paths give it, before the counts of phase 14 are reset (these launches
    are not its): K2c, K3c and K4c at 14a's (the 2^20 deployment, ncv 32);
    K2, K3 and K4 at 14b's (the 95 x 97 grid and the complex-pairs pencil,
    ncv 20 and 16; test18's 100 rows, ncv 20, dense) and K6 on its
    anti-identity; K3 / K3c and K4 / K4c at 14c's (Shao's f64 basis of
    8,192 rows and the projected variant's c128 one, rotated by a real Q on
    its real view, ncv 19; the complex variant's c128 basis of 16,384 rows,
    ncv 23); and the adjoint DIA route (DIAOperator.mult_h: one K2c / K2
    launch on the adjoint's diagonals) against the slice-update form on
    14a's deployment, in c128 (2^20 rows) and f64 (its real form, 2^21
    rows)."""
    f64, c128 = torch.float64, torch.complex128
    path_kernels(dev, "phase 14: K2c, K3c, K4c vs plain PyTorch at phase "
                 "14a's shapes", (("phase 14a, 2^20 complex rows",
                                   lambda: spiral_dia(NHEP_LOG2, dev),
                                   TS_NCV),), dtype=c128)
    path_kernels(dev, "phase 14: K2, K3, K4 vs plain PyTorch at phase 14b's "
                 "shapes", ((f"phase 14b, {GHIEP_GRID[0]}x{GHIEP_GRID[1]}",
                             lambda: stt.laplacian_2d(*GHIEP_GRID,
                                                      device=dev), 20),
                            (f"phase 14b complex pairs, {PAIRS_N} rows",
                             lambda: pairs_pencil(PAIRS_N, dev)[0],
                             PAIRS_NCV)))
    basis_kernels(dev, "phase 14: K3 / K3c, K4 / K4c vs plain PyTorch at the "
                  "dense paths' shapes (14b's test18, 14c's BSE)", (
                      ("phase 14b test18", 100, 20, f64, f64),
                      ("phase 14c Shao", BSE_N, 19, f64, f64),
                      ("phase 14c projected", BSE_N, 19, c128, f64),
                      ("phase 14c complex variant", 2 * BSE_N, 23, c128,
                       c128)))
    n = GHIEP_GRID[0] * GHIEP_GRID[1]
    B = stt.from_scipy(anti_identity(n), device=dev)
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(15),
                    dtype=f64, device=dev)
    y_ref = csr_spmv_ref(B.rowptr, B.cols, B.vals, x)
    y = csr_spmv(B.rowptr, B.cols, B.vals, x, n, plan=B.row_plan())
    rel = float((y - y_ref).abs().max() / y_ref.abs().max())
    print(f"  K6 on phase 14b's anti-identity (n={n}): err {rel:.3e}",
          flush=True)
    check(rel <= P13_TOL["K6"], f"phase 14 K6: {rel:.3e}")
    gen = torch.Generator(device=dev).manual_seed(14)
    for dt, make in ((torch.complex128, lambda: spiral_dia(NHEP_LOG2, dev)),
                     (torch.float64, lambda: spiral_operator(
                         NHEP_LOG2, torch.float64, dev))):
        A = make()
        x = torch.randn(A.shape[0], generator=gen, dtype=dt, device=dev)
        before = stt.launch_counts()
        y = A.mult_h(x)
        after = stt.launch_counts()
        launched_ = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
        ref = dia_mult_h_slices(A, x)
        rel = float((y - ref).abs().max() / ref.abs().max())
        ms = cuda_ms(lambda: A.mult_h(x))
        plain = cuda_ms(lambda: dia_mult_h_slices(A, x))
        print(f"  adjoint DIA route, {TAG[dt]} n={A.shape[0]:,} offsets "
              f"{A.offsets}: err {rel:.3e} launches {launched_} kernel "
              f"{ms:.4f} ms, slice updates {plain:.4f} ms", flush=True)
        key = "dia_spmv_" + TAG[dt]
        check(launched_ == {key: 1}, f"phase 14 mult_h {TAG[dt]}: launches "
              f"{launched_}")
        check(rel <= 1e-14, f"phase 14 mult_h {TAG[dt]}: error {rel:.3e}")
        del A, x, y, ref
    torch.cuda.empty_cache()


def two_sided_eps(A, tol=TS_TOL):
    eps = stt.EPS(A, problem_type="nhep", nev=TS_NEV, ncv=TS_NCV, tol=tol,
                  options=stt.Options())
    eps.set_two_sided()
    return eps


def sin_angle(y, y_ref):
    """sin of the angle between two vectors (numpy)."""
    y = y / np.linalg.norm(y)
    y_ref = y_ref / np.linalg.norm(y_ref)
    return float(np.linalg.norm(y - y_ref * np.vdot(y_ref, y)))


def phase14a(dev, lam_12a, run_12a):
    """Two-sided Krylov-Schur at full width: the reference's non-Hermitian
    deployment natively complex (2^20 rows, 3 complex diagonals, c128), nev
    6, ncv 32, tol 1e-8, which gives the left eigenvectors too.  Returns
    the launch counts of that solve (read from zero) and (wall, restarts,
    columns, coupling share)."""
    import scipy.linalg as sla

    n_c = 1 << NHEP_LOG2
    print(f"phase 14a: two-sided Krylov-Schur on the non-Hermitian "
          f"deployment: {n_c:,} rows, 3 complex diagonals, c128, nev "
          f"{TS_NEV}, ncv {TS_NCV}, tol {TS_TOL:g}", flush=True)
    # the build check at 2^10 rows against dense left and right vectors,
    # before the counts are reset: its launches are not the main path's
    small = spiral_diags(1 << 10)
    Ad = sp.diags([small[0, 1:], small[1], small[2, :-1]],
                  [-1, 0, 1]).toarray()
    w, VL = sla.eig(Ad, left=True, right=False)
    eps = two_sided_eps(stt.DIAOperator((-1, 0, 1), torch.from_numpy(
        small).to(dev)))
    eps.solve()
    check(eps.nconv >= TS_NEV, f"phase 14a 2^10: nconv {eps.nconv}")
    rel = ang = 0.0
    for i in range(TS_NEV):
        lam = complex(eps.eigenvalues[i])
        j = int(np.argmin(np.abs(w - lam)))
        rel = max(rel, abs(w[j] - lam) / abs(lam))
        ang = max(ang, sin_angle(eps.get_left_eigenvector(i).cpu().numpy(),
                                 VL[:, j]))
    print(f"  build check, 2^10 rows: nconv={eps.nconv} its={eps.its} max "
          f"rel |lam - eig| = {rel:.3e}, max sin(left vector, "
          f"scipy.linalg.eig(left=True)) = {ang:.3e}", flush=True)
    check(rel <= 1e-9, f"phase 14a 2^10: eigenvalues off by {rel:.3e}")
    check(ang <= 1e-8, f"phase 14a 2^10: a left vector off by {ang:.3e}")
    del eps
    A = spiral_dia(NHEP_LOG2, dev)
    eps = two_sided_eps(A)
    stt.reset_launch_counts()
    wall, peak = timed_solve(dev, eps)
    delta = stt.launch_counts()
    k, cols = eps.nconv, eps.expansions
    lam = np.asarray(eps.eigenvalues[:k])
    right = np.array([eps.compute_error(i) for i in range(k)])  # K2c
    left = []
    for i in range(k):  # the adjoint DIA route (K2c)
        y = eps.get_left_eigenvector(i)
        r = A.mult_h(y) - complex(lam[i]).conjugate() * y
        left.append(float(torch.linalg.vector_norm(r))
                    / (abs(lam[i]) * float(torch.linalg.vector_norm(y))))
    left = np.array(left)
    X = eps._eigenvectors[:k]
    Y = eps._left_eigenvectors[:k]
    G = (Y.conj() @ X.mT).abs().cpu().numpy() / np.outer(
        torch.linalg.vector_norm(Y, dim=1).cpu().numpy(),
        torch.linalg.vector_norm(X, dim=1).cpu().numpy())
    biorth = float(np.max(G - np.diag(np.diag(G))))
    # Biorthogonality bound: with r = A x_j - lam_j x_j and s = A^H y_i -
    # conj(lam_i) y_i, y_i^H A x_j = lam_j y_i^H x_j + y_i^H r =
    # lam_i y_i^H x_j + s^H x_j, so |y_i^H x_j| / (|y_i| |x_j|) <=
    # (|r| / |x_j| + |s| / |y_i|) / |lam_i - lam_j| <= 2 tol max|lam| /
    # min gap, with both residuals gated at tol relative to |lam| below
    gap = min(abs(lam[i] - lam[j]) for i in range(k) for j in range(k)
              if i != j)
    bound = 2 * TS_TOL * float(np.abs(lam).max()) / gap
    fam = family_counts(delta, "c128")
    share = eps.coupling_seconds / wall
    print(f"  two-sided c128: nconv={k} restarts={eps.its} columns={cols} "
          f"(a side) wall={wall:.3f} s ({wall / max(cols, 1) * 1e3:.3f} ms "
          f"per column) coupling {eps.coupling_seconds:.3f} s "
          f"({share * 100:.1f}% of the wall) peak_mem={peak:.2f} GB "
          f"launches={fam}; phase 12a's one-sided c128: {run_12a[0]:.3f} s, "
          f"{run_12a[1]} restarts, {run_12a[2]} columns", flush=True)
    far = max(float(np.min(np.abs(lam_12a - v))) / abs(v) for v in lam[:TS_NEV])
    print(f"  two-sided c128: max right rel resid={right.max():.3e} max left "
          f"rel resid={left.max():.3e} max rel distance to phase 12a's "
          f"values {far:.3e} max |y_i^H x_j| / (|y_i| |x_j|), i != j: "
          f"{biorth:.3e} (bound 2 tol max|lam| / min gap = {bound:.3e}, gap "
          f"{gap:.3f}) lam={np.array2string(lam[:TS_NEV], precision=6)}",
          flush=True)
    check(k >= TS_NEV, f"phase 14a: nconv {k} < {TS_NEV}")
    check(right.max() <= TS_TOL, f"phase 14a: right residual {right.max():.3e}")
    check(left.max() <= TS_TOL, f"phase 14a: left residual {left.max():.3e}")
    check(far <= 1e-10, f"phase 14a: a value {far:.3e} from phase 12a's")
    check(biorth <= bound, f"phase 14a: biorthogonality {biorth:.3e} > "
          f"{bound:.3e}")
    check(delta["dia_spmv_c128"] >= 2 * cols,
          f"phase 14a: K2c launched {delta['dia_spmv_c128']} times for "
          f"{cols} columns a side")
    launched("phase 14a", delta, ("panel_dots_c128", "panel_update_c128",
                                  "rotate_c128"))
    its = eps.its
    del eps, A, X, Y
    torch.cuda.empty_cache()
    return delta, (wall, its, cols, share)


def test18_matrices(m=10):
    """The reference's test18.c pencil: the unscaled 5-point Laplacian of an
    m x m grid and the anti-identity B (B[i, N-1-i] = 1)."""
    Ad = stt.laplacian_2d(m, m, device="cpu").to_dense().numpy()
    return Ad, np.fliplr(np.eye(m * m))


def anti_identity(n):
    return sp.csr_matrix((np.ones(n), (np.arange(n), np.arange(n)[::-1])),
                         shape=(n, n))


def phase14b(dev):
    """GHIEP: the reference's test18 pencil (dense, target 0, nev 4, ncv
    20) against its published digits, and the same pencil on the small
    paths' grid 95 x 97 (A DIA on K2, B the anti-identity as CSR on K6),
    host-factorized STSinvert at target 0, nev 4, ncv 20, tol 1e-8, true
    residual, against ARPACK on A^-1 B; then the complex-pairs pencil,
    which re-solves as GNHEP (``pairs_case``).  Returns the launch counts
    of the solves (read from zero) and the walls."""
    import scipy.sparse.linalg as spla

    print("phase 14b: GHIEP (pseudo-Lanczos): test18, the 95 x 97 "
          "Laplacian against the anti-identity, and a pencil with complex "
          "pairs", flush=True)
    stt.reset_launch_counts()
    Ad, Bd = test18_matrices()
    eps = stt.EPS(stt.DenseOperator(Ad, device=dev),
                  stt.DenseOperator(Bd, device=dev), problem_type="ghiep",
                  nev=4, ncv=20, options=stt.Options())
    eps.set_target(0.0)
    wall18, _ = timed_solve(dev, eps)
    got = np.sort(np.round(np.real(eps.eigenvalues[:4]), 5))
    want = np.sort([0.16203, -0.39851, -0.39851, 0.63499])
    print(f"  test18: nconv={eps.nconv} its={eps.its} wall={wall18:.3f} s "
          f"GNHEP re-solve: {eps.gnhep_resolve} values {got}", flush=True)
    check(eps.nconv >= 4 and np.abs(got - want).max() <= 1.1e-5,
          f"phase 14b test18: {got} against {want}")
    nx, ny = GHIEP_GRID
    n = nx * ny
    A = stt.laplacian_2d(nx, ny, device=dev)
    Bs = anti_identity(n)
    B = stt.from_scipy(Bs, device=dev)
    check(type(B).__name__ == "AIJOperator", f"phase 14b: B is {type(B)}")
    eps = stt.EPS(A, B, problem_type="ghiep", nev=4, ncv=20, tol=GHIEP_TOL,
                  options=stt.Options())
    eps.set_target(0.0)
    eps.set_true_residual()
    before = stt.launch_counts()
    wall, peak = timed_solve(dev, eps)
    after = stt.launch_counts()
    path = dict(after)
    delta = {k: after[k] - before[k] for k in after}
    lu = spla.splu(A.to_scipy().tocsc())
    mu = spla.eigs(spla.LinearOperator((n, n), matvec=lambda x: lu.solve(
        Bs @ x), dtype=float), k=4, which="LM", return_eigenvectors=False)
    ref = np.sort_complex(1.0 / mu)
    k = eps.nconv
    lam = np.asarray(eps.eigenvalues[:k])
    resid = np.array([eps.compute_error(i) for i in range(k)])  # K2, K6
    rel = max(float(np.min(np.abs(ref - v))) / abs(v) for v in lam[:4])
    print(f"  {nx}x{ny} ({n:,} rows): nconv={k} its={eps.its} wall="
          f"{wall:.3f} s peak_mem={peak:.2f} GB GNHEP re-solve: "
          f"{eps.gnhep_resolve} backend {eps.st.ksp._direct.backend} "
          f"launches { {k: v for k, v in delta.items() if v} }", flush=True)
    print(f"  {nx}x{ny}: lam={np.array2string(np.real(lam[:4]), precision=9)}"
          f" max true rel resid={resid.max():.3e} max rel |lam - ARPACK|="
          f"{rel:.3e}", flush=True)
    check(k >= 4, f"phase 14b {nx}x{ny}: nconv {k}")
    check(resid.max() <= GHIEP_TOL, f"phase 14b: residual {resid.max():.3e}")
    check(rel <= 1e-9, f"phase 14b: values {rel:.3e} from ARPACK")
    launched("phase 14b", delta, ("dia_spmv_f64", "csr_spmv_f64",
                                  "panel_dots_f64", "panel_update_f64",
                                  "rotate_f64"))
    del eps, A, B
    torch.cuda.empty_cache()
    wall_pairs, pairs = pairs_case(dev)
    path = {k: v + pairs[k] for k, v in path.items()}
    return path, {"test18": wall18, f"{nx}x{ny}": wall,
                  f"complex pairs {PAIRS_N}": wall_pairs}


def pairs_case(dev):
    """The GNHEP re-solve on the card: the complex-pairs pencil (A and B
    DIA on K2), largest real, nev 3, ncv 16, against the same solve on the
    host's CPU (values to 1e-9 relative) and ARPACK on B A (to tol).
    Returns the wall and the solve's launch counts (read from zero)."""
    import scipy.sparse.linalg as spla

    def make(where):
        A, B, BA = pairs_pencil(PAIRS_N, where)
        return stt.EPS(A, B, problem_type="ghiep", nev=PAIRS_NEV,
                       ncv=PAIRS_NCV, which="largest_real", tol=GHIEP_TOL,
                       options=stt.Options()), BA

    eps, BA = make(dev)
    stt.reset_launch_counts()
    wall, _ = timed_solve(dev, eps)
    counts = stt.launch_counts()
    host, _ = make("cpu")
    host.solve()
    k = eps.nconv
    lam = np.sort_complex(np.asarray(eps.eigenvalues[:PAIRS_NEV], complex))
    lam_h = np.sort_complex(np.asarray(host.eigenvalues[:PAIRS_NEV], complex))
    mu = np.sort_complex(spla.eigs(BA, k=PAIRS_NEV, which="LR", tol=1e-13,
                                   return_eigenvectors=False))
    resid = np.array([eps.compute_error(i) for i in range(k)])  # K2
    rel_h = float(np.max(np.abs(lam - lam_h) / np.abs(lam_h)))
    rel_a = float(np.max(np.abs(lam - mu) / np.abs(mu)))
    print(f"  complex pairs, {PAIRS_N} rows: nconv={k} its={eps.its} (CPU: "
          f"{host.nconv}, {host.its}) wall={wall:.3f} s GNHEP re-solve: "
          f"{eps.gnhep_resolve} (CPU: {host.gnhep_resolve}) lam="
          f"{np.array2string(lam.real, precision=9)} max rel resid="
          f"{resid.max():.3e} max rel |lam - CPU| = {rel_h:.3e}, |lam - "
          f"ARPACK| = {rel_a:.3e} launches "
          f"{ {key: v for key, v in counts.items() if v} }", flush=True)
    check(eps.gnhep_resolve and host.gnhep_resolve,
          "phase 14b complex pairs: the GNHEP re-solve did not run")
    check(k >= PAIRS_NEV and host.nconv >= PAIRS_NEV,
          f"phase 14b complex pairs: nconv {k} (CPU {host.nconv})")
    check(resid.max() <= GHIEP_TOL,
          f"phase 14b complex pairs: residual {resid.max():.3e}")
    check(rel_h <= 1e-9, f"phase 14b complex pairs: {rel_h:.3e} from the CPU")
    check(rel_a <= GHIEP_TOL,
          f"phase 14b complex pairs: {rel_a:.3e} from ARPACK")
    launched("phase 14b complex pairs", counts, (
        "dia_spmv_f64", "panel_dots_f64", "panel_update_f64", "rotate_f64"))
    del eps, host
    return wall, counts


def bse_blocks(n, complex_, dev):
    """R Hermitian (+ 2n I) and C (complex) symmetric by the reference's
    recipe (tests/test_round4.py:191-205, default_rng(3)), on the card."""
    rng = np.random.default_rng(3)

    def draw():
        M = rng.standard_normal((n, n))
        if complex_:
            M = M + 1j * rng.standard_normal((n, n))
        return torch.from_numpy(M).to(dev)

    R = draw()
    R = 0.5 * (R + R.mH)
    R.diagonal().add_(2 * n)
    C = draw()
    return R, 0.5 * (C + C.mT)


def bse_truth(R, C, k=4):
    """The k smallest positive eigenvalues of H = [R C; -conj(C) -conj(R)],
    computed on the card: real, lambda^2 = eigvalsh(L^T (R - C) L) with R +
    C = L L^T; complex, the positive eigenvalues of eigvalsh(L^H J L) with
    M = [R C; conj(C) conj(R)] = L L^H, J = diag(I, -I)."""
    if not R.is_complex():
        L = torch.linalg.cholesky(R + C)
        return torch.linalg.eigvalsh(L.mT @ (R - C) @ L)[:k].sqrt() \
            .cpu().numpy()
    n = R.shape[0]
    L = torch.linalg.cholesky(torch.cat([torch.cat([R, C], 1),
                                         torch.cat([C.conj(), R.conj()], 1)]))
    JL = L.clone()
    JL[n:] *= -1
    T = L.mH @ JL
    del L, JL
    ev = torch.linalg.eigvalsh(T).cpu().numpy()
    return np.sort(ev[ev > 0])[:k]


def phase14c(dev):
    """BSE at n = 8,192 (H is 16,384 x 16,384), R and C dense on the card:
    Shao (real, auto) and projected (real), the complex definite variant
    (auto, smallest), each nev 4 at tol 1e-9, against the truth computed
    on the card.  Returns the launch counts of the three solves (each read
    from zero) and the walls."""
    n = BSE_N
    print(f"phase 14c: BSE at n = {n:,} (H {2 * n:,} x {2 * n:,}), dense R, "
          f"C on the card, nev 4, tol {BSE_TOL:g}", flush=True)
    walls, path = {}, {}
    for complex_, variants in ((False, ("auto", "projected")),
                               (True, ("auto",))):
        t0 = time.perf_counter()
        R, C = bse_blocks(n, complex_, dev)
        sync(dev)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        truth = bse_truth(R, C)
        t_truth = time.perf_counter() - t0
        H = stt.create_bse(stt.DenseOperator(R), stt.DenseOperator(C))
        tag = TAG[R.dtype]
        print(f"  {tag}: blocks built in {t_build:.3f} s, truth "
              f"(Cholesky + eigvalsh on the card) in {t_truth:.3f} s: "
              f"{np.array2string(truth, precision=10)}", flush=True)
        for variant in variants:
            where = f"phase 14c {tag} {variant}"
            eps = stt.EPS(H, problem_type="bse", nev=4, tol=BSE_TOL,
                          options=stt.Options())
            eps.bse_variant = variant
            stt.reset_launch_counts()
            wall, peak = timed_solve(dev, eps)
            delta = stt.launch_counts()
            path = {k: path.get(k, 0) + v for k, v in delta.items()}
            k = eps.nconv
            lam = np.asarray(eps.eigenvalues[:k], dtype=float)
            Z = eps._eigenvectors[:k]
            resid = np.array([float(torch.linalg.vector_norm(
                H.mult(Z[i]) - lam[i] * Z[i])) / (abs(lam[i]) * float(
                    torch.linalg.vector_norm(Z[i]))) for i in range(k)])
            rel = float(np.max(np.abs(np.sort(lam)[:4] - truth) / truth)) \
                if k >= 4 else np.inf
            walls[f"{tag} {variant}"] = wall
            print(f"  {where}: nconv={k} its={eps.its} wall={wall:.3f} s "
                  f"peak_mem={peak:.2f} GB max rel |lam - truth|={rel:.3e} "
                  f"max rel resid={resid.max() if k else np.inf:.3e} "
                  f"launches { {k: v for k, v in delta.items() if v} }",
                  flush=True)
            check(k >= 4, f"{where}: nconv {k}")
            check(resid.max() <= BSE_TOL, f"{where}: residual "
                  f"{resid.max():.3e}")
            check(rel <= 1e-8, f"{where}: values {rel:.3e} from the truth")
            rot = "rotate_" + ("c128" if complex_ else "f64")
            dots = "panel_dots_" + ("c128" if complex_ or variant ==
                                    "projected" else "f64")
            launched(where, delta, (dots, rot))
            del eps, Z
        del H, R, C
        torch.cuda.empty_cache()
    return path, walls


# ---- item 11a-iii: K5c and the complex blocked cycle (phase 1, 12d) ------

def phase1_k5c(dev, table):
    """K5c (c128, c64) at b = 4 on the gauge-transformed flagship, against
    its plain version, beside the route it replaces (four K2c / K1c
    launches, one a row) and the library's complex CSR product with the
    (n, 4) block."""
    print("phase 1: K5c (complex block DIA SpMM) vs plain PyTorch on the "
          "gauge-transformed flagship at b = 4, beside four K2c / K1c calls "
          "and cuSPARSE's complex CSR product with the (n, 4) block",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(13)
    lap = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    n, b = lap.shape[0], 4
    for dt, tol in ((torch.complex128, 1e-14), (torch.complex64, 2e-6)):
        G = gauge_dia(lap, dt)
        nd = len(G.offsets)
        V = torch.randn((b + 8, n), generator=gen, dtype=dt, device=dev)
        X = V[3:3 + b]  # a slice of a taller basis, as the cycle hands it
        plan = plan_spmm(G.offsets, n, b, dt)
        Y = dia_spmm(G.offsets, G.diags, X)
        Y_ref = dia_spmm_ref(G.offsets, G.diags, X)
        err = float((Y - Y_ref).abs().max())
        rel = err / float(Y_ref.abs().max())
        ms = cuda_ms(lambda: dia_spmm(G.offsets, G.diags, X))
        plain = cuda_ms(lambda: dia_spmm_ref(G.offsets, G.diags, X))
        rows = cuda_ms(lambda: [dia_spmv(G.offsets, G.diags, X[m])
                                for m in range(b)])
        S = dia_as_torch_csr(G)
        lib, what = library_sparse_ms(S, X.T.contiguous(), Y.T)
        elt = X.element_size()
        name = f"dia_spmm_{TAG[dt]}"
        print(f"  {TAG[dt]}: tile {plan.tile}, halo {plan.halo}, diagonals "
              f"(d direct, n near) {''.join('dn'[w] for w in plan.where)}, "
              f"{plan.smem} bytes staged a block; the route it replaces, "
              f"{b} K{'2c' if dt == torch.complex128 else '1c'} calls: "
              f"{rows:.4f} ms ({b * (nd + 2) * n * elt / 1e9:.3f} GB)",
              flush=True)
        record(table, name, err, rel, tol, ms, plain, (nd + 2 * b) * n * elt,
               8 * G.nnz * b, dt, lib, what)
        del G, V, X, Y, Y_ref, S
        torch.cuda.empty_cache()
    del lap


def block_errors(dev, gen, A, ncv, b):
    """Worst relative errors (K5c, K3c, K4c) of the blocked cycle's kernels
    against their plain versions at its shapes: K5c on b rows of a taller
    basis, K3c's three sweeps at panel width b against b, ncv and ncv + b
    rows, K4c at (b, b) (SVQB's factors) and (ncv, ncv) (the restart)."""
    dt, n = A.diags.dtype, A.shape[0]
    V = torch.randn((ncv + b, n), generator=gen, dtype=dt, device=dev)
    X = V[2:2 + b]
    ref = dia_spmm_ref(A.offsets, A.diags, X)
    k5 = float((dia_spmm(A.offsets, A.diags, X) - ref).abs().max()
               / ref.abs().max())
    W = torch.randn((b, n), generator=gen, dtype=dt, device=dev)
    C = torch.randn((ncv + b, b), generator=gen, dtype=dt, device=dev)
    k3 = max(rel for K in (b, ncv, ncv + b)
             for _, rel in panel_errors(V[:K], W, C[:K]).values())
    k4 = max(rotate_errors(random_q(K, K, dev, dt), V[:K])[1]
             for K in (b, ncv))
    return k5, k3, k4


def blocked_kernels(dev, title, cases):
    """``block_errors`` for each (where, operator, ncv, b) of ``cases``,
    gated at phase 1's tolerances (K5c at its SpMV's); run before the
    paths' launch counts are reset."""
    print(title, flush=True)
    gen = torch.Generator(device=dev).manual_seed(14)
    for where, A, ncv, b in cases:
        dt = A.diags.dtype
        spmv, k3, k4 = PATH_TOL[dt]
        tol = {"K5c": PATH_TOL[dt][spmv], k3: PATH_TOL[dt][k3],
               k4: PATH_TOL[dt][k4]}
        worst = dict(zip(tol, block_errors(dev, gen, A, ncv, b)))
        print(f"  {where}: n={A.shape[0]} ncv={ncv} b={b} {TAG[dt]}  "
              + "  ".join(f"{k} {v:.3e}" for k, v in worst.items()),
              flush=True)
        for k, v in worst.items():
            check(v <= tol[k], f"{where}: {k} error {v:.3e} > {tol[k]:g}")
    torch.cuda.empty_cache()


def blocked_family(counts, tag):
    return {"K5c": counts[f"dia_spmm_{tag}"],
            "K3c": min(counts[f"panel_dots_{tag}"],
                       counts[f"panel_update_{tag}"],
                       counts[f"panel_update_dots_{tag}"]),
            "K4c": counts[f"rotate_{tag}"]}


def phase12d(dev):
    """The complex blocked cycle (item 11a-iii): three restarts at full
    width, the small certified solves, cheb_block on a complex operator and
    the complex device shift-and-invert's refusal.  Returns (launch counts
    of its solves and restarts, read from zero after its kernel checks; ms
    a column of the full-width cycle)."""
    ncv, b, restarts = 48, 4, 3
    lap = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
    G = gauge_dia(lap, torch.complex128)
    del lap
    L = stt.laplacian_2d(95, 97, device=dev)
    small = {dt: gauge_dia(L, dt) for dt in (torch.complex128,
                                             torch.complex64)}
    blocked_kernels(dev, "phase 12d: K5c, K3c, K4c vs plain PyTorch at the "
                    "blocked cycle's shapes", (
                        ("phase 12d, gauge-transformed flagship", G, ncv, b),
                        ("phase 12d, 95x97 c128", small[torch.complex128],
                         28, b),
                        ("phase 12d, 95x97 c64", small[torch.complex64],
                         28, b)))
    print(f"phase 12d: the complex blocked cycle at full width: the "
          f"gauge-transformed 200x225x230 Laplacian (c128, 10.35M rows), "
          f"EPS(block_size={b}, ncv={ncv}, largest_real), {restarts} "
          f"restarts", flush=True)
    stt.reset_launch_counts()
    cycles = []
    torch.cuda.reset_peak_memory_stats(dev)
    eps, wall = plain_solve(G, ncv, restarts, cycles, block_size=b)
    peak = torch.cuda.max_memory_allocated(dev)
    delta = stt.launch_counts()
    fam = blocked_family(delta, "c128")
    marks = [{k: 0 for k in delta}] + [c[3] for c in cycles]
    cols = [b * (m1["dia_spmm_c128"] - m0["dia_spmm_c128"])
            for m0, m1 in zip(marks, marks[1:])]
    later = sum(cols[1:])
    later_ms = (cycles[-1][2] - cycles[0][2]) * 1e3
    ms_col = later_ms / max(later, 1)
    theta = cycles[-1][1]
    print(f"  nconv={eps.nconv} (not required) restarts={eps.its} wall="
          f"{wall:.3f} s columns={sum(cols)} peak_mem={peak / 1e9:.2f} GB "
          f"launches={fam} (K2c {delta['dia_spmv_c128']}); restarts "
          f"2..{len(cycles)}: {later} columns in {later_ms:.1f} ms = "
          f"{ms_col:.3f} ms per column", flush=True)
    check(len(cycles) > 1, "phase 12d: no restarted cycle ran")
    check(theta.min() >= 0.0 and theta.max() <= 12.0,
          f"phase 12d: Ritz values outside [0, 12]: {theta.min()}, "
          f"{theta.max()}")
    check(all(v > 0 for v in fam.values()),
          f"phase 12d: a kernel did not launch: {fam}")
    check(delta["dia_spmv_c128"] == 0,
          f"phase 12d: {delta['dia_spmv_c128']} single-row SpMVs: the block "
          f"did not go to K5c")
    del eps
    torch.cuda.empty_cache()
    # the basis gate, on a basis held here: rows [0, kl + b) after a restart
    gen = torch.Generator(device=dev).manual_seed(9)
    V = torch.zeros((ncv + b, G.shape[0]), dtype=torch.complex128, device=dev)
    R = torch.randn((G.shape[0], b), generator=gen, dtype=torch.complex128,
                    device=dev)
    V[:b] = torch.linalg.qr(R).Q.T  # an orthonormal start block
    del R
    H, jb = np.zeros((ncv + b, ncv), complex), 0
    for _ in range(restarts):
        V, H, jb = ks_hep_cycle_blocked(G, V, H, jb, 1e-8, gen, ncv=ncv, b=b,
                                        which="largest")[:3]
    Bk = V[: jb * b + b]
    orth = float((Bk.conj() @ Bk.T - torch.eye(
        jb * b + b, dtype=Bk.dtype, device=dev)).abs().max())
    print(f"  {restarts} restarts through ks_hep_cycle_blocked: kept basis "
          f"rows {jb * b + b}, max|V V^H - I| = {orth:.3e}", flush=True)
    check(orth <= 1e-12, f"phase 12d: basis not orthonormal: {orth:.3e}")
    del V, Bk, G
    torch.cuda.empty_cache()

    print(f"phase 12d: the gauge-transformed laplacian_2d(95, 97), "
          f"EPS(block_size={b}, ncv 28, nev 6, smallest), c128 at tol 1e-9 "
          f"and c64 at tol 1e-5; cheb_block = 4 on it (the plain cycle); the "
          f"complex STSinvertDevice refused", flush=True)
    exact = stt.laplacian_2d_eigs(95, 97, k=6)

    def solve(A, tol, **kw):
        eps = stt.EPS(A, problem_type="hep", which="smallest_real", nev=6,
                      ncv=28, tol=tol, max_it=3000, options=stt.Options())
        for k, v in kw.items():
            setattr(eps, k, v)
        before = stt.launch_counts()
        t0 = time.perf_counter()
        eps.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = stt.launch_counts()
        return eps, wall, {k: after[k] - before[k] for k in after}

    for dt, tol in ((torch.complex128, 1e-9), (torch.complex64, 1e-5)):
        eps, wall, d = solve(small[dt], tol, block_size=b)
        k = min(eps.nconv, 6)
        lam = np.sort(np.asarray(eps.eigenvalues[:k], np.float64))
        err = np.abs(lam - exact[:k]) if k else np.array([np.inf])
        where = f"phase 12d 95x97 blocked {TAG[dt]} (tol {tol:.0e})"
        fam = blocked_family(d, TAG[dt])
        print(f"  {where}: nconv={eps.nconv} its={eps.its} wall={wall:.3f} s "
              f"max|lam-exact|={err.max():.3e} launches={fam}", flush=True)
        check(eps.nconv >= 6, f"{where}: nconv {eps.nconv} < 6")
        if dt == torch.complex128:
            check(err.max() <= 1e-9, f"{where}: |lam - exact| {err.max():.3e}")
        else:
            check(np.max(err / exact) <= 1e-4,
                  f"{where}: relative error {np.max(err / exact):.3e}")
        check(all(v > 0 for v in fam.values()),
              f"{where}: a kernel did not launch: {fam}")
    A = small[torch.complex128]
    ref, wall1, _ = solve(A, 1e-9, cheb_degree=20)
    eps, wall4, d = solve(A, 1e-9, cheb_degree=20, cheb_block=4)
    print(f"  cheb_block = 4, degree 20, c128: nconv={eps.nconv} its={eps.its} "
          f"wall={wall4:.3f} s (cheb_block = 1: its={ref.its}, {wall1:.3f} s) "
          f"cheb_stats={eps.cheb_stats} K5c {d['dia_spmm_c128']} K2c "
          f"{d['dia_spmv_c128']}", flush=True)
    check(eps.cheb_stats is None and ref.cheb_stats is None
          and d["dia_spmm_c128"] == 0,
          "phase 12d: the Chebyshev-amplified path ran on a complex operator")
    check(eps.nconv >= 6 and np.array_equal(eps.eigenvalues, ref.eigenvalues)
          and eps.its == ref.its,
          "phase 12d: cheb_block = 4 differs from the plain cycle")
    eps = stt.EPS(A, problem_type="hep", nev=6, options=stt.Options())
    eps.set_target(0.0)
    eps.set_st(stt.STSinvertDevice([A], sigma=0.0, iters=50))
    before = stt.launch_counts()
    try:
        eps.solve()
        refused = False
    except NotImplementedError as exc:
        refused = "no complex device shift-and-invert" in str(exc)
        print(f"  STSinvertDevice on c128: refused ({exc})", flush=True)
    check(refused and stt.launch_counts() == before,
          "phase 12d: the complex STSinvertDevice did not refuse cleanly")
    return stt.launch_counts(), ms_col


# ---- item 12: SVD (phase 15) ---------------------------------------------

SVD_GRID = (100, 102, 104)  # phase 7's grid: 1,060,800 unknowns
SVD_NSV, SVD_NCV, SVD_TOL = 10, 32, 1e-8


def gradient_3d(nx, ny, nz, phases=None):
    """The discrete gradient G = [I (x) I (x) D_x; I (x) D_y (x) I; D_z (x)
    I (x) I] of an nx x ny x nz grid, D_d the (n_d + 1) x n_d difference
    matrix with Dirichlet boundary edges, unknowns x fastest (as
    laplacian_3d orders them), so G^T G is the 7-point Laplacian; a host
    scipy CSR matrix.  ``phases``: G U^H with U = diag(e^{i phi}), so G^H G
    is the gauge-transformed Laplacian (same singular values)."""
    def D(k):
        return sp.diags([np.ones(k), -np.ones(k)], [0, -1], shape=(k + 1, k))

    def eye(k):
        return sp.identity(k, format="csr")

    G = sp.vstack([sp.kron(eye(nz), sp.kron(eye(ny), D(nx))),
                   sp.kron(eye(nz), sp.kron(D(ny), eye(nx))),
                   sp.kron(D(nz), sp.kron(eye(ny), eye(nx)))]).tocsr()
    if phases is not None:
        G = (G @ sp.diags(np.exp(-1j * phases))).tocsr()
    return G


def csr_both_errors(op, gen):
    """Relative errors of K6 / K6c for op x and op^H y against the plain
    version on the same CSR arrays (op^H's CSR built by the first
    mult_h)."""
    x = torch.randn(op.shape[1], generator=gen, dtype=op.dtype, device=op.device)
    y = torch.randn(op.shape[0], generator=gen, dtype=op.dtype, device=op.device)
    out = []
    for A, v, apply in ((op, x, op.mult), (None, y, op.mult_h)):
        got = apply(v)
        A = A or op._adjoint
        ref = csr_spmv_ref(A.rowptr, A.cols, A.vals, v)
        out.append(float((got - ref).abs().max() / ref.abs().max()))
    return out


def svd_gates(where, svd, exact, walls):
    """nconv, the values against the closed form (1e-9 sigma_1), the
    residuals (K6) and the bases' orthonormality."""
    k = SVD_NSV
    check(svd.nconv >= k, f"{where}: nconv {svd.nconv} < {k}")
    err = np.abs(svd.sigma[:k] - exact[:k]).max() / exact[0]
    t0 = time.perf_counter()
    resid = max(svd.compute_error(i) for i in range(k))
    Vk, Uk = svd.V[:, :k], svd.U[:, :k]
    ov = np.abs(Vk.conj().T @ Vk - np.eye(k)).max()
    ou = np.abs(Uk.conj().T @ Uk - np.eye(k)).max()
    print(f"  {where}: nconv={svd.nconv} its={svd.its} GK steps="
          f"{getattr(svd, 'gk_steps', '-')} wall={walls:.3f} s "
          f"max|sigma - exact|/sigma_1={err:.3e} max compute_error="
          f"{resid:.3e} ({time.perf_counter() - t0:.2f} s) |V^H V - I|="
          f"{ov:.3e} |U^H U - I|={ou:.3e}", flush=True)
    check(err <= 1e-9, f"{where}: sigma off the closed form by {err:.3e}")
    check(resid <= 10 * SVD_TOL, f"{where}: compute_error {resid:.3e}")
    check(ov <= 1e-10, f"{where}: V not orthonormal: {ov:.3e}")
    check(ou <= 1e-8, f"{where}: U not orthonormal: {ou:.3e}")


def svd_solve(op, solver, svd=None):
    """Phase 15's SVD of op (``svd``, or a new one with its settings)
    solved; returns the wall of the synchronized solve."""
    if svd is None:
        svd = stt.SVD(op, nsv=SVD_NSV, ncv=SVD_NCV, solver=solver,
                      tol=SVD_TOL)
    t0 = time.perf_counter()
    svd.solve()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase15_full(dev, G_host, exact):
    """SVD at full width: trlanczos and cross on the 3-D gradient (K6 for G
    and G^H).  Returns (launch counts read from zero, walls)."""
    op = stt.from_scipy(G_host, device=dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    e = csr_both_errors(op, gen)
    x = torch.randn(op.shape[1], generator=gen, dtype=op.dtype, device=dev)
    u = torch.randn(op.shape[0], generator=gen, dtype=op.dtype, device=dev)
    ms_g, ms_h = cuda_ms(lambda: op.mult(x)), cuda_ms(lambda: op.mult_h(u))
    S = torch.sparse_csr_tensor(op.rowptr, op.cols.to(torch.int64), op.vals,
                                size=op.shape)
    lib_g = cuda_ms(lambda: S @ x)
    nb = op.nnz * 12 + (op.shape[0] + 1) * 8 + 8 * sum(op.shape)
    print(f"phase 15: K6 on G ({op.shape[0]} x {op.shape[1]}, nnz {op.nnz}) "
          f"and on G^H: errors {e[0]:.3e} / {e[1]:.3e}; {ms_g:.4f} / "
          f"{ms_h:.4f} ms (bound {nb / PEAK_BYTES * 1e3:.4f} ms each); "
          f"cuSPARSE G x {lib_g:.4f} ms", flush=True)
    for v in e:
        check(v <= 1e-13, f"phase 15: K6 error {v:.3e} at G's shapes")
    del S
    k3m, k4m = basis_errors(dev, gen, u, SVD_NCV)
    k3n, k4n = basis_errors(dev, gen, x, SVD_NCV)
    print(f"  K3 / K4 at U's rows ({op.shape[0]}, ncv {SVD_NCV}): {k3m:.3e} / "
          f"{k4m:.3e}; at V's ({op.shape[1]}): {k3n:.3e} / {k4n:.3e}",
          flush=True)
    check(max(k3m, k3n) <= PATH_TOL[torch.float64]["K3"]
          and max(k4m, k4n) <= PATH_TOL[torch.float64]["K4"],
          "phase 15: K3 / K4 error at the SVD's shapes")
    del x, u
    torch.cuda.empty_cache()
    stt.reset_launch_counts()
    walls = {}
    for solver in ("trlanczos", "cross"):
        print(f"phase 15: SVD(G, nsv={SVD_NSV}, ncv={SVD_NCV}, "
              f"solver={solver!r}, tol={SVD_TOL:g}), largest", flush=True)
        before = stt.launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        svd = stt.SVD(op, nsv=SVD_NSV, ncv=SVD_NCV, solver=solver,
                      tol=SVD_TOL)
        walls[solver] = svd_solve(op, solver, svd)
        peak = torch.cuda.max_memory_allocated(dev)
        after = stt.launch_counts()
        fam = family_counts({k: after[k] - before[k] for k in after}, "f64",
                            "csr_spmv")
        print(f"  launches {fam} (K6 counts G and G^H), peak_mem "
              f"{peak / 1e9:.2f} GB", flush=True)
        check(all(v > 0 for v in fam.values()),
              f"phase 15 {solver}: a kernel did not launch: {fam}")
        svd_gates(f"phase 15 {solver}", svd, exact, walls[solver])
        del svd
        torch.cuda.empty_cache()
    return stt.launch_counts(), walls


def svd_small_cases():
    """The small SVD paths' host matrices, by the recipes of
    tests/test_modules.py:17-35 (120 x 80; with spectral decay for the
    randomized sketch), tests/test_modules_advanced.py:80-112 (the GSVD
    pair, the HSVD matrix and signature) and
    tests/test_reference_golden.py:56-75 (Grcar, n = 30)."""
    rng = np.random.default_rng(0)
    Ad = rng.standard_normal((120, 80)) / np.sqrt(120)
    U0, s0, V0h = np.linalg.svd(Ad, full_matrices=False)
    Ar = (U0 * (s0 * np.exp(-0.15 * np.arange(len(s0))))) @ V0h
    rng = np.random.default_rng(0)
    Ag = rng.standard_normal((50, 30))
    Bg = rng.standard_normal((40, 30))
    rng = np.random.default_rng(0)
    Ah = rng.standard_normal((40, 25))
    om = np.sign(rng.standard_normal(40))
    om[0] = 1
    n = 30
    grcar = sp.diags([-np.ones(n - 1), np.ones(n), np.ones(n - 1),
                      np.ones(n - 2), np.ones(n - 3)], [-1, 0, 1, 2, 3],
                     format="csr")
    return Ad, Ar, (Ag, Bg), (Ah, om), grcar


def phase15_small(dev):
    """Small SVD paths on the card, each against numpy / scipy on the same
    matrix: cyclic, randomized and lapack (120 x 80), HSVD and both GSVD
    routes, the Grcar values, and a c128 trlanczos on the gauge-transformed
    30 x 32 x 34 gradient.  Their kernels against their plain versions at
    their shapes first.  Returns the launch counts (read from zero)."""
    Ad, Ar, (Ag, Bg), (Ah, om), grcar = svd_small_cases()
    dims = (30, 32, 34)
    phi = gauge_phases(int(np.prod(dims)))
    Gc = gradient_3d(*dims, phases=phi)
    gen = torch.Generator(device=dev).manual_seed(16)
    ops = {"grcar": stt.from_scipy(grcar, device=dev),
           "gradient c128": stt.from_scipy(Gc, device=dev)}
    for where, op in ops.items():
        e = csr_both_errors(op, gen)
        print(f"phase 15 small: K6 on {where} and its adjoint: {e[0]:.3e} / "
              f"{e[1]:.3e}", flush=True)
        check(max(e) <= 1e-13, f"phase 15 {where}: K6 error {max(e):.3e}")
    f64, c128 = torch.float64, torch.complex128
    basis_kernels(dev, "phase 15 small: K3 / K3c, K4 / K4c vs plain PyTorch "
                  "at the small SVD paths' shapes", (
                      ("cyclic (200 rows)", 200, 20, f64, f64),
                      ("cross / lapack (80)", 80, 20, f64, f64),
                      ("GSVD JBD stacked (90)", 90, 18, f64, f64),
                      ("GSVD JBD U1 / U2 / X (50)", 50, 18, f64, f64),
                      ("HSVD / GSVD cross (25-30)", 30, 18, f64, f64),
                      ("Grcar (30)", 30, 16, f64, f64),
                      ("gradient U c128", Gc.shape[0], 24, c128, c128),
                      ("gradient V c128", Gc.shape[1], 24, c128, c128)))
    stt.reset_launch_counts()

    def run(where, svd):
        t0 = time.perf_counter()
        svd.solve()
        torch.cuda.synchronize()
        print(f"  {where}: nconv={svd.nconv} its={svd.its} wall="
              f"{time.perf_counter() - t0:.3f} s sigma[:3]={svd.sigma[:3]}",
              flush=True)
        return svd

    def dense(M):
        return stt.DenseOperator(M, device=dev)

    for solver, M, rtol in (("cyclic", Ad, 1e-6), ("randomized", Ar, 2e-2),
                            ("lapack", Ad, 1e-12)):
        svd = run(f"{solver} 120 x 80", stt.SVD(dense(M), nsv=5,
                                                 solver=solver))
        s_ref = np.linalg.svd(M, compute_uv=False)[:5]
        rel = np.abs(svd.sigma[:5] - s_ref).max() / s_ref[0]
        resid = max(svd.compute_error(i) for i in range(5))
        check(svd.nconv >= 5 and rel <= rtol and resid
              < (5e-2 if solver == "randomized" else 1e-5),
              f"phase 15 {solver}: sigma {rel:.3e}, residual {resid:.3e}")
    sig_g = np.sqrt(np.sort(sla.eigh(Ag.T @ Ag, Bg.T @ Bg,
                                     eigvals_only=True))[::-1])
    for solver in ("trlanczos", "cross"):
        svd = run(f"GSVD {'JBD' if solver == 'trlanczos' else 'cross pencil'}",
                  stt.SVD(dense(Ag), B=dense(Bg), nsv=3, solver=solver))
        r = max(np.linalg.norm(Ag.T @ (Ag @ svd.X[:, i]) - svd.sigma[i] ** 2
                               * (Bg.T @ (Bg @ svd.X[:, i])))
                / np.linalg.norm(svd.X[:, i]) for i in range(3))
        check(svd.nconv >= 3 and np.allclose(svd.sigma[:3], sig_g[:3],
                                              rtol=1e-6) and r < 1e-6,
              f"phase 15 GSVD {solver}: {svd.sigma[:3]} vs {sig_g[:3]}, "
              f"pencil residual {r:.3e}")
    M = Ah.T @ (om[:, None] * Ah)
    sig_h = np.sqrt(np.sort(np.abs(np.linalg.eigvalsh(0.5 * (M + M.T))))[::-1])
    svd = run("HSVD 40 x 25", stt.SVD(dense(Ah), omega=om, nsv=3))
    Gm = svd.U[:, :3].T @ (om[:, None] * svd.U[:, :3])
    check(svd.nconv >= 3 and np.allclose(svd.sigma[:3], sig_h[:3], rtol=1e-6)
          and np.allclose(np.diag(Gm), svd.sign[:3], atol=1e-6),
          f"phase 15 HSVD: {svd.sigma[:3]} vs {sig_h[:3]}")
    for which, digits in (("largest", "3.2215"), ("smallest", "0.9551")):
        svd = run(f"Grcar {which}", stt.SVD(ops["grcar"], nsv=1, which=which))
        check(svd.nconv >= 1 and f"{float(svd.sigma[0]):.4f}" == digits,
              f"phase 15 Grcar {which}: {svd.sigma[:1]} (want {digits})")
    exact = np.sqrt(stt.laplacian_3d_eigs(*dims))[::-1]
    svd = run("trlanczos c128 gauge-transformed gradient 30x32x34",
              stt.SVD(ops["gradient c128"], nsv=6, ncv=24, tol=1e-9))
    err = np.abs(svd.sigma[:6] - exact[:6]).max() / exact[0]
    resid = max(svd.compute_error(i) for i in range(6))
    check(svd.nconv >= 6 and err <= 1e-9 and resid <= 1e-8,
          f"phase 15 c128 trlanczos: {err:.3e}, residual {resid:.3e}")
    counts = stt.launch_counts()
    for k in ("csr_spmv_f64", "csr_spmv_c128", "panel_dots_f64",
              "panel_dots_c128", "rotate_f64", "rotate_c128"):
        check(counts[k] > 0, f"phase 15 small: {k} did not launch")
    return counts


# ---- matrix functions and equations (item 13), polynomial problems (14) --

MFN_GRID = SVD_GRID  # phase 7's grid: 1,060,800 unknowns
MFN_T, MFN_NCV, MFN_TOL, MFN_SEED = 1.0, 30, 1e-10, 16
LYAP_SIDE, LYAP_SHIFT, LYAP_NCV, LYAP_TOL = 1000, 0.1, 30, 1e-8
SYLV_N, SYLV_NCV = 2 ** 20, 40
QEP_SIDE, QEP_NEV, QEP_TOL = 300, 3, 1e-6
ACOUSTIC_N, ACOUSTIC_NCV, ACOUSTIC_TOL = 2 ** 20, 40, 1e-9


def second_difference(k):
    return 2 * np.eye(k) - np.eye(k, k=1) - np.eye(k, k=-1)


def kron3(vx, vy, vz):
    """The vector of a separable grid function, x fastest (laplacian_3d's
    order)."""
    return np.kron(vz, np.kron(vy, vx))


def heat_case():
    """Seeded factors b_x, b_y, b_z of b = kron(b_z, b_y, b_x) and phases
    phi_x, phi_y, phi_z of a separable gauge D = diag(e^{i phi}), phi(x,
    y, z) = phi_x(x) + phi_y(y) + phi_z(z), so D^H b stays a Kronecker
    product."""
    rng = np.random.default_rng(MFN_SEED)
    bs = [rng.standard_normal(k) for k in MFN_GRID]
    phs = [2 * np.pi * rng.random(k) for k in MFN_GRID]
    return bs, phs


def heat_closed_form(bs, phs=None, t=MFN_T):
    """exp(-t L) b = kron(e^{-t T_z} b_z, e^{-t T_y} b_y, e^{-t T_x} b_x)
    (T_d the 1-D second differences, scipy expm on each factor); with
    ``phs``, D exp(-t L) D^H b for the gauge G = D L D^H."""
    outs = []
    for i, b in enumerate(bs):
        E = sla.expm(-t * second_difference(len(b)))
        if phs is None:
            outs.append(E @ b)
        else:
            u = np.exp(1j * phs[i])
            outs.append(u * (E @ (u.conj() * b)))
    return kron3(*outs)


def heat_operators(dev):
    """The 1,060,800-row Laplacian in f64 and f32, and its separable gauge
    G = D L D^H in c128 (gauge_dia with the separable phases)."""
    _, phs = heat_case()
    L = stt.laplacian_3d(*MFN_GRID, dtype=torch.float64, device=dev)
    px, py, pz = phs
    phi = (pz[:, None, None] + py[None, :, None] + px[None, None, :]).ravel()
    return {"f64": L, "f32": stt.laplacian_3d(*MFN_GRID, dtype=torch.float32,
                                              device=dev),
            "c128": gauge_dia(L, torch.complex128, phi=phi)}


def shifted_dia(A, s, scale=1.0):
    """scale * (A + s I) for a DIA operator with a main diagonal."""
    d = A.diags.clone()
    d[A.offsets.index(0)] += s
    return stt.DIAOperator(A.offsets, scale * d)


def lyap_operator(dev):
    """A = -(laplacian_2d(1000, 1000) + 0.1 I): 10^6 rows, stable."""
    return shifted_dia(stt.laplacian_2d(LYAP_SIDE, LYAP_SIDE, device=dev),
                       LYAP_SHIFT, -1.0)


def sylv_operators(dev):
    """tests/test_modules.py:227's tridiagonals at 2^20 and 2^20 - 4,096
    rows, as DIA operators: A = tridiag(-1, -3, -1), B = tridiag(1, 8, 1)."""
    def tri(n, o, d):
        lo, up = np.full(n, o), np.full(n, o)
        lo[0] = up[-1] = 0.0
        return stt.DIAOperator((-1, 0, 1), np.stack([lo, np.full(n, d), up]),
                               device=dev)
    return tri(SYLV_N, -1.0, -3.0), tri(SYLV_N - 4096, 1.0, 8.0)


def lyapii_band(n, dev):
    """A stable nonsymmetric tridiagonal DIA matrix with an isolated
    rightmost eigenvalue near -0.4: lyapii on a DIA operator (K5)."""
    main = -np.concatenate([[0.4], 2.0 + np.linspace(0.0, 3.0, n - 1)])
    up, lo = np.full(n, 0.1), np.full(n, 0.05)
    up[-1], lo[0] = 0.0, 0.0
    return stt.DIAOperator((-1, 0, 1), np.stack([lo, main, up]), device=dev)


def phase16_kernels(dev):
    """K2 / K1 / K2c, K3 / K3c, K4 / K4c at the MFN runs' shapes (ncv 30
    and 10 bases of 1,060,800 rows, the (m, 1) update), K2, K3, K4 at the
    Lyapunov equation's (10^6 rows, ncv 60 after one doubling), K5 at the
    residual's A Z (8-row launches), and K2 on the Sylvester operators and
    their adjoints' diagonals; before phase 16's counts are reset."""
    ops = heat_operators(dev)
    for tag, dt in (("f64", torch.float64), ("f32", torch.float32),
                    ("c128", torch.complex128)):
        path_kernels(dev, f"phase 16: the SpMV, K3, K4 vs plain PyTorch at "
                     f"MFN's shapes ({tag})", (
                         (f"16a heat {tag}", lambda: ops[tag], MFN_NCV),
                         (f"16a heat {tag} ncv 10", lambda: ops[tag], 10)),
                     dtype=dt)
    del ops
    path_kernels(dev, "phase 16: K2, K3, K4 vs plain PyTorch at the "
                 "Lyapunov equation's shapes", (
                     ("16b Lyapunov 10^6 rows", lambda: lyap_operator(dev),
                      2 * LYAP_NCV),))
    gen = torch.Generator(device=dev).manual_seed(16)
    A = lyap_operator(dev)
    Z = torch.randn((9, A.shape[0]), generator=gen, dtype=torch.float64,
                    device=dev)
    rel = spmm_errors(A, Z[1:9])
    print(f"  K5 at the residual's A Z (b = 8, 10^6 rows): err {rel:.3e}",
          flush=True)
    check(rel <= P13_TOL["K5"], f"phase 16 K5: {rel:.3e}")
    del A, Z
    for op in sylv_operators(dev):
        x = torch.randn(op.shape[0], generator=gen, dtype=torch.float64,
                        device=dev)
        adj = op.adjoint()
        e = (spmv_errors(op.offsets, op.diags, x)[1],
             spmv_errors(adj.offsets, adj.diags, x)[1])
        print(f"  K2 on a Sylvester operator ({op.shape[0]} rows) and its "
              f"adjoint: {e[0]:.3e} / {e[1]:.3e}", flush=True)
        check(max(e) <= PATH_TOL[torch.float64]["K2"],
              f"phase 16 Sylvester K2: {max(e):.3e}")
    torch.cuda.empty_cache()


def phase16a(dev):
    """MFN at full width: exp(-L) b on the 1,060,800-row Laplacian against
    the Kronecker closed form.  Returns the launch counts (read from
    zero)."""
    bs, phs = heat_case()
    b = kron3(*bs)
    t0 = time.perf_counter()
    refs = {"real": heat_closed_form(bs), "gauge": heat_closed_form(bs, phs)}
    print(f"phase 16a: MFN y = exp(-t L) b, t = {MFN_T}, on the "
          f"{MFN_GRID} grid ({b.size} rows); closed forms on the host in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ops = heat_operators(dev)
    runs = (("krylov f64", "f64", "krylov", MFN_NCV, MFN_TOL, "real", 1e-9),
            ("expokit f64", "f64", "expokit", MFN_NCV, MFN_TOL, "real", 1e-9),
            ("krylov f64 ncv 10", "f64", "krylov", 10, MFN_TOL, "real", 1e-9),
            ("krylov f32", "f32", "krylov", MFN_NCV, 1e-5, "real", 1e-4),
            ("krylov c128 gauge", "c128", "krylov", MFN_NCV, MFN_TOL, "gauge",
             1e-9))
    stt.reset_launch_counts()
    for where, tag, solver, ncv, tol, ref, gate in runs:
        f = stt.FNExp()
        f.set_scale(-MFN_T)
        mfn = stt.MFN(ops[tag], f, ncv=ncv, tol=tol, solver=solver)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = mfn.solve(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = torch.from_numpy(refs[ref]).to(dev)
        err = float(torch.linalg.vector_norm(y.to(want.dtype) - want)
                    / torch.linalg.vector_norm(want))
        print(f"  16a {where}: its={mfn.its} reason={mfn.reason} wall="
              f"{wall:.3f} s rel err vs closed form={err:.3e} (gate "
              f"{gate:g})", flush=True)
        check(y.dtype == ops[tag].dtype and y.device == dev,
              f"16a {where}: result {y.dtype} on {y.device}")
        check(err <= gate, f"16a {where}: error {err:.3e} > {gate:g}")
        if ncv == 10:
            check(mfn.its >= 2, f"16a {where}: no restart ({mfn.its})")
        del y, want
    counts = stt.launch_counts()
    for tag in ("f64", "f32", "c128"):
        spmv = "dia_spmv_" + tag
        launched("phase 16a", counts, (spmv, "panel_dots_" + tag,
                                        "panel_update_" + tag,
                                        "rotate_" + tag))
    del ops
    torch.cuda.empty_cache()
    return counts


def sylvester_residual(A, B, L, R, c1, c2):
    """||A X + X B + c1 c2^H||_F / (||c1|| ||c2||) with X = L R^H, in
    factored form: [A L, L, c1] [R, B^H R, c2]^H, one thin QR of each
    stack; A L and B^H R are block applies (K5)."""
    AL = op_mult_block(A, L.T.contiguous())
    BhR = op_mult_block(B.adjoint(), R.T.contiguous())
    S1 = torch.cat([AL, L.T, c1[None]]).T
    S2 = torch.cat([R.T, BhR, c2[None]]).T
    R1 = torch.linalg.qr(S1, mode="r")[1]
    R2 = torch.linalg.qr(S2, mode="r")[1]
    num = torch.linalg.matrix_norm(R1 @ R2.mH)
    return float(num) / float(torch.linalg.vector_norm(c1)
                              * torch.linalg.vector_norm(c2))


def phase16b(dev):
    """LME at full width (Lyapunov at 10^6 rows, Krylov Sylvester at
    2^20 rows) and the small paths.  Returns the launch counts."""
    rng = np.random.default_rng(MFN_SEED)
    stt.reset_launch_counts()
    A = lyap_operator(dev)
    C = rng.standard_normal((A.shape[0], 2))
    lme = stt.LME(A, ncv=LYAP_NCV, tol=LYAP_TOL)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    Z = lme.solve(C)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = lme.compute_residual(Z, C)
    t_res = time.perf_counter() - t0
    print(f"phase 16b: Lyapunov A X + X A^T + C C^T = 0, A = -(laplacian_2d("
          f"{LYAP_SIDE}, {LYAP_SIDE}) + {LYAP_SHIFT} I), C rank 2: Krylov "
          f"builds {lme.its}, rank {Z.shape[1]}, errest {lme.errest:.3e}, "
          f"wall {wall:.3f} s; factored residual {res:.3e} ({t_res:.3f} s); "
          f"peak {peak_gb(dev):.2f} GB", flush=True)
    check(Z.device == dev and Z.shape[0] == A.shape[0],
          f"16b Lyapunov: Z {tuple(Z.shape)} on {Z.device}")
    check(res <= 1e-8, f"16b Lyapunov: factored residual {res:.3e}")
    del A, Z, lme
    torch.cuda.empty_cache()
    A, B = sylv_operators(dev)
    c1 = rng.standard_normal(A.shape[0])
    c2 = rng.standard_normal(B.shape[0])
    lme = stt.LME(A, B=B, problem_type="sylvester", ncv=SYLV_NCV)
    t0 = time.perf_counter()
    L, R = lme.solve(c1, c2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = sylvester_residual(A, B, L, R, torch.from_numpy(c1).to(dev),
                             torch.from_numpy(c2).to(dev))
    print(f"  16b Sylvester (Krylov, {A.shape[0]} x {B.shape[0]}): builds "
          f"{lme.its}, rank {L.shape[1]}, errest {lme.errest:.3e}, wall "
          f"{wall:.3f} s, factored residual {res:.3e}", flush=True)
    check(res <= 1e-8, f"16b Sylvester: factored residual {res:.3e}")
    del A, B, L, R, lme
    torch.cuda.empty_cache()
    lme_small(dev)
    counts = stt.launch_counts()
    launched("phase 16b", counts, ("dia_spmv_f64", "dia_spmm_f64",
                                   "panel_dots_f64", "panel_update_f64",
                                   "rotate_f64"))
    return counts


def lme_small(dev):
    """The small LME paths at the reference tests' sizes
    (tests/test_round2.py:227, tests/test_modules.py:209, :198, :182 made
    complex), each against its dense residual."""
    rng = np.random.default_rng(1)
    n = 2000
    L = stt.laplacian_1d(n, device=dev)
    A = stt.DIAOperator(L.offsets, 0.2 * L.diags)
    c = rng.standard_normal(n)
    lme = stt.LME(A, problem_type="stein", ncv=24, tol=1e-10)
    Z = lme.solve(c).cpu().numpy()
    Ad = A.to_scipy()
    AZ = Ad @ Z
    res = np.linalg.norm(AZ @ AZ.T - Z @ Z.T + np.outer(c, c)) \
        / np.linalg.norm(np.outer(c, c))
    print(f"  16b Stein ({n} rows): builds {lme.its}, residual {res:.3e}",
          flush=True)
    check(res < 1e-9, f"16b Stein: residual {res:.3e}")
    rng = np.random.default_rng(0)
    n = 50
    Ad = -2 * np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    Ed = np.eye(n) + 0.1 * rng.standard_normal((n, n)) / np.sqrt(n)
    C1 = rng.standard_normal((n, 2))
    Z = stt.LME(stt.DenseOperator(Ad, device=dev),
                B=stt.DenseOperator(Ed, device=dev),
                problem_type="gen_lyapunov", ncv=40, tol=1e-10).solve(C1)
    X = (Z @ Z.T).cpu().numpy()
    res = np.linalg.norm(Ad @ X @ Ed.T + Ed @ X @ Ad.T + C1 @ C1.T) \
        / np.linalg.norm(C1 @ C1.T)
    print(f"  16b generalized Lyapunov ({n}): residual {res:.3e}", flush=True)
    check(res < 1e-8, f"16b generalized Lyapunov: residual {res:.3e}")
    rng = np.random.default_rng(11)
    A = rng.standard_normal((20, 20)) - 3 * np.eye(20)
    B = rng.standard_normal((15, 15)) + 3 * np.eye(15)
    C = rng.standard_normal((20, 15))
    X = stt.LME(stt.DenseOperator(A, device=dev),
                B=stt.DenseOperator(B, device=dev),
                problem_type="sylvester").solve(C).cpu().numpy()
    res = np.abs(A @ X + X @ B + C).max()
    print(f"  16b dense Sylvester (20 x 15): max residual {res:.3e}",
          flush=True)
    check(res < 1e-9, f"16b dense Sylvester: residual {res:.3e}")
    rng = np.random.default_rng(10)
    n = 60
    Ac = -2 * np.eye(n) + 0.5 * np.eye(n, k=1) + 0.4 * np.eye(n, k=-1) \
        + 0.3j * np.diag(np.linspace(-1, 1, n))
    C1 = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    lme = stt.LME(stt.DenseOperator(Ac, device=dev), ncv=30, tol=1e-9)
    res = lme.compute_residual(lme.solve(C1), C1)
    print(f"  16b complex Lyapunov ({n}): factored residual {res:.3e}",
          flush=True)
    check(res <= 1e-12, f"16b complex Lyapunov: residual {res:.3e}")


LYAPII_N = 1 << 20  # the full-width lyapii run's rows


def phase16c(dev):
    """lyapii on tests/test_eps_advanced.py:91's matrix (dense) and on
    banded DIA matrices (K5) of 200 and 2^20 rows; the big one's rightmost
    eigenvalue from its leading 200 x 200 block (the eigenvector decays
    by about 3e-3 a row).  Returns the launch counts."""
    stt.reset_launch_counts()
    rng = np.random.default_rng(3)
    n = 50
    d = -np.concatenate([[0.4], 2.0 + rng.random(n - 1) * 3])
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    Ad = Q @ np.diag(d) @ Q.T + 0.05 * rng.standard_normal((n, n)) / np.sqrt(n)
    band = lyapii_band(200, dev)
    big = lyapii_band(LYAPII_N, dev)
    for where, A, Adense in (("test_eps_advanced.py:91 (dense 50)",
                              stt.DenseOperator(Ad, device=dev), Ad),
                             ("banded DIA 200", band,
                              band.to_scipy().toarray()),
                             (f"banded DIA {LYAPII_N}", big,
                              big.to_scipy()[:200, :200].toarray())):
        w = np.linalg.eigvals(Adense)
        right = w[np.argmax(w.real)]
        eps = stt.EPS(A, problem_type="nhep", solver="lyapii", nev=1,
                      tol=1e-8, max_it=80, options=stt.Options())
        t0 = time.perf_counter()
        eps.solve()
        torch.cuda.synchronize()
        lam = complex(eps.eigenvalues[0]) if eps.nconv else complex("nan")
        err = abs(lam.real - right.real) + abs(abs(lam.imag) - abs(right.imag))
        print(f"phase 16c: lyapii on {where}: nconv {eps.nconv} its {eps.its} "
              f"lambda {lam:.10f} vs {complex(right):.10f} (err {err:.3e}), "
              f"wall {time.perf_counter() - t0:.3f} s", flush=True)
        check(eps.nconv >= 1 and err <= 1e-6,
              f"16c lyapii {where}: {lam} vs {right}")
    counts = stt.launch_counts()
    launched("phase 16c", counts, ("dia_spmm_f64", "panel_dots_f64",
                                   "rotate_f64"))
    return counts


def damped_quadratic(dev):
    """bench.py:1169-1185's damped quadratic: K = laplacian_2d(300, 300),
    C = diag(0.1 + 0.05 sin(10^-2 i)), M = I; 90,000 rows, f64 DIA."""
    n = QEP_SIDE * QEP_SIDE
    tau = 0.1 + 0.05 * np.sin(np.arange(n) * 1e-2)
    return (stt.laplacian_2d(QEP_SIDE, QEP_SIDE, dtype=torch.float64,
                             device=dev),
            stt.DIAOperator((0,), tau[None, :], device=dev),
            stt.DIAOperator((0,), np.ones((1, n)), device=dev))


def damped_reference(mats, k=6):
    """scipy eigs(sigma=0) on the 180,000-row companion pencil
    [[0, I], [-K, -C]] z = lambda [[I, 0], [0, M]] z."""
    import scipy.sparse.linalg as spla

    K, C, M = (m.to_scipy() for m in mats)
    n = K.shape[0]
    I = sp.identity(n, format="csr")
    Acomp = sp.bmat([[None, I], [-K, -C]], format="csc")
    Bcomp = sp.bmat([[I, None], [None, M]], format="csc")
    return spla.eigs(Acomp, k=k, M=Bcomp, sigma=0, return_eigenvectors=False)


def acoustic_mats(n, dev):
    """examples/ex_pep_acoustic.py's boundary-damped acoustic QEP at n rows
    (h = 1/n): complex128 DIA K (tridiagonal), C and M (diagonal)."""
    h = 1.0 / n
    main = np.full(n, 2.0 / h)
    main[-1] = 1.0 / h
    up, lo = np.zeros(n), np.zeros(n)
    up[: n - 1] = -1.0 / h
    lo[1:] = -1.0 / h
    cvec = np.zeros(n, complex)
    cvec[-1] = 2j * np.pi
    mvec = np.full(n, 4.0 * np.pi ** 2 * h, complex)
    mvec[-1] = 2.0 * np.pi ** 2 * h
    return (stt.DIAOperator((-1, 0, 1), np.stack([lo, main, up]).astype(
        complex), device=dev), stt.DIAOperator((0,), cvec[None], device=dev),
        stt.DIAOperator((0,), mvec[None], device=dev))


def phase17_kernels(dev):
    """K2, K3, K4 at TOAR's shapes on the damped quadratic (U of ncv + d + 1
    = 21 rows of 90,000, the (r, 2) combinations), K3 on Q-Arnoldi's
    two-row panel, K3 / K4 at the linear solve's 180,000-row bases, K2 on
    C and M, and K2c, K3c, K4c at the acoustic TOAR's (2^20 rows, ncv 40);
    before phase 17's counts are reset."""
    K, C, M = damped_quadratic(dev)
    path_kernels(dev, "phase 17: K2, K3, K4 vs plain PyTorch at the damped "
                 "quadratic's shapes", (("17a K (90,000 rows)", lambda: K,
                                         20),))
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(K.shape[0], generator=gen, dtype=torch.float64,
                    device=dev)
    errs = {"K2 C": spmv_errors(C.offsets, C.diags, x)[1],
            "K2 M": spmv_errors(M.offsets, M.diags, x)[1]}
    V = torch.randn((22, K.shape[0]), generator=gen, dtype=torch.float64,
                    device=dev)
    W = torch.randn((2, K.shape[0]), generator=gen, dtype=torch.float64,
                    device=dev)
    Cc = torch.randn((21, 2), generator=gen, dtype=torch.float64, device=dev)
    errs["K3 two-row panel"] = max(
        rel for _, rel in panel_errors(V[:21], W, Cc).values())
    errs["K4 (21, 2)"] = rotate_errors(random_q(21, 2, dev, torch.float64),
                                       V[:21])[1]
    x2 = torch.randn(2 * K.shape[0], generator=gen, dtype=torch.float64,
                     device=dev)
    errs["K3 linear"], errs["K4 linear"] = basis_errors(dev, gen, x2, 24)
    print("  " + "  ".join(f"{k} {v:.3e}" for k, v in errs.items()),
          flush=True)
    tol = PATH_TOL[torch.float64]
    for k, v in errs.items():
        check(v <= tol[k.split()[0]], f"phase 17 {k}: error {v:.3e}")
    del K, C, M, V, W, x, x2
    path_kernels(dev, "phase 17: K2c, K3c, K4c vs plain PyTorch at the "
                 "acoustic TOAR's shapes", (
                     ("17b acoustic K (2^20 rows)",
                      lambda: acoustic_mats(ACOUSTIC_N, dev)[0],
                      ACOUSTIC_NCV),), dtype=torch.complex128)
    torch.cuda.empty_cache()


def pep_run(where, pep, dev):
    """Solve pep on the card with the event log on: (wall, peak GB, host
    seconds of the P(sigma) solves and of their transfers)."""
    stt.log_begin()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pep.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from slepc_tpu_torch.sys.events import get_event

    ev = {k: (get_event(k) or {"time": 0.0, "count": 0})
          for k in ("KSP_Solve_direct", "KSP_HostSolve_d2h",
                    "KSP_HostSolve_h2d")}
    stt.log_reset()
    solves = ev["KSP_Solve_direct"]
    print(f"  {where}: nconv={pep.nconv} restarts={pep.its} TOAR steps="
          f"{getattr(pep, 'toar_steps', '-')} wall={wall:.3f} s; P(sigma) "
          f"solves {solves['count']} taking {solves['time']:.3f} s "
          f"({100 * solves['time'] / wall:.1f}% of the wall; transfers "
          f"d2h {ev['KSP_HostSolve_d2h']['time']:.3f} s, h2d "
          f"{ev['KSP_HostSolve_h2d']['time']:.3f} s); peak "
          f"{peak_gb(dev):.2f} GB", flush=True)
    return wall


def pep_values(where, pep, want, k, rel):
    """The first k values each matched to its own nearest value of
    ``want`` within ``rel`` relative; compute_error <= the solve's tol."""
    check(pep.nconv >= k, f"{where}: nconv {pep.nconv} < {k}")
    pool = list(np.asarray(want, complex))
    worst = 0.0
    for lam in np.asarray(pep.eigenvalues[:k], complex):
        j = int(np.argmin([abs(lam - w) for w in pool]))
        worst = max(worst, abs(lam - pool[j]) / abs(pool[j]))
        pool.pop(j)
    errs = [pep.compute_error(i) for i in range(k)]
    print(f"    values {np.array2string(np.asarray(pep.eigenvalues[:k]), precision=10)}"
          f" max rel off the reference {worst:.3e}; max compute_error "
          f"{max(errs):.3e}", flush=True)
    check(worst <= rel, f"{where}: values off by {worst:.3e}")
    check(max(errs) <= pep.tol, f"{where}: compute_error {max(errs):.3e}")


def phase17a(dev):
    """The damped quadratic at full width by toar, qarnoldi and linear.
    Returns (launch counts, walls)."""
    mats = damped_quadratic(dev)
    t0 = time.perf_counter()
    want = damped_reference(mats)
    print(f"phase 17a: damped quadratic (bench.py:1169), 90,000 rows, nev "
          f"{QEP_NEV}, tol {QEP_TOL:g}; scipy eigs(sigma=0) on the "
          f"180,000-row companion pencil in {time.perf_counter() - t0:.2f} s:"
          f" {np.array2string(np.sort_complex(want), precision=8)}",
          flush=True)
    stt.reset_launch_counts()
    walls = {}
    for solver in ("toar", "qarnoldi", "linear"):
        pep = stt.PEP(list(mats), nev=QEP_NEV, solver=solver,
                      which="largest_magnitude", tol=QEP_TOL)
        if solver == "linear":
            # without a target the linear route takes the largest |lambda|
            # of B^-1 A; sigma = 0 is what toar and qarnoldi shift to
            pep.set_target(0.0)
        walls[solver] = pep_run(f"17a {solver}", pep, dev)
        pep_values(f"17a {solver}", pep, want, QEP_NEV, 1e-6)
    counts = stt.launch_counts()
    launched("phase 17a", counts, ("dia_spmv_f64", "panel_dots_f64",
                                   "panel_update_f64", "rotate_f64"))
    return counts, walls


def phase17b(dev):
    """The acoustic QEP at 2^20 rows in c128 by toar at 0.5i, against the
    port's own solve on the CPU.  Returns (launch counts, wall)."""
    print(f"phase 17b: acoustic QEP (examples/ex_pep_acoustic.py) at n = "
          f"{ACOUSTIC_N}, c128, toar, target 0.5i, nev 4, ncv "
          f"{ACOUSTIC_NCV}, tol {ACOUSTIC_TOL:g}", flush=True)

    def make(d):
        return stt.PEP(list(acoustic_mats(ACOUSTIC_N, d)), nev=4,
                       ncv=ACOUSTIC_NCV, solver="toar",
                       which="target_magnitude", target=0.5j,
                       tol=ACOUSTIC_TOL)

    stt.reset_launch_counts()
    pep = make(dev)
    wall = pep_run("17b toar (card)", pep, dev)
    counts = stt.launch_counts()
    t0 = time.perf_counter()
    cpu = make("cpu")
    cpu.solve()
    print(f"  17b toar (CPU): nconv={cpu.nconv} restarts={cpu.its} wall="
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    check(cpu.nconv >= 4, f"17b CPU: nconv {cpu.nconv}")
    pep_values("17b toar", pep, cpu.eigenvalues[: cpu.nconv], 4,
               ACOUSTIC_TOL)
    launched("phase 17b", counts, ("dia_spmv_c128", "panel_dots_c128",
                                   "panel_update_c128", "rotate_c128"))
    return counts, wall


def tridiag_np(n, d, o):
    return d * np.eye(n) + o * (np.eye(n, k=1) + np.eye(n, k=-1))


def phase17c(dev):
    """The small PEP paths on the card at the reference tests' sizes, each
    against the dense companion spectrum or the published digits.  Returns
    the launch counts."""
    stt.reset_launch_counts()

    def dense(*mats):
        return [stt.DenseOperator(A, device=dev) for A in mats]

    def companion(K, C, M):
        n = K.shape[0]
        return sla.eigvals(np.block([[np.zeros((n, n)), np.eye(n)], [-K, -C]]),
                           np.block([[np.eye(n), np.zeros((n, n))],
                                     [np.zeros((n, n)), M]]))

    def near(where, pep, wref, k, tol):
        check(pep.nconv >= k, f"17c {where}: nconv {pep.nconv}")
        off = max(np.min(np.abs(wref - lam)) for lam in pep.eigenvalues[:k])
        err = max(pep.compute_error(i) for i in range(k))
        print(f"  17c {where}: nconv={pep.nconv} its={pep.its} max |lam - "
              f"dense| {off:.3e} max compute_error {err:.3e}", flush=True)
        check(off < tol and err < 1e-7, f"17c {where}: {off:.3e} / {err:.3e}")

    K, C, M = tridiag_np(40, 2.0, -1.0), tridiag_np(40, 0.4, -0.1), np.eye(40)
    w40 = companion(K, C, M)
    for kind in ("none", "norm", "residual", "structured"):
        pep = stt.PEP(dense(K, C, M), nev=4, solver="toar")
        pep.set_target(-0.2)
        pep.set_extraction(kind)
        pep.solve()
        near(f"toar extraction {kind}", pep, w40, 4, 1e-6)
    pep = stt.PEP(dense(K, C, M), nev=2, solver="jd", max_it=300)
    pep.set_target(-0.2)
    pep.solve()
    near("jd", pep, w40, 2, 1e-6)
    n = 60
    K2 = tridiag_np(n, 2.0, -1.0)
    C2 = 10 * np.eye(n) + 0.5 * (np.eye(n, k=1) + np.eye(n, k=-1))
    pep = stt.PEP(dense(K2, C2, np.eye(n)), nev=4, solver="stoar")
    pep.set_target(-0.4)
    pep.solve()
    near("stoar", pep, companion(K2, C2, np.eye(n)), 4, 1e-8)
    rng = np.random.default_rng(0)
    C3 = np.diag(5.0 + rng.random(40))
    wq = np.sort(companion(K, C3, np.eye(40)).real)
    inside = wq[(wq > -0.9) & (wq < -0.3)]
    pep = stt.PEP(dense(K, C3, np.eye(40)), solver="stoar", tol=1e-9)
    pep.set_interval(-0.9, -0.3)
    pep.solve()
    off = np.abs(np.sort(pep.eigenvalues) - inside).max() \
        if pep.nconv == len(inside) else np.inf
    print(f"  17c qslice [-0.9, -0.3]: {pep.nconv} values of {len(inside)}, "
          f"max off {off:.3e}", flush=True)
    check(off <= 1e-7 * np.abs(inside).max(), f"17c qslice: {off:.3e}")
    rng = np.random.default_rng(0)
    B0 = rng.standard_normal((30, 30))
    B0 = B0 + B0.T + 8 * np.eye(30)
    pep = stt.PEP(dense(B0, 0.2 * np.eye(30), np.eye(30)), nev=4,
                  solver="toar", basis="chebyshev")
    pep.set_target(1.5)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error", np.exceptions.ComplexWarning)
        pep.solve()
    near("Chebyshev basis", pep, companion(B0 - np.eye(30), 0.2 * np.eye(30),
                                           2 * np.eye(30)), 4, 1e-8)
    K4 = tridiag_np(30, 2.0, -1.0)
    pep = stt.PEP(dense(K4, 0.3 * np.eye(30), np.eye(30)), nev=4,
                  solver="toar")
    pep.set_target(-0.15 + 1.0j)
    pep.solve()
    lam0 = pep.eigenvalues[:4].copy()
    pep.eigenvalues = pep.eigenvalues.astype(complex) * (1 + 1e-5)
    pep.refine(steps=3, scheme="multiple")
    pep.eigenvalues[:4] *= (1 + 1e-7)
    pep.refine(steps=3)
    drift = max(np.min(np.abs(pep.eigenvalues[:4] - lam)) / abs(lam)
                for lam in lam0)
    err = max(pep.compute_error(i) for i in range(4))
    print(f"  17c refinement (multiple, then simple): drift {drift:.3e}, "
          f"max compute_error {err:.3e}", flush=True)
    check(drift < 1e-8 and err < 1e-12, f"17c refinement: {drift:.3e} / "
          f"{err:.3e}")
    rng = np.random.default_rng(0)
    n = 120
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    D = sp.diags(10.0 ** rng.uniform(-4, 4, n))
    scaled = [sp.csr_matrix(D @ (2.0 * T) @ D),
              sp.csr_matrix(D @ (0.1 * T + 0.3 * sp.eye(n)) @ D),
              sp.csr_matrix(D @ D)]
    back = {}
    for scale in ("none", "diagonal"):
        pep = stt.PEP([stt.from_scipy(A, device=dev) for A in scaled],
                      nev=4, solver="toar", tol=1e-9, scale=scale)
        pep.set_target(-0.15 + 0j)
        pep.solve()
        out = []
        for i in range(min(pep.nconv, 3)):
            lam, x = pep.get_eigenpair(i)
            x = x.cpu().numpy()
            r = sum(lam ** j * (A @ x) for j, A in enumerate(scaled))
            out.append(np.linalg.norm(r) / sum(
                abs(lam) ** j * abs(A).sum(1).max()
                for j, A in enumerate(scaled)))
        back[scale] = max(out)
    print(f"  17c diagonal scaling (CSR {n}): backward error {back['none']:.3e}"
          f" -> {back['diagonal']:.3e}", flush=True)
    check(back["diagonal"] < 0.1 * back["none"], f"17c scaling: {back}")
    digits_case(dev)
    before = stt.launch_counts()
    pep = stt.PEP(dense(K, C, M), nev=2, solver="ciss")
    try:
        pep.solve()
        check(False, "17c ciss: did not raise")
    except NotImplementedError as e:
        check("item 15" in str(e), f"17c ciss: {e}")
    check(stt.launch_counts() == before, "17c ciss: a kernel launched")
    print("  17c ciss raises naming ROADMAP item 15, no launch", flush=True)
    counts = stt.launch_counts()
    launched("phase 17c", counts, ("csr_spmv_f64", "panel_dots_f64",
                                   "rotate_f64"))
    return counts


def digits_case(dev):
    """tests/test_reference_golden.py:82: src/pep/tests/test1.c's values
    to their 5 printed decimals (linear, largest magnitude, CSR K and C, a
    diagonal M)."""
    n, m = 10, 11
    N = n * m
    K = sp.lil_matrix((N, N))
    C = sp.lil_matrix((N, N))
    for II in range(N):
        i, j = II // n, II % n
        if i > 0:
            K[II, II - n] = -1.0
        if i < m - 1:
            K[II, II + n] = -1.0
        if j > 0:
            K[II, II - 1] = C[II, II - 1] = -1.0
        if j < n - 1:
            K[II, II + 1] = C[II, II + 1] = -1.0
        K[II, II] = 4.0
        C[II, II] = 2.0
    pep = stt.PEP([stt.from_scipy(K.tocsr(), device=dev),
                   stt.from_scipy(C.tocsr(), device=dev),
                   stt.DiagonalOperator(np.arange(1, N + 1.0), device=dev)],
                  nev=4, ncv=40, which="largest_magnitude", tol=1e-9,
                  solver="linear")
    pep.solve()
    got = sorted(f"{g.real:.5f}{abs(g.imag):+.5f}j"
                 for g in pep.eigenvalues[:4])
    want = sorted(["-1.16404+1.65363j"] * 2 + ["-0.51784+1.31039j"] * 2)
    print(f"  17c test1.c digits: {got}", flush=True)
    check(pep.nconv >= 4 and got == want, f"17c test1.c digits: {got}")


def kernel_resources(log):
    """Registers and spills of every compiled kernel (nvcc -Xptxas -v)."""
    names = (("panel_kernelI([df])Li(\\d)ELi(\\d)ELb([01])ELb([01])E",
              "K3 panel<{}, B={}, VW={}, update={}, dots={}>"),
             ("rotate_f64_kernelILi(\\d)ELb([01])E", "K4 rotate_f64<MT={}, vec={}>"),
             ("rotate_f32_kernelILb([01])E", "K4 rotate_f32<vec={}>"),
             ("dia_spmm_kernelI([df])Li(\\d)E", "K5 dia_spmm<{}, BT={}>"),
             ("csr_spmv_kernelI([df])E", "K6 csr_spmv<{}>"),
             ("panel_kernelIN5slepc7ComplexI([df])EELi(\\d)ELi(\\d)ELb([01])"
              "ELb([01])E", "K3c panel<complex {}, B={}, VW={}, update={}, "
              "dots={}>"),
             ("rotate_c128_kernelILi(\\d)E", "K4c rotate_c128<MT={}>"),
             ("rotate_c64_kernelILb([01])E", "K4c rotate_c64<vec={}>"),
             ("dia_spmv_kernelIN5slepc7ComplexI([df])EE", "K1c/K2c dia_spmv"
              "<complex {}>"),
             ("dia_spmm_kernelIN5slepc7ComplexI([df])EELi(\\d)E",
              "K5c dia_spmm<complex {}, BT={}>"),
             ("csr_spmv_kernelIN5slepc7ComplexI([df])EE",
              "K6c csr_spmv<complex {}>"))
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
                        help="after phase 11: a torch.profiler split of a "
                             "phase-10 solve, phase 7's tolerance study, the "
                             "K6 budget and K5 tile sweeps, the blocked f32 "
                             "study, K4c's ring-depth sweep and a "
                             "torch.profiler split of a phase-9, a phase-12b "
                             "(c128), a phase-7, a phase-4, a phase-5, a "
                             "phase-12d (c128 blocked) and a phase-15 "
                             "trlanczos solve; after "
                             "phase 13: torch.profiler and cProfile splits of "
                             "its two GD paths; after phase 17: a "
                             "torch.profiler split of a phase-17a toar "
                             "solve")
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
    k5_ms = phase1_block(dev, table)
    L_csr, A_csr, more_csr = phase1_csr(dev, table, host, k5_ms)
    if not args.profile:
        del L_csr, more_csr
    phase1_complex(dev, table, A_csr)
    phase1_k5c(dev, table)
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
    nhep_kernels(dev)
    stt.reset_launch_counts()
    nhep_walls, lam_f64 = phase10(dev)
    nhep_path = stt.launch_counts()
    print(f"  phase 10 launches: {nhep_path}", flush=True)
    stt.reset_launch_counts()
    phase11(dev)
    small_nhep_path = stt.launch_counts()
    print(f"  phase 11 launches: {small_nhep_path}", flush=True)
    for k in ("dia_spmv_f64", "dia_spmm_f64", "csr_spmv_f64",
              "panel_dots_f64", "panel_update_f64", "panel_update_dots_f64",
              "rotate_f64"):
        check(small_nhep_path[k] > 0, f"phase 11: {k} did not launch")
    # phase 12: each part resets the counts after its kernel checks and
    # returns what its solves launched
    counts_12a, lam_12a, run_12a = phase12a(dev, lam_f64, nhep_walls)
    counts_12b, wall_12b = phase12b(dev, wall_plain)
    counts_12c = phase12c(dev)
    t12d = time.perf_counter()
    counts_12d, ms_col_12d = phase12d(dev)
    wall_12d = time.perf_counter() - t12d
    complex_paths = (counts_12a, counts_12b, counts_12c, counts_12d)
    for part, counts_12 in zip("abcd", complex_paths):
        print(f"  phase 12{part} launches: "
              f"{ {k: v for k, v in counts_12.items() if v} }", flush=True)
    # phase 13: the kernels at its shapes, then each part read from zero
    t13 = time.perf_counter()
    csr_pair = gd_csr_case(dev)
    gd_kernels(dev, csr_pair[1])
    gd_walls, gd_path = phase13a(dev)
    p13b_walls, p13b_path = phase13b(dev, csr_pair)
    ciss_walls, ciss_path = phase13c(dev)
    del csr_pair
    p13_paths = (gd_path, p13b_path, ciss_path)
    for part, counts_13 in zip("abc", p13_paths):
        print(f"  phase 13{part} launches: "
              f"{ {k: v for k, v in counts_13.items() if v} }", flush=True)
    p13 = {k: sum(p[k] for p in p13_paths) for k in gd_path}
    print(f"  phase 13 wall (kernel checks and solves): "
          f"{time.perf_counter() - t13:.3f} s", flush=True)
    if args.profile:
        profile_gd(dev, gd_walls)
    # phase 14: the kernels at its shapes, then each part read from zero
    t14 = time.perf_counter()
    phase14_kernels(dev)
    ts_path, ts_run = phase14a(dev, lam_12a, run_12a)
    gh_path, gh_walls = phase14b(dev)
    bse_path, bse_walls = phase14c(dev)
    p14_paths = (ts_path, gh_path, bse_path)
    for part, counts_14 in zip("abc", p14_paths):
        print(f"  phase 14{part} launches: "
              f"{ {k: v for k, v in counts_14.items() if v} }", flush=True)
    p14 = {k: sum(p[k] for p in p14_paths) for k in ts_path}
    wall_14 = time.perf_counter() - t14
    print(f"  phase 14 wall (kernel checks and solves): {wall_14:.3f} s",
          flush=True)
    # phase 15: SVD at full width, then the small paths, each read from zero
    t15 = time.perf_counter()
    t0 = time.perf_counter()
    G_host = gradient_3d(*SVD_GRID)
    exact_svd = np.sqrt(np.sort(stt.laplacian_3d_eigs(*SVD_GRID))[::-1]
                        [:SVD_NSV])
    print(f"phase 15: the 3-D gradient of the {SVD_GRID} grid built on the "
          f"host in {time.perf_counter() - t0:.3f} s: {G_host.shape[0]} x "
          f"{G_host.shape[1]}, nnz {G_host.nnz}; sigma_1..3 = "
          f"{exact_svd[:3]}", flush=True)
    check(G_host.shape == (3_213_608, 1_060_800) and G_host.nnz == 6_364_800,
          f"phase 15: gradient {G_host.shape}, nnz {G_host.nnz}")
    svd_path, svd_walls = phase15_full(dev, G_host, exact_svd)
    del G_host
    svd_small_path = phase15_small(dev)
    p15_paths = (svd_path, svd_small_path)
    p15 = {k: sum(p[k] for p in p15_paths) for k in svd_path}
    wall_15 = time.perf_counter() - t15
    print(f"  phase 15 launches: { {k: v for k, v in p15.items() if v} }; "
          f"wall (kernel checks and solves) {wall_15:.3f} s", flush=True)
    # phase 16 (item 13): the kernels at its shapes, then each part read
    # from zero
    t16 = time.perf_counter()
    phase16_kernels(dev)
    p16_paths = (phase16a(dev), phase16b(dev), phase16c(dev))
    for part, counts_16 in zip("abc", p16_paths):
        print(f"  phase 16{part} launches: "
              f"{ {k: v for k, v in counts_16.items() if v} }", flush=True)
    p16 = {k: sum(p[k] for p in p16_paths) for k in p16_paths[0]}
    wall_16 = time.perf_counter() - t16
    print(f"  phase 16 wall (kernel checks and solves): {wall_16:.3f} s",
          flush=True)
    # phase 17 (item 14): the same
    t17 = time.perf_counter()
    phase17_kernels(dev)
    counts_17a, walls_17a = phase17a(dev)
    counts_17b, wall_17b = phase17b(dev)
    counts_17c = phase17c(dev)
    p17_paths = (counts_17a, counts_17b, counts_17c)
    for part, counts_17 in zip("abc", p17_paths):
        print(f"  phase 17{part} launches: "
              f"{ {k: v for k, v in counts_17.items() if v} }", flush=True)
    p17 = {k: sum(p[k] for p in p17_paths) for k in counts_17a}
    wall_17 = time.perf_counter() - t17
    print(f"  phase 17 wall (kernel checks and solves): {wall_17:.3f} s",
          flush=True)
    if args.profile:
        profile_solve("phase 17a toar", lambda: pep_run(
            "profiled 17a toar", stt.PEP(list(damped_quadratic(dev)),
                                         nev=QEP_NEV, solver="toar",
                                         which="largest_magnitude",
                                         tol=QEP_TOL), dev),
            plain_wall=walls_17a["toar"], shares={
                "K2": ("dia_spmv",), "K3": ("panel_kernel", "reduce_partials"),
                "K4": ("rotate_f64",)})
    if args.profile:
        A = spiral_operator(NHEP_LOG2, torch.float64, dev)
        profile_solve("phase 10 f64", lambda: nhep_solve(A, 1e-8)[1],
                      plain_wall=nhep_walls["f64"][0])
        del A
        A = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
        profile_solve("phase 9", lambda: plain_solve(A, 48, 3)[1],
                      plain_wall=wall_plain)
        G = gauge_dia(A, torch.complex128)
        del A
        ring_sweep(dev)
        profile_solve("phase 12b c128 cycle", lambda: plain_solve(G, 48, 3)[1],
                      plain_wall=wall_12b, shares={
                          "K3c": ("panel_kernel", "reduce_partials"),
                          "K4c": ("rotate_c128",)})
        del G
        profile_solve("phase 7 GHEP", lambda: sinvert_solve(
            dev, "profiled phase 7 GHEP", generalized=True)[1],
            plain_wall=wall_sinv)
        sinvert_tol_study(dev)
        budget_sweep(dev, L_csr, A_csr, more_csr)
        del L_csr, more_csr
        tile_sweep(dev)
        blocked_f32_study(dev)
        A = stt.from_scipy(A_csr, device=dev)
        profile_solve("phase 4", lambda: flagship_solve(
            A, "profiled phase 4", "csr_spmv")[0])
        A = stt.laplacian_3d(*FLAGSHIP, dtype=torch.float64, device=dev)
        profile_solve("phase 5", lambda: flagship_solve(
            A, "profiled phase 5", "dia_spmm", cheb_block=4)[0])
        G = gauge_dia(A, torch.complex128)
        del A
        profile_solve("phase 12d c128 blocked cycle", lambda: plain_solve(
            G, 48, 3, block_size=4)[1], shares={
                "K5c": ("dia_spmm",), "K3c": ("panel_kernel", "reduce_partials"),
                "K4c": ("rotate_c128",)})
        del G
        profile_solve("phase 15 trlanczos", lambda: svd_solve(
            stt.from_scipy(gradient_3d(*SVD_GRID), device=dev), "trlanczos"),
            plain_wall=svd_walls["trlanczos"], shares={
                "K6": ("csr_spmv",), "K3": ("panel_kernel", "reduce_partials"),
                "K4": ("rotate_f64",)})
    paths = (stream_path, dia_path, aij_path, blk_path, small_path, sinv_path,
             plain_path, nhep_path, small_nhep_path) + complex_paths \
        + p13_paths + p14_paths + p15_paths + p16_paths + p17_paths
    counts = {k: sum(p[k] for p in paths) for k in dia_path}
    missing = [k for k in KERNELS if counts[k] == 0]
    check(not missing, f"kernels never launched on the main path: {missing}")
    kernels = []
    for key, (knum, src, replaces) in KERNELS.items():
        row = table[key]
        kernels.append({"name": f"{key} ({knum})", "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": counts[key],
                        "launches_p13": p13[key],
                        "launches_p14": p14[key],
                        "launches_p12d": counts_12d[key],
                        "launches_p15": p15[key],
                        "launches_p16": p16[key],
                        "launches_p17": p17[key],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "stream_ms": row["bytes"] / rates[row["dtype"].to_real()]
                        / 1e6,
                        "library_ms": row["library_ms"],
                        "library": row["library"] or None})
    print("kernel table (ms): kernel (PERF.md's earlier reading, not measured "
          "here) / plain / bound / stream / library", flush=True)
    for k in kernels:
        lib = "-" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        print(f"  {k['name']:<28} {k['ms']:.4f} "
              f"({BEFORE_MS.get(k['name'].split()[0], float('nan')):.4f}) / "
              f"{k['plain_ms']:.4f} / "
              f"{k['bound_ms']:.4f} ({k['bound_by']}) / {k['stream_ms']:.4f} / "
              f"{lib}  launches {k['launches']} (phase 13: "
              f"{k['launches_p13']}, phase 14: {k['launches_p14']}, phase "
              f"12d: {k['launches_p12d']}, phase 15: {k['launches_p15']}, "
              f"phase 16: {k['launches_p16']}, phase 17: "
              f"{k['launches_p17']})", flush=True)
    print(f"flagship wall {wall:.3f} s (DIA), {wall_aij:.3f} s (AIJ, K6), "
          f"{wall_blk:.3f} s (blocked, K5); sinvert 1.06M rows "
          f"{wall_sinv:.3f} s (GHEP), {wall_sinv_std:.3f} s (standard); plain "
          f"cycle 10.35M rows {wall_plain:.3f} s; non-Hermitian 2.1M rows "
          + ", ".join(f"{t} {w:.3f} s ({its} restarts, {cols} columns)"
                      for t, (w, its, cols) in nhep_walls.items())
          + "; complex phase 12 passed; phase 13 "
          + ", ".join(f"{w} {t[0]:.3f} s ({t[2]} expansions)"
                      for w, t in gd_walls.items())
          + ", " + ", ".join(f"{w} {t:.3f} s" for w, t in p13b_walls.items())
          + ", " + ", ".join(f"{w} {t[0]:.3f} s" for w, t in ciss_walls.items())
          + f"; phase 14 two-sided 2^20 c128 {ts_run[0]:.3f} s ({ts_run[1]} "
          f"restarts, {ts_run[2]} columns a side, coupling "
          f"{ts_run[3] * 100:.1f}%), GHIEP "
          + ", ".join(f"{w} {t:.3f} s" for w, t in gh_walls.items())
          + ", BSE n=8192 "
          + ", ".join(f"{w} {t:.3f} s" for w, t in bse_walls.items())
          + f", phase 14 {wall_14:.3f} s; phase 12d {wall_12d:.3f} s "
          f"({ms_col_12d:.3f} ms a column of the blocked c128 cycle); SVD "
          + ", ".join(f"{w} {t:.3f} s" for w, t in svd_walls.items())
          + f", phase 15 {wall_15:.3f} s; phase 16 (MFN, LME, lyapii) "
          f"{wall_16:.3f} s; PEP 90,000-row damped quadratic "
          + ", ".join(f"{w} {t:.3f} s" for w, t in walls_17a.items())
          + f", acoustic 2^20 c128 toar {wall_17b:.3f} s, phase 17 "
          f"{wall_17:.3f} s on {smi_line}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
