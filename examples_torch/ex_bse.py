"""Bethe-Salpeter eigenproblem: H = [R C; -C -R] structure-preserving
solve for the smallest positive excitation energies.

Reference analog: src/eps/tutorials/ex55.c (MatCreateBSE + EPSKRYLOVSCHUR
BSE variants, ks-bse.c).
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import slepc_tpu_torch

if os.environ.get("SLEPC_TPU_TORCH_DEVICE"):
    slepc_tpu_torch.set_default_device(os.environ["SLEPC_TPU_TORCH_DEVICE"])
import numpy as np

import slepc_tpu_torch as st
from slepc_tpu_torch.mat.structured import create_bse

n = 120
rng = np.random.default_rng(7)
# R Hermitian positive definite (resonant block), C symmetric (coupling)
Rm = rng.standard_normal((n, n))
Rm = 0.5 * (Rm + Rm.T) + 2.0 * n * np.eye(n)
Cm = rng.standard_normal((n, n))
Cm = 0.5 * (Cm + Cm.T)

H = create_bse(st.DenseOperator(Rm), st.DenseOperator(Cm))
eps = st.EPS(H, problem_type="bse", nev=4, tol=1e-9)
eps.set_type("bse")
eps.solve()
print(f"nconv={eps.nconv} its={eps.its}")

# verify against a dense eig of the full 2n x 2n structured matrix
Hd = np.block([[Rm, Cm], [-Cm, -Rm]])
wd = np.sort(np.linalg.eigvals(Hd).real)
wd = wd[wd > 0][: eps.nconv]
for i in range(eps.nconv):
    lam = eps.eigenvalues[i].real
    print(f"  lambda = {lam:.8f}   vs dense {wd[i]:.8f}   "
          f"diff = {abs(lam - wd[i]):.2e}")
