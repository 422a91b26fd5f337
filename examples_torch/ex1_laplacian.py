"""Standard symmetric eigenproblem on the 1-D Laplacian.

Reference analog: src/eps/tutorials/ex1.c.
Run: python examples/ex1_laplacian.py [-eps_nev 6 -eps_type krylovschur ...]
"""

import sys

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import slepc_tpu_torch

# examples run on the CUDA card by default; set SLEPC_TPU_TORCH_DEVICE=cpu
# to run them on the CPU (the kernels' plain PyTorch versions)
if os.environ.get("SLEPC_TPU_TORCH_DEVICE"):
    slepc_tpu_torch.set_default_device(os.environ["SLEPC_TPU_TORCH_DEVICE"])
import numpy as np

import slepc_tpu_torch as st

st.set_global_options(" ".join(sys.argv[1:]))
n = 300
A = st.laplacian_1d(n)
print(f"\n1-D Laplacian Eigenproblem, n={n}\n")
eps = st.EPS(A, problem_type="hep", which="smallest_real", nev=4)
eps.solve()
eps.view()
eps.error_view()
exact = st.mat.generators.laplacian_1d_eigs(n, k=eps.nconv)
print("max deviation from closed form:",
      float(np.max(np.abs(np.sort(eps.eigenvalues.real) - exact))))
