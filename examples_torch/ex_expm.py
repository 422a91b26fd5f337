"""Action of the matrix exponential y = exp(tA) v.

Reference analog: src/mfn/tutorials/ex23.c.
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import slepc_tpu_torch

# examples run on the CUDA card by default; set SLEPC_TPU_TORCH_DEVICE=cpu
# to run them on the CPU (the kernels' plain PyTorch versions)
if os.environ.get("SLEPC_TPU_TORCH_DEVICE"):
    slepc_tpu_torch.set_default_device(os.environ["SLEPC_TPU_TORCH_DEVICE"])
import numpy as np

import slepc_tpu_torch as st

n = 400
A = st.laplacian_1d(n) * (-1.0)  # heat equation generator
b = np.ones(n)
fn = st.FNExp()
fn.set_scale(0.1)  # inner scale: t = 0.1
for solver in ("krylov", "expokit"):
    mfn = st.MFN(A, fn, ncv=30, solver=solver)
    y = mfn.solve(b).cpu().numpy()
    print(f"{solver}: ||y|| = {np.linalg.norm(y):.12f}  (its={mfn.its})")
