"""All eigenvalues in an interval: inertia-certified spectrum slicing.

Reference analog: EPS_ALL interval solves (ks-slice.c machinery).
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

A = st.laplacian_2d(20, 19)
eps = st.EPS(A, problem_type="hep")
eps.set_interval(0.5, 1.0)
eps.solve()
print(f"eigenvalues in [0.5, 1.0]: {eps.nconv}")
print(np.round(np.sort(eps.eigenvalues.real), 6))
