"""Interior eigenvalues via shift-and-invert (2-D Laplacian).

Reference analog: src/eps/tutorials/ex2.c + -st_type sinvert usage.
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import slepc_tpu_torch

# examples run on the CUDA card by default; set SLEPC_TPU_TORCH_DEVICE=cpu
# to run them on the CPU (the kernels' plain PyTorch versions)
if os.environ.get("SLEPC_TPU_TORCH_DEVICE"):
    slepc_tpu_torch.set_default_device(os.environ["SLEPC_TPU_TORCH_DEVICE"])
import slepc_tpu_torch as st

A = st.laplacian_2d(40, 40)
eps = st.EPS(A, problem_type="hep", nev=5)
eps.set_target(1.0)
eps.solve()
eps.error_view()
