"""Non-symmetric Markov chain model (dominant eigenvalue 1).

Reference analog: src/eps/tutorials/ex5.c.
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import slepc_tpu_torch

# examples run on the CUDA card by default; set SLEPC_TPU_TORCH_DEVICE=cpu
# to run them on the CPU (the kernels' plain PyTorch versions)
if os.environ.get("SLEPC_TPU_TORCH_DEVICE"):
    slepc_tpu_torch.set_default_device(os.environ["SLEPC_TPU_TORCH_DEVICE"])
import slepc_tpu_torch as st

A = st.mat.generators.markov(15)
eps = st.EPS(A, problem_type="nhep", which="largest_real", nev=4)
eps.solve()
eps.error_view()
