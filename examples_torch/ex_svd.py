"""Partial SVD of a sparse rectangular matrix.

Reference analog: src/svd/tutorials/ex14.c.
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import slepc_tpu_torch

# examples run on the CUDA card by default; set SLEPC_TPU_TORCH_DEVICE=cpu
# to run them on the CPU (the kernels' plain PyTorch versions)
if os.environ.get("SLEPC_TPU_TORCH_DEVICE"):
    slepc_tpu_torch.set_default_device(os.environ["SLEPC_TPU_TORCH_DEVICE"])
import numpy as np
import scipy.sparse as sp

import slepc_tpu_torch as st

rng = np.random.default_rng(0)
A = st.from_scipy(sp.random(500, 300, density=0.02, random_state=rng, format="csr"))
svd = st.SVD(A, nsv=5, solver="trlanczos")
svd.solve()
for i in range(svd.nconv):
    s, u, v = svd.get_singular_triplet(i)
    print(f"sigma_{i} = {s:.9f}   rel.res = {svd.compute_error(i):.2e}")
