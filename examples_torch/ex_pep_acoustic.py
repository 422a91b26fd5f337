"""Quadratic eigenproblem (lambda^2 M + lambda C + K) x = 0 — a damped
acoustic-wave style problem, solved with TOAR.

Reference analog: src/pep/tutorials/ex16.c (quadratic via PEP) with the
NLEVP acoustic_wave_1d coefficient pattern.
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import slepc_tpu_torch

if os.environ.get("SLEPC_TPU_TORCH_DEVICE"):
    slepc_tpu_torch.set_default_device(os.environ["SLEPC_TPU_TORCH_DEVICE"])
import numpy as np

import slepc_tpu_torch as st

n = 600
h = 1.0 / n
# stiffness: 1-D Laplacian; damping: impedance at the right boundary;
# mass: identity scaled by h (NLEVP acoustic_wave_1d pattern)
main = np.full(n, 2.0 / h)
main[-1] = 1.0 / h
off_u = np.zeros(n)
off_u[: n - 1] = -1.0 / h
off_l = np.zeros(n)
off_l[1:] = -1.0 / h
K = st.DIAOperator((-1, 0, 1), np.stack([off_l, main, off_u]))
cvec = np.zeros(n, complex)
cvec[-1] = 2j * np.pi  # boundary impedance (complex damping)
C = st.DIAOperator((0,), cvec[None, :].astype(complex))
mvec = np.full(n, 4.0 * np.pi ** 2 * h, complex)
mvec[-1] = 2.0 * np.pi ** 2 * h
M = st.DIAOperator((0,), mvec[None, :])

# acoustic-wave eigenvalues sit near the imaginary axis; target the
# first resonances
pep = st.PEP([K, C, M], nev=4, ncv=40, solver="toar",
             which="target_magnitude", target=0.5j, tol=1e-9)
pep.solve()
print(f"nconv={pep.nconv} its={pep.its}")
for i in range(pep.nconv):
    lam, x = pep.get_eigenpair(i)
    r = K.mult(x) + lam * C.mult(x) \
        + lam ** 2 * M.mult(x)
    x, r = x.cpu().numpy(), r.cpu().numpy()
    print(f"  lambda = {lam:.8f}   ||P(lam)x|| = "
          f"{np.linalg.norm(r) / np.linalg.norm(x):.2e}")
