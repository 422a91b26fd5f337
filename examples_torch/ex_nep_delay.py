"""Delay differential equation NEP: T(lambda) = -lambda I + A + e^{-tau
lambda} B, solved with NLEIGS (rational interpolation + compact TOAR).

Reference analog: src/nep/tutorials/ex22.c (the delay problem).
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import slepc_tpu_torch

if os.environ.get("SLEPC_TPU_TORCH_DEVICE"):
    slepc_tpu_torch.set_default_device(os.environ["SLEPC_TPU_TORCH_DEVICE"])
import numpy as np

import slepc_tpu_torch as st

n, tau = 128, 1.0
h = np.pi / (n + 1)
main = np.full(n, -2.0 / (h * h))
off_u = np.zeros(n)
off_u[: n - 1] = 1.0 / (h * h)
off_l = np.zeros(n)
off_l[1:] = 1.0 / (h * h)
A0 = st.DIAOperator((-1, 0, 1), np.stack([off_l, main, off_u]))
xi = np.arange(1, n + 1) * h
A1 = st.DIAOperator((0,), (4.1 - xi * (1 - np.exp(xi - np.pi)))[None, :])
mI = st.DIAOperator((0,), -np.ones((1, n)))

nep = st.NEP(nev=3, solver="nleigs", target=-1.0, tol=1e-9)
# split form: T(lam) = lam*(-I) + 1*A0 + e^{-tau lam} * A1
fns = [st.FNRational([1.0, 0.0]), st.FNRational([1.0]), st.FNExp()]
fns[2].set_scale(-tau)
nep.set_split_operators([mI, A0, A1], fns)
nep.set_rg(st.RGEllipse(center=-1.0, radius=1.5, vscale=0.5))
nep.solve()
print(f"nconv={nep.nconv} its={nep.its}")
for i in range(nep.nconv):
    lam, x = nep.get_eigenpair(i)
    r = -lam * x + A0.mult(x) \
        + np.exp(-tau * lam) * A1.mult(x)
    x, r = x.cpu().numpy(), r.cpu().numpy()
    print(f"  lambda = {lam:.8f}   ||T(lam)x|| = "
          f"{np.linalg.norm(r) / np.linalg.norm(x):.2e}")
