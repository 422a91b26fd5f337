"""Port CGS2 panel sweeps (slepc_tpu_torch/ops/bv.py) against the Pallas
panel kernels of slepc_tpu/ops/bv_pallas.py (interpret mode).

The same basis, panel and coefficients, made with numpy from a seed, go
through slepc_tpu's kernels on the padded (K, R, 512) layout and the port's
wrappers on the flat (K, R*512) layout (plain PyTorch for CPU tensors).
Cases and tolerances are those of tests/test_bv_pallas.py: f32, 1e-5
relative (1e-4 for the dots of the fused update+dots).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slepc_tpu.ops import bv_pallas as bvp
from slepc_tpu_torch.ops import bv


@pytest.mark.parametrize("K,b,R", [(9, 1, 64), (9, 3, 64), (33, 8, 384)])
def test_panel_sweeps_match_pallas(K, b, R):
    rng = np.random.default_rng(0)
    V = rng.standard_normal((K, R, bvp.W)).astype(np.float32)
    Wb = rng.standard_normal((b, R, bvp.W)).astype(np.float32)
    C = rng.standard_normal((K, b)).astype(np.float32)
    tV = torch.from_numpy(V.reshape(K, -1))
    tW = torch.from_numpy(Wb.reshape(b, -1))
    tC = torch.from_numpy(C)

    def rel(port, ref, floor=0.0):
        port = port.numpy().reshape(np.shape(ref))
        ref = np.asarray(ref)
        return float(np.abs(port - ref).max() / (np.abs(ref).max() + floor))

    assert rel(bv.panel_dots(tV, tW), bvp.panel_dots(jnp.asarray(V),
                                                     jnp.asarray(Wb))) < 1e-5
    u_ref = bvp.panel_update(jnp.asarray(V), jnp.asarray(C), jnp.asarray(Wb))
    assert rel(bv.panel_update(tV, tC, tW), u_ref) < 1e-5
    u2_ref, d2_ref = bvp.panel_update_dots(jnp.asarray(V), jnp.asarray(C),
                                           jnp.asarray(Wb))
    u2, d2 = bv.panel_update_dots(tV, tC, tW)
    assert rel(u2, u2_ref) < 1e-5
    assert rel(d2, d2_ref, floor=1e-6) < 1e-4


def test_panel_sweeps_take_a_basis_prefix():
    """The Krylov cycle passes V[:j+1] of a taller basis: a row-strided
    prefix view must give the same result as a compact copy."""
    rng = np.random.default_rng(1)
    Vfull = torch.from_numpy(rng.standard_normal((12, 1000)))
    W = torch.from_numpy(rng.standard_normal((1, 1000)))
    V = Vfull[:5]
    C = bv.panel_dots(V, W)
    assert torch.allclose(C, V.clone() @ W.T, rtol=0, atol=1e-12)
    U, D = bv.panel_update_dots(V, C, W)
    assert torch.allclose(U, W - C.T @ V.clone(), rtol=0, atol=1e-12)
    assert torch.allclose(D, V.clone() @ U.T, rtol=0, atol=1e-12)
