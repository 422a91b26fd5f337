"""One port Krylov-Schur restart cycle (slepc_tpu_torch/eps/ks_jit.py)
against slepc_tpu's jitted cycle, from the same start vector.

The operator and the start vector go to both packages through
slepc_tpu_torch.interop; the JAX side runs its Pallas kernels in interpret
mode.  Eigenvectors of the projected problem are defined up to sign, and
the two LAPACK calls may pick different signs, so basis rows (and the arrow
row of H, which carries the same signs) are compared after aligning each
row's sign.

* f64 on the double-single operator (24 x 24 Laplacian, block_rows=8):
  Ritz values and H within 1e-11, unpadded basis rows within 1e-10.
* f32 with the Pallas panel sweeps (orth="pallas", the
  tests/test_bv_pallas.py:46 case): Ritz values within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slepc_tpu.eps.ks_jit import ks_hep_cycle as jax_cycle
from slepc_tpu.mat.generators import laplacian_2d
from slepc_tpu.ops.dia_pallas import DIAPaddedOperator, DIAPaddedOperatorDS
from slepc_tpu_torch import interop
from slepc_tpu_torch.eps.ks_jit import ks_hep_cycle


def _port_cycle(top, v0, ncv, tol, which):
    V = torch.zeros((ncv + 1, v0.shape[0]), dtype=top.dtype)
    V[0] = torch.from_numpy(v0)
    H = np.zeros((ncv + 1, ncv), dtype=V[:0].numpy().dtype)
    gen = torch.Generator().manual_seed(0)
    return ks_hep_cycle(top, V, H, 0, tol, gen, ncv=ncv, which=which)


def test_f64_cycle_matches_double_single_reference():
    side, ncv, rb = 24, 10, 8
    A = laplacian_2d(side, side)
    jop = DIAPaddedOperatorDS.from_dia(A, block_rows=rb)
    top = interop.dia_from_slepc_tpu(jop, device="cpu")
    v0 = np.random.default_rng(5).standard_normal(side * side)
    v0 /= np.linalg.norm(v0)

    vp = jnp.asarray(interop.basis_to_padded(v0[None], rb)[0])
    Vj = jnp.zeros((ncv + 1,) + vp.shape, jnp.float64).at[0].set(vp)
    Hj = jnp.zeros((ncv + 1, ncv), jnp.float64)
    oj = jax_cycle(jop, Vj, Hj, jnp.asarray(0), 1e-8, jax.random.PRNGKey(0),
                   ncv=ncv, which="smallest")
    ot = _port_cycle(top, v0, ncv, 1e-8, "smallest")

    assert int(oj[2]) == ot[2] and int(oj[3]) == ot[3]  # kl, k2
    assert np.abs(np.asarray(oj[4]) - ot[4]).max() < 1e-11
    Vj_flat = interop.basis_from_padded(oj[0], side * side, rb)
    Vt = ot[0].numpy()
    sign = np.sign(np.sum(Vj_flat * Vt, axis=1))
    assert np.abs(Vj_flat - sign[:, None] * Vt).max() < 1e-10
    Hj_np, Ht = np.asarray(oj[1]), ot[1].copy()
    kl = ot[2]
    Ht[kl, :ncv] *= sign[:ncv]  # arrow row: beta * Q[last, p] per column p
    assert np.abs(Hj_np - Ht).max() < 1e-11


def test_f32_cycle_matches_pallas_sweeps():
    side, ncv = 90, 12
    A = laplacian_2d(side, side, dtype=np.float32)
    jop = DIAPaddedOperator.from_dia(A)
    top = interop.dia_from_slepc_tpu(jop, device="cpu")
    x0 = jop.pad2d(jnp.ones((A.shape[0],), np.float32))
    v0 = x0 / jnp.linalg.norm(x0)
    Vj = jnp.zeros((ncv + 1,) + x0.shape, np.float32).at[0].set(v0)
    Hj = jnp.zeros((ncv + 1, ncv), np.float32)
    oj = jax_cycle(jop, Vj, Hj, jnp.asarray(0), 1e-5, jax.random.PRNGKey(0),
                   ncv=ncv, which="largest", orth="pallas")
    ones = np.ones(side * side, np.float32)
    ot = _port_cycle(top, ones / np.linalg.norm(ones), ncv, 1e-5, "largest")
    assert np.abs(np.asarray(oj[4]) - ot[4]).max() < 1e-4


@pytest.mark.parametrize("kw", [{"rot_mode": "mixed"}, {"rot_mode": "hybrid"}])
def test_unported_modes_raise_naming_the_roadmap(kw):
    # the light reorthogonalizations are ported: tests/test_torch_reorth.py
    top = interop.dia_from_slepc_tpu(laplacian_2d(6, 6), device="cpu")
    V = torch.zeros((5, 36), dtype=torch.float64)
    V[0, 0] = 1.0
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ks_hep_cycle(top, V, np.zeros((5, 4)), 0, 1e-8,
                     torch.Generator().manual_seed(0), ncv=4, **kw)
