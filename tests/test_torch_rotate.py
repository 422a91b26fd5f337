"""Port restart rotation (slepc_tpu_torch/ops/rotate.py) against the
double-single Pallas rotation of slepc_tpu/ops/rotate_pallas.py (interpret
mode), at the shapes of tests/test_round5.py (TestDSRotateKernel).

The port computes in native f64 and the reference in double-single
(~1e-15), so both agree with each other to 5e-14 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slepc_tpu.ops.rotate_pallas import rotate_basis_ds
from slepc_tpu_torch.ops import rotate


@pytest.mark.parametrize("K,P,R,W,orth,rb", [
    (24, 18, 16, 256, True, 8),    # orthonormal Q
    (6, 4, 12, 128, False, 16),    # R not divisible by the default Rb
    (8, 6, 72, 128, False, 8),     # uneven tail
])
def test_rotation_matches_double_single_kernel(K, P, R, W, orth, rb):
    rng = np.random.default_rng(7)
    V = rng.standard_normal((K, R, W))
    if orth:
        Qm, _ = np.linalg.qr(rng.standard_normal((K, K)))
        Q = Qm[:, :P]
    else:
        Q = rng.standard_normal((K, P)) / K
    ref = np.asarray(rotate_basis_ds(jnp.asarray(Q), jnp.asarray(V),
                                     block_rows=rb, interpret=True))
    out = rotate.rotate(torch.from_numpy(np.ascontiguousarray(Q)),
                        torch.from_numpy(V.reshape(K, -1))).numpy()
    err = np.abs(out.reshape(ref.shape) - ref).max() / np.abs(ref).max()
    assert err < 5e-14, err


def test_rotation_of_a_basis_prefix():
    """The cycle rotates V[:ncv] of an (ncv+1, n) basis in place of a copy."""
    rng = np.random.default_rng(8)
    V = torch.from_numpy(rng.standard_normal((11, 300)))
    Q = torch.from_numpy(rng.standard_normal((10, 7)))
    out = rotate.rotate(Q, V[:10])
    assert out.shape == (7, 300)
    assert torch.allclose(out, Q.T @ V[:10].clone(), rtol=0, atol=1e-13)
