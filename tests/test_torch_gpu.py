"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and the CUDA toolkit, so they skip on a CPU-only
host.  Run them on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest`` because tests/conftest.py sets up JAX, which the port's
machine need not have).  Shapes are small and odd on purpose: ragged tiles,
strided basis prefixes, offsets at and past the vector ends.
"""

import numpy as np
import pytest
import torch

from slepc_tpu_torch.ops import bv, dia, rotate

pytestmark = pytest.mark.gpu

DTYPES = [(torch.float32, 2e-6), (torch.float64, 1e-14)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rand(shape, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n,offsets", [
    (1, (0,)), (7, (-9, -1, 0, 1, 9)), (1000, (-200, -1, 0, 1, 200)),
    (45_013, (-45_000, -200, -1, 0, 1, 200, 45_000))])
def test_dia_kernel_matches_plain(cuda, dtype, tol, n, offsets):
    d = _rand((len(offsets), n), dtype, cuda, 0)
    x = _rand((n,), dtype, cuda, 1)
    before = dict(dia.launches)
    y = dia.dia_spmv(offsets, d, x)
    ref = dia.dia_spmv_ref(offsets, d, x)
    torch.cuda.synchronize()
    scale = dia.dia_spmv_ref(offsets, d.abs(), x.abs()).max()
    assert float((y - ref).abs().max() / scale) <= 4 * tol
    key = "dia_spmv_f64" if dtype == torch.float64 else "dia_spmv_f32"
    assert dia.launches[key] == before[key] + 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("K,b,n", [(1, 1, 1), (9, 3, 130), (33, 8, 4097),
                                   (49, 1, 100_003), (64, 2, 777)])
def test_panel_kernels_match_plain(cuda, dtype, tol, K, b, n):
    # V is the prefix of a taller basis, as in the Krylov cycle
    Vfull = _rand((K + 3, n), dtype, cuda, 2)
    V = Vfull[:K]
    W = _rand((b, n), dtype, cuda, 3)
    C = _rand((K, b), dtype, cuda, 4)
    dscale = V.abs() @ W.abs().T
    uscale = W.abs() + C.abs().T @ V.abs()
    D = bv.panel_dots(V, W)
    assert float(((D - bv.panel_dots_ref(V, W)).abs() / dscale).max()) <= tol
    U = bv.panel_update(V, C, W)
    U_ref = bv.panel_update_ref(V, C, W)
    assert float(((U - U_ref).abs() / uscale).max()) <= tol
    U2, D2 = bv.panel_update_dots(V, C, W)
    assert float(((U2 - U_ref).abs() / uscale).max()) <= tol
    d2scale = V.abs() @ U_ref.abs().T
    assert float(((D2 - V @ U_ref.T).abs() / d2scale).max()) <= 10 * tol
    # deterministic: no atomics, same bits every time
    assert torch.equal(bv.panel_dots(V, W), D)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-14)])
@pytest.mark.parametrize("K,P,n", [(1, 1, 1), (24, 18, 4096 + 5),
                                   (48, 40, 100_003), (64, 64, 333)])
def test_rotate_kernel_matches_plain(cuda, dtype, tol, K, P, n):
    V = _rand((K + 1, n), dtype, cuda, 5)[:K]
    Q = _rand((K, P), dtype, cuda, 6)
    out = rotate.rotate(Q, V)
    err = (out - rotate.rotate_ref(Q, V)).abs() / (Q.abs().T @ V.abs())
    assert float(err.max()) <= tol


def test_kernels_reject_what_they_do_not_take(cuda):
    V = torch.zeros((4, 10), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        bv.panel_dots(V, torch.zeros((9, 10), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        bv.panel_dots(V, torch.zeros((1, 10), dtype=torch.float32, device=cuda))
    with pytest.raises(TypeError):
        dia.dia_spmv((0,), torch.zeros((1, 10), dtype=torch.float16, device=cuda),
                     torch.zeros(10, dtype=torch.float16, device=cuda))
