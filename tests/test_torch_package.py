"""Package-level properties of slepc_tpu_torch.

* It never imports JAX (nor slepc_tpu): checked in a fresh interpreter,
  where every module of the package is imported with JAX imports blocked,
  and by reading the sources of the package and of chip_smoke.py.
* Every constructor and generator defaults to the CUDA card: without one,
  ``device=None`` raises and names ``device="cpu"``; a tensor handed in
  keeps its device.
* interop carries a padded basis and a double-single operator across
  exactly.
* Work on CPU tensors takes the plain PyTorch versions: no kernel launch
  counter moves.
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from slepc_tpu.mat.generators import laplacian_3d
from slepc_tpu.ops.dia_pallas import DIAPaddedOperatorDS
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop

ROOT = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL_WITHOUT_JAX = r"""
import importlib, pkgutil, sys
for m in [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')]:
    del sys.modules[m]

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'slepc_tpu'):
            raise ImportError('blocked import of ' + name)

sys.meta_path.insert(0, Block())
import slepc_tpu_torch
for info in pkgutil.walk_packages(slepc_tpu_torch.__path__, 'slepc_tpu_torch.'):
    importlib.import_module(info.name)
print('imported', 'jax' in sys.modules)
"""


def test_import_leaves_jax_out():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, slepc_tpu_torch; print('jax' in sys.modules)"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL_WITHOUT_JAX],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported False"


def test_sources_do_not_import_jax():
    import re

    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|slepc_tpu)\b(?!_torch)",
                     re.M)
    paths = list((ROOT / "slepc_tpu_torch").rglob("*.py"))
    assert len(paths) > 30
    for path in paths + [ROOT / "chip_smoke.py"]:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert not bad.search(text), path


_NO_CARD = [
    ("laplacian_1d", lambda: tst.laplacian_1d(8)),
    ("laplacian_2d", lambda: tst.laplacian_2d(4, 3)),
    ("laplacian_3d", lambda: tst.laplacian_3d(3, 3, 3)),
    ("from_scipy", lambda: tst.from_scipy(__import__("scipy.sparse").sparse.identity(4))),
    ("AIJOperator.from_scipy", lambda: tst.AIJOperator.from_scipy(
        __import__("scipy.sparse").sparse.identity(4))),
    ("random_sparse", lambda: tst.random_sparse(10, density=0.2)),
    ("from_dense", lambda: tst.from_dense(np.eye(3))),
    ("DenseOperator", lambda: tst.DenseOperator(np.eye(3))),
    ("DIAOperator", lambda: tst.DIAOperator((0,), np.ones((1, 4)))),
    ("DiagonalOperator", lambda: tst.DiagonalOperator(np.ones(4))),
    ("IdentityOperator", lambda: tst.IdentityOperator(4)),
    ("ShellOperator", lambda: tst.ShellOperator((4, 4), torch.float64,
                                                lambda x: x)),
    ("aslinearoperator", lambda: tst.aslinearoperator(np.eye(3))),
    ("load_operator", lambda: tst.load_operator("unused.petsc")),
    ("BV", lambda: tst.BV(8, 2)),
    ("interop", lambda: interop.dia_from_slepc_tpu(laplacian_3d(3, 3, 3))),
]


import pytest


@pytest.mark.parametrize("name,make", _NO_CARD, ids=[c[0] for c in _NO_CARD])
def test_device_none_without_a_card_raises_and_names_cpu(name, make, tmp_path,
                                                         monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: device=None is the card")
    if name == "load_operator":
        import scipy.sparse as sp

        tst.write_petsc_matrix(str(tmp_path / "unused.petsc"),
                               sp.identity(4, format="csr"))
        monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()


def test_a_tensor_handed_in_keeps_its_device():
    d = torch.ones((1, 4), dtype=torch.float64)
    assert tst.DIAOperator((0,), d).device == d.device
    assert tst.DenseOperator(torch.eye(3)).device.type == "cpu"
    assert tst.DiagonalOperator(d[0]).device.type == "cpu"
    A = tst.laplacian_1d(6, device="cpu")
    assert A.shifted(0.5).device.type == "cpu"  # the identity follows A
    st = tst.STSinvert([A], sigma=0.5)
    assert st.op().device.type == "cpu" and st.ksp.A.device.type == "cpu"


def test_interop_round_trips_padded_basis_and_ds_operator_exactly():
    rng = np.random.default_rng(0)
    n, rb = 7 * 6 * 5, 8
    V = rng.standard_normal((3, n))
    Vp = interop.basis_to_padded(V, rb)
    assert Vp.shape == (3, 3 * rb, 512)
    assert np.array_equal(interop.basis_from_padded(Vp, n, rb), V)
    assert np.array_equal(interop.basis_to_padded(
        interop.basis_from_padded(Vp, n, rb), rb), Vp)

    A = laplacian_3d(7, 6, 5)
    diags = np.asarray(A.diags) * (1.0 + 1e-3 * rng.standard_normal(
        np.asarray(A.diags).shape))  # values with low-order bits set
    from slepc_tpu.mat.linop import DIAOperator as JDIA
    jop = DIAPaddedOperatorDS.from_dia(JDIA(A.offsets, diags), block_rows=rb)
    top = interop.dia_from_slepc_tpu(jop, device="cpu")
    offsets, dph, dpl, nn = interop.dia_to_padded_ds(top, block_rows=rb)
    assert offsets == jop.offsets and nn == n
    assert np.array_equal(dph, np.asarray(jop.dph))
    assert np.array_equal(dpl, np.asarray(jop.dpl))
    back = DIAPaddedOperatorDS(offsets, jnp.asarray(dph), jnp.asarray(dpl), nn,
                               rb)
    x = rng.standard_normal(n)
    y1 = np.asarray(jop.mult2d(jop.pad2d(jnp.asarray(x))))
    y2 = np.asarray(back.mult2d(back.pad2d(jnp.asarray(x))))
    assert np.array_equal(y1, y2)


def test_cpu_work_launches_no_kernel():
    tst.reset_launch_counts()
    eps = tst.EPS(tst.laplacian_2d(12, 11, device="cpu"), problem_type="hep",
                  which="smallest_real", nev=3,
                  options=tst.Options.from_cli("-eps_cheb_degree 20"))
    eps.solve()
    assert eps.nconv >= 3
    eps = tst.EPS(tst.laplacian_1d(40, device="cpu"), problem_type="hep",
                  which="largest_real", nev=2)
    eps.solve()
    assert eps.nconv >= 2
    assert all(v == 0 for v in tst.launch_counts().values())


def test_event_log_with_sync_on_cpu():
    tst.log_begin()
    try:
        with tst.log_event("probe", flops=10.0, sync=True):
            torch.ones(3).sum()
        from slepc_tpu_torch.sys.events import get_event

        ev = get_event("probe")
        assert ev["count"] == 1 and ev["flops"] == 10.0
    finally:
        tst.log_reset()
