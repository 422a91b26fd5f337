"""The port's public surface against slepc_tpu's, name by name.

Every public function, class and method of every module of ``slepc_tpu/``
(read with ``ast``, so the JAX package is not imported) must have its
counterpart in the same module of ``slepc_tpu_torch/`` (imported: a method
a port class inherits counts), and every name a package ``__init__`` of the
reference exports must be exported by the port's.  The exceptions are the
TPU-only names below, each with its reason, and the reference's second
names for what the port has under one name (ALIASES).  The same file holds the
exports and the dtype rule of the port's surface, and BV's refusal of a
transposed constraint block.
"""

import ast
import importlib
import inspect
import pathlib
import pkgutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import slepc_tpu_torch as tst
from slepc_tpu_torch.sys.dtypes import as_torch_dtype

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = REPO / "slepc_tpu"

# TPU machinery with no counterpart in the port: reason -> names, as
# "module" (a whole module), "module:name" or "module:Class.method", where
# "*" stands for any class of the module.
TPU_ONLY = {
    "the Pallas wrappers; their kernels are ops/dia.py (K1, K2, K5), "
    "ops/bv.py (K3), ops/rotate.py (K4) and ops/csr.py (K6) here": [
        "ops.dia_pallas", "ops.bv_pallas", "ops.rotate_pallas",
        "ops.ell_pallas"],
    "the split-complex tier: complex numbers as two real planes, for a TPU "
    "without complex Pallas; the port's complex kernels K1c-K6c take "
    "complex tensors": ["ops.complex_split", "eps.nhep_split"],
    "the Jacobi eigensolver for the TPU, where LAPACK's eigh is slow; the "
    "port's small eigenproblems run LAPACK on the host": ["ops.jacobi_eigh"],
    "the padded (rows, 512) layout of the Pallas kernels: the port's vectors "
    "are flat": [
        "*:*.pad", "*:*.unpad", "*:*.pad2d", "*:*.mask", "*:*.mask2d",
        "*:*.mult2d", "*:*.mult2d_block", "*:*.n_interior", "*:*.n_pad"],
    "JAX pytree hooks, which let jit trace an operator": [
        "*:*.tree_flatten", "*:*.tree_unflatten"],
    "the ELL / hybrid pack of a CSR matrix for the TPU; the port keeps CSR "
    "(K6)": ["mat.linop:AIJOperator.to_gell"],
    "the Pallas kernels under shard_map; the port's partitioned DIA form is "
    "HaloDIAOperator on the single-card kernels": [
        "parallel.halo_pallas:ShardedDIAPaddedOperator",
        "parallel.halo_pallas:ShardedDIAPaddedOperatorDS",
        "parallel.halo_pallas:dia_spmv_padded_sharded",
        "parallel.halo_pallas:dia_spmv_padded_ds_sharded",
        "parallel.halo_pallas:hyb_spmv_padded_sharded",
        "parallel:ShardedDIAPaddedOperator",
        "parallel:dia_spmv_padded_sharded",
        "parallel:hyb_spmv_padded_sharded"],
    "GSPMD placement of arrays on a device mesh; the port's ranks hold "
    "their rows themselves (sys/mesh.py RowMesh)": [
        "sys.mesh:row_sharding", "sys.mesh:replicated_sharding",
        "sys.mesh:device_put_rows", "sys.mesh:device_put_basis_t",
        "sys:row_sharding", "sys:replicated_sharding", "sys:device_put_rows",
        ":row_sharding", ":replicated_sharding", ":device_put_rows"],
    "the masked fixed-width forms that keep jit's shapes static (a 0/1 mask "
    "over all the basis columns); the port slices the basis, and its sweeps "
    "are orthog.orthogonalize_vec on K3": [
        "bv.orthog:project_coeffs", "bv.orthog:cgs_pass"],
    "the shard_map body of tsqr; the port's tsqr(X, mesh) runs the two "
    "stages over torch.distributed": ["bv.orthog:tsqr_shard_map"],
    "the host-orchestrated route around jit for applies that cannot be "
    "traced; the port's arnoldi_extend is that host loop already": [
        "bv.krylov:arnoldi_extend_host"],
}

# The reference's second names for what the port has under one name:
# "module:name" -> ("module:name" in the port, how a script reaches it).
ALIASES = {
    "sys.mesh:make_multihost_row_mesh": (
        "sys.mesh:make_row_mesh", "a torch.distributed group spans hosts "
        "already; make_row_mesh() is the mesh over all its ranks"),
    "parallel.halo_pallas:ShardedGELLPaddedOperator.from_aij": (
        "parallel.halo_pallas:ShardedGELLPaddedOperator",
        "the constructor takes the AIJOperator and the mesh"),
    "parallel.halo_pallas:ShardedGELLPaddedOperator.from_scipy": (
        "parallel.halo_pallas:ShardedGELLPaddedOperator",
        "the constructor, given AIJOperator.from_scipy(M)"),
}


def _tpu_only(module: str, name: str = "") -> bool:
    if f"{module}:{name}" in ALIASES:
        return True
    for names in TPU_ONLY.values():
        for entry in names:
            mod, _, qual = entry.partition(":")
            if not qual:
                if mod == module and ":" not in entry:
                    return True
                continue
            if mod not in ("*", module):
                continue
            cls, _, meth = qual.rpartition(".")
            if qual in (name, name.partition(".")[0]) or (
                    cls == "*" and name.endswith("." + meth)):
                return True
    return False


def _reference_modules():
    """(dotted module name under the package, ast tree) of every module."""
    for f in sorted(REFERENCE.rglob("*.py")):
        parts = list(f.relative_to(REFERENCE).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), ast.parse(f.read_text()), f.name


def _public_names(tree):
    """Public top-level functions and classes, and the classes' methods."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            yield node.name
            if isinstance(node, ast.ClassDef):
                for b in node.body:
                    if isinstance(b, ast.FunctionDef) \
                            and not b.name.startswith("_"):
                        yield f"{node.name}.{b.name}"


def _exports(tree):
    """The names a package __init__ exports: its __all__ and every name its
    imports bind."""
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            names |= set(ast.literal_eval(node.value))
        elif isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _port(module: str):
    name = "slepc_tpu_torch" + (f".{module}" if module else "")
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError:
        return None


def _has(obj, qual: str) -> bool:
    for part in qual.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def test_every_public_name_has_its_counterpart():
    missing, checked = [], 0
    for module, tree, _ in _reference_modules():
        port = _port(module)
        if port is None:
            if not _tpu_only(module):
                missing.append(f"module slepc_tpu.{module}")
            continue
        assert not _tpu_only(module), f"{module} is ported; drop it from " \
                                      f"TPU_ONLY"
        for name in _public_names(tree):
            checked += 1
            if not _has(port, name) and not _tpu_only(module, name):
                missing.append(f"slepc_tpu.{module}:{name}")
    assert checked > 500
    assert not missing, "no counterpart in slepc_tpu_torch:\n" + "\n".join(
        missing)


def test_every_export_has_its_counterpart():
    missing = []
    for module, tree, fname in _reference_modules():
        if fname != "__init__.py":
            continue
        port = _port(module)
        for name in sorted(_exports(tree)):
            if not hasattr(port, name) and not _tpu_only(module, name):
                missing.append(f"slepc_tpu.{module or '<package>'}:{name}")
    assert not missing, "not exported by slepc_tpu_torch:\n" + "\n".join(
        missing)


def test_tpu_only_names_exist_in_the_reference():
    """Every entry of the list names something the reference has (a stale
    entry would hide a real gap)."""
    have = {}
    for module, tree, fname in _reference_modules():
        have[module] = set(_public_names(tree))
        if fname == "__init__.py":
            have[module] |= _exports(tree)
    for names in TPU_ONLY.values():
        for entry in names:
            mod, _, qual = entry.partition(":")
            if not qual:
                assert mod in have, entry
            elif mod == "*":
                meth = qual.rpartition(".")[2]
                assert any(n.endswith("." + meth) for v in have.values()
                           for n in v), entry
            else:
                assert qual in have[mod], entry
    for entry, (target, _) in ALIASES.items():
        mod, _, qual = entry.partition(":")
        assert qual in have[mod], entry
        tmod, _, tqual = target.partition(":")
        assert _has(_port(tmod), tqual), target


def test_the_exports_of_the_surface():
    from slepc_tpu_torch import bv, mat, sys as tsys
    from slepc_tpu_torch.bv.bv import OrthogBlockType, OrthogRefine, OrthogType

    assert tst.OrthogType is bv.OrthogType is OrthogType
    assert tst.OrthogRefine is OrthogRefine
    assert tst.OrthogBlockType is OrthogBlockType
    assert {t.value for t in OrthogType} == {"cgs", "mgs"}
    assert {"OrthogType", "OrthogRefine", "OrthogBlockType"} <= set(
        tst.__all__) and "OrthogType" in bv.__all__
    assert inspect.ismodule(mat.petsc_io) and mat.markov is tst.markov
    assert tsys.get_mesh is tst.get_mesh and tsys.set_mesh is tst.set_mesh
    assert {"get_mesh", "set_mesh"} <= set(tsys.__all__)
    assert {"markov", "petsc_io"} <= set(mat.__all__)
    A = mat.markov(5, device="cpu")
    assert A.shape == (15, 15)


def test_bv_takes_constraints_as_columns():
    n = 40
    C = np.random.default_rng(0).standard_normal((n, 2))
    bv = tst.BV(n, 4, device="cpu")
    with pytest.raises(ValueError, match=r"\(n, k\)"):
        bv.insert_constraints(C.T)  # (2, 40): c rows of length n
    with pytest.raises(ValueError, match=r"\(n, k\)"):
        bv.insert_constraints(np.random.default_rng(1).standard_normal((3, 3)))
    assert bv.nc == 0 and bv.array.shape == (4, n)
    assert bv.insert_constraints(C) == 2 and bv.array.shape == (6, n)
    Q = bv.array[:2].numpy()
    np.testing.assert_allclose(Q @ Q.T, np.eye(2), atol=1e-14)
    # the constraints span C's columns
    np.testing.assert_allclose(Q.T @ (Q @ C), C, atol=1e-12)


# ---- the dtype rule ----------------------------------------------------------

def _petsc_file(tmp_path):
    path = str(tmp_path / "m.petsc")
    tst.write_petsc_matrix(path, sp.random(6, 6, density=0.5, random_state=0,
                                           format="csr"))
    return path


REAL = (np.float32, np.float64)
ALL = REAL + (np.complex64, np.complex128)
# every public constructor and exported function that takes ``dtype``:
# name -> (call(dtype, tmp_path) giving its result's dtype, the dtypes)
DTYPE_CALLS = {
    "BV": (lambda dt, p: tst.BV(5, 2, dtype=dt, device="cpu").dtype, ALL),
    "ShellOperator": (lambda dt, p: tst.ShellOperator(
        (4, 4), dt, lambda x: x, device="cpu").dtype, ALL),
    "IdentityOperator": (lambda dt, p: tst.IdentityOperator(
        4, dtype=dt, device="cpu").dtype, ALL),
    "AIJOperator.from_scipy": (lambda dt, p: tst.AIJOperator.from_scipy(
        sp.eye(4, format="csr"), dtype=dt, device="cpu").dtype, ALL),
    "from_scipy": (lambda dt, p: tst.from_scipy(
        sp.eye(4, format="csr"), dtype=dt, device="cpu").dtype, ALL),
    "laplacian_1d": (lambda dt, p: tst.laplacian_1d(
        5, dtype=dt, device="cpu").dtype, ALL),
    "laplacian_2d": (lambda dt, p: tst.laplacian_2d(
        3, 4, dtype=dt, device="cpu").dtype, ALL),
    "laplacian_3d": (lambda dt, p: tst.laplacian_3d(
        2, 3, 4, dtype=dt, device="cpu").dtype, ALL),
    "random_sparse": (lambda dt, p: tst.random_sparse(
        6, density=0.5, dtype=dt, device="cpu").dtype, ALL),
    "markov": (lambda dt, p: tst.markov(4, dtype=dt, device="cpu").dtype, ALL),
    "from_complex_dia": (lambda dt, p: tst.from_complex_dia(
        (0, 1), np.ones((2, 3)) * (1 + 1j), dtype=dt, device="cpu").dtype,
        REAL),
    "load_operator": (lambda dt, p: tst.load_operator(
        _petsc_file(p), dtype=dt, device="cpu").dtype, REAL),
    # the file's scalars are float64 (PETSc's binary format); dtype says
    # whether they come in (re, im) pairs
    "read_petsc_matrix": (lambda dt, p: as_torch_dtype(dt) if
                          tst.read_petsc_matrix(_petsc_file(p), dtype=dt).dtype
                          == np.float64 else None, REAL),
}


def _dtype_callables():
    """Every public callable of the package's exports (and its subpackages')
    whose signature has ``dtype``: classes by their constructor and class
    methods."""
    found = set()
    mods = [tst] + [importlib.import_module(f"slepc_tpu_torch.{m.name}")
                    for m in pkgutil.iter_modules(tst.__path__) if m.ispkg]
    for mod in mods:
        for name in getattr(mod, "__all__", ()):
            obj = getattr(mod, name)
            cands = []
            if inspect.isclass(obj):
                cands.append((name, obj.__init__))
                cands += [(f"{name}.{a}", v.__func__) for a, v in
                          vars(obj).items() if isinstance(v, classmethod)]
            elif callable(obj):
                cands.append((name, obj))
            for qual, fn in cands:
                try:
                    params = inspect.signature(fn).parameters
                except (TypeError, ValueError):
                    continue
                if "dtype" in params:
                    found.add(qual)
    return found


def test_the_dtype_sweep_covers_every_callable_that_takes_dtype():
    assert _dtype_callables() == set(DTYPE_CALLS)


@pytest.mark.parametrize("name", sorted(DTYPE_CALLS))
def test_numpy_and_torch_dtypes_are_one_rule(name, tmp_path):
    call, dtypes = DTYPE_CALLS[name]
    for dt in dtypes:
        want = torch.from_numpy(np.empty(0, dt)).dtype
        assert call(dt, tmp_path) == want, (name, dt)             # numpy type
        assert call(np.dtype(dt), tmp_path) == want, (name, dt)   # np.dtype
        assert call(want, tmp_path) == want, (name, dt)           # torch


def test_the_names_added_for_the_reference_behave():
    """The names the surface added as the reference's: the device-built
    Laplacian is laplacian_3d, the filtered operator counts its base's
    nonzeros once a degree."""
    from slepc_tpu_torch.mat.generators import laplacian_3d_device
    from slepc_tpu_torch.st.cheb import ChebAmplifyOperator

    A = laplacian_3d_device(3, 4, 5, dtype=np.float32, device="cpu")
    B = tst.laplacian_3d(3, 4, 5, dtype=torch.float32, device="cpu")
    assert A.offsets == B.offsets and torch.equal(A.diags, B.diags)
    assert ChebAmplifyOperator(B, 0.0, 12.0, 7).nnz == 7 * B.nnz
