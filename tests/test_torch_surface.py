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


# ---- the array rule ----------------------------------------------------------
#
# Every public method or function of the algebra layer that takes a vector or
# a block takes a numpy array wherever the reference takes one: the array
# goes to the operator's device (a free function's: its other tensors', else
# the default device), takes the tensor's path, and comes back as a tensor.
# The sweep calls each with numpy f64 (and c128 where the reference takes
# complex), holds the answer against the same call on CPU tensors and against
# the reference's call on the same arrays (values within 1e-12, the same
# dtype), and an ast walk holds the list to every such callable.

N = 24
_R = np.random.default_rng(5)
DIA_D = _R.standard_normal((3, N))
DIA_D[0, 0] = DIA_D[2, -1] = 0.0  # the entries outside the matrix are zero
DENSE = _R.standard_normal((N, N))
SPD = DENSE @ DENSE.T + N * np.eye(N)
AIJ = (sp.random(N, N, density=0.2, random_state=1) + sp.eye(N)).tocsr()
TRI_A = 2.0 + 0.1 * _R.standard_normal(N)
TRI_B = -1.0 + 0.05 * _R.standard_normal(N - 1)
X64 = _R.standard_normal(N)
XC = X64 + 1j * _R.standard_normal(N)
XB = _R.standard_normal((3, N))
B2D = sp.kron(sp.eye(6), sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (4, 4))) \
    + sp.diags([-1.0, -1.0], [-4, 4], (N, N))  # 6 blocks of 4, symmetric
B2D = B2D.toarray()
AB = np.stack([B2D[4 * i: 4 * i + 4, 4 * i: 4 * i + 4] for i in range(6)])
BB = np.stack([B2D[4 * i + 4: 4 * i + 8, 4 * i: 4 * i + 4]
               for i in range(5)])


def _dia_dense(offsets, d):
    A = np.zeros((d.shape[1],) * 2, d.dtype)
    for k, o in enumerate(offsets):
        for i in range(max(0, -o), min(d.shape[1], d.shape[1] - o)):
            A[i, i + o] = d[k, i]
    return A


DIA_M = _dia_dense((-1, 0, 1), DIA_D)
TRI_M = np.diag(TRI_A) + np.diag(TRI_B, 1) + np.diag(TRI_B, -1)


def _m(P, name):
    return importlib.import_module(f"{P.__name__}.{name}")


def _dia(P):
    return P.DIAOperator((-1, 0, 1), DIA_D)


def _dense(P, M=DENSE):
    return P.DenseOperator(M)


def _tridiag(P):
    return P.DIAOperator((-1, 0, 1), np.stack(
        [np.r_[0.0, TRI_B], TRI_A, np.r_[TRI_B, 0.0]]))


def _cheb(P):
    return _m(P, "st.cheb").ChebAmplifyOperator(_tridiag(P), 2.5, 3.0, 5)


def _cheb_dense(x, rows=False):
    w, U = np.linalg.eigh(TRI_M)
    p = _m(tst, "st.cheb").cheb_value(w, 2.5, 3.0, 5)
    M = U @ np.diag(p) @ U.T
    return (M @ x.T).T if rows else M @ x


def _filter_op(P):
    return _m(P, "st.filter").FilterOperator(_tridiag(P), [0.5, 0.3, 0.2],
                                             2.0, 3.0)


def _filter_dense(x, rows=False):
    S = (TRI_M - 2.0 * np.eye(N)) / 3.0
    M = 0.5 * np.eye(N) + 0.3 * S + 0.2 * (2 * S @ S - np.eye(N))
    return (M @ x.T).T if rows else M @ x


class Case:
    """``call(P, c)`` runs the call in package P with every array argument
    passed through c; ``ref``: "same" (the reference's same call answers),
    a callable (the reference's form of the call), None (the reference has
    no such call) or an exception name (the reference raises: a
    reference-side divergence); ``truth()`` the answer from numpy / scipy
    (None: the tensor call alone); ``xs``: the operands tried."""

    def __init__(self, call, truth=None, ref="same", complex_=True,
                 operand=True):
        self.call, self.truth, self.ref = call, truth, ref
        self.complex_ = complex_
        self.operand = operand  # False: the matrix arguments are the arrays


def _op_cases(cls, make, M, block=False, complex_=True, ref="same"):
    out = {
        f"mat.linop:{cls}.mult": Case(
            lambda P, c, x: make(P).mult(c(x)), lambda x: M @ x, ref,
            complex_),
        f"mat.linop:{cls}.mult_h": Case(
            lambda P, c, x: make(P).mult_h(c(x)),
            lambda x: M.conj().T @ x, ref, complex_)}
    if block:
        out[f"mat.linop:{cls}.mult_block"] = Case(
            lambda P, c, x: make(P).mult_block(c(np.stack([x, 2 * x]))),
            lambda x: np.stack([M @ x, 2 * M @ x]),
            lambda P, c, x: make(P).mult(c(np.stack([x, 2 * x]).T)).T,
            complex_)
    return out


def _ksp(P, **kw):
    return _m(P, "ksp.ksp").KSP(_tridiag(P), **kw)


def _td(P):
    return _m(P, "ksp.tridiag_device")


def _spd_solve(name):
    return Case(lambda P, c, x: getattr(_m(P, "ksp.ksp"), name)(
        _dense(P, SPD).mult, c(x), rtol=1e-14),
        lambda x: np.linalg.solve(SPD, x), None, complex_=False)


def _solve_tri(x):
    return np.linalg.solve(TRI_M, x)


def _on_ranks(*_):
    raise AssertionError("held on gloo ranks")


# a rank's operators run under torch.distributed: their numpy shards are held
# on gloo ranks by tests/test_torch_parallel.py::test_halo_takes_numpy_shards
ON_RANKS = ("parallel.halo:SlabOperator.mult",
            "parallel.halo:SlabOperator.mult_block",
            "parallel.halo:HaloDIAOperator.mult_h",
            "parallel.halo:HaloDIAOperator.rmult",
            "parallel.halo:dia_spmv_halo", "parallel.halo:dia_spmm_halo",
            "parallel.halo_pallas:ShardedGELLPaddedOperator.mult_h")

ARRAY_CALLS = {
    **_op_cases("DenseOperator", _dense, DENSE),
    **_op_cases("DIAOperator", _dia, DIA_M, block=True),
    # the reference's jitted ELL gather cannot take a numpy array (F6)
    **_op_cases("AIJOperator", lambda P: P.from_scipy(AIJ), AIJ.toarray(),
                ref="TracerArrayConversionError"),
    **_op_cases("ShellOperator", lambda P: P.ShellOperator(
        (N, N), np.float64, _dense(P).mult, _dense(P).mult_h), DENSE),
    **_op_cases("ScaledOperator", lambda P: 2.5 * _dia(P), 2.5 * DIA_M),
    **_op_cases("SumOperator", lambda P: _dia(P) + _dense(P), DIA_M + DENSE),
    **_op_cases("ProductOperator", lambda P: _dia(P) @ _dense(P),
                DIA_M @ DENSE),
    **_op_cases("AdjointOperator", lambda P: _dia(P).H, DIA_M.T),
    **_op_cases("DiagonalOperator",
                lambda P: _m(P, "mat.linop").DiagonalOperator(TRI_A),
                np.diag(TRI_A)),
    "mat.linop:IdentityOperator.mult": Case(
        lambda P, c, x: P.IdentityOperator(N, np.float64).mult(c(x)),
        lambda x: x),
    # the one-mult-a-row block of an operator with no block product of its
    # own (the reference has no mult_block: its mult takes columns)
    "mat.linop:LinearOperator.mult_block": Case(
        lambda P, c, x: P.from_scipy(AIJ).mult_block(c(np.stack([x, -x]))),
        lambda x: np.stack([AIJ @ x, -(AIJ @ x)]), None),
    "ksp.direct:DirectSolver.solve": Case(
        lambda P, c, x: _m(P, "ksp.direct").DirectSolver(_tridiag(P)).solve(
            c(x)), _solve_tri, complex_=False),
    "ksp.direct:DirectSolver.solve_h": Case(
        lambda P, c, x: _m(P, "ksp.direct").DirectSolver(
            _tridiag(P)).solve_h(c(x)), _solve_tri, complex_=False),
    "ksp.ksp:KSP.solve": Case(
        lambda P, c, x: _ksp(P, method="cg", rtol=1e-14).solve(c(x)),
        _solve_tri, complex_=False),
    "ksp.ksp:KSP.solve_h": Case(
        lambda P, c, x: _ksp(P, method="direct").solve_h(c(x)), _solve_tri,
        None, complex_=False),
    "ksp.ksp:solve_linear": Case(
        lambda P, c, x: _m(P, "ksp.ksp").solve_linear(_tridiag(P), c(x)),
        _solve_tri, complex_=False),
    # the port's own iterative solvers (the reference calls jax.scipy's)
    "ksp.ksp:cg": _spd_solve("cg"),
    "ksp.ksp:minres": _spd_solve("minres"),
    "ksp.ksp:bicgstab": _spd_solve("bicgstab"),
    "ksp.ksp:gmres": _spd_solve("gmres"),
    "ksp.iterative_jit:cg_fixed": Case(
        lambda P, c, x: _m(P, "ksp.iterative_jit").cg_fixed(
            _dense(P, SPD).mult, c(x), 200),
        lambda x: np.linalg.solve(SPD, x), complex_=False),
    "ksp.iterative_jit:minres_fixed": Case(
        lambda P, c, x: _m(P, "ksp.iterative_jit").minres_fixed(
            _dense(P, SPD).mult, c(x), 200),
        lambda x: np.linalg.solve(SPD, x), complex_=False),
    "ksp.tridiag_device:tridiag_pivots": Case(
        lambda P, c, x: _td(P).tridiag_pivots(c(TRI_A), c(TRI_B), 0.3),
        None, complex_=False, operand=False),
    "ksp.tridiag_device:tridiag_inertia": Case(
        lambda P, c, x: _td(P).tridiag_inertia(c(TRI_A), c(TRI_B), 2.0),
        lambda x: np.sum(np.linalg.eigvalsh(TRI_M) < 2.0), complex_=False,
        operand=False),
    "ksp.tridiag_device:tridiag_solve": Case(
        lambda P, c, x: _td(P).tridiag_solve(c(TRI_A), c(TRI_B), 0.3, c(x)),
        lambda x: np.linalg.solve(TRI_M - 0.3 * np.eye(N), x),
        complex_=False),
    "ksp.tridiag_device:btridiag_pivots": Case(
        lambda P, c, x: _td(P).btridiag_pivots(c(AB), c(BB), 0.3), None,
        complex_=False, operand=False),
    "ksp.tridiag_device:btridiag_inertia": Case(
        lambda P, c, x: _td(P).btridiag_inertia(c(AB), c(BB), 2.9),
        lambda x: np.sum(np.linalg.eigvalsh(B2D) < 2.9),
        complex_=False, operand=False),
    "ksp.tridiag_device:btridiag_solve": Case(
        lambda P, c, x: _td(P).btridiag_solve(c(AB), c(BB), 0.3, c(x)),
        lambda x: np.linalg.solve(B2D - 0.3 * np.eye(N), x),
        complex_=False),
    "ksp.tridiag_device:TridiagLDLDevice.solve": Case(
        lambda P, c, x: _td(P).TridiagLDLDevice(TRI_A, TRI_B, 0.3).solve(
            c(x)),
        lambda x: np.linalg.solve(TRI_M - 0.3 * np.eye(N), x),
        complex_=False),
    "st.cheb:ChebAmplifyOperator.mult": Case(
        lambda P, c, x: _cheb(P).mult(c(x)), _cheb_dense, complex_=False),
    "st.cheb:ChebAmplifyOperator.mult_block": Case(
        lambda P, c, x: _cheb(P).mult_block(c(np.stack([x, -x]))),
        lambda x: _cheb_dense(np.stack([x, -x]), rows=True),
        lambda P, c, x: _cheb(P).mult(c(np.stack([x, -x]).T)).T,
        complex_=False),
    # the reference has no FilterOperator (its filter is a closure) and its
    # SinvertCGOperator.mult takes the padded (rows, 512) layout
    "st.filter:FilterOperator.mult": Case(
        lambda P, c, x: _filter_op(P).mult(c(x)), _filter_dense, None,
        complex_=False),
    "st.filter:FilterOperator.mult_block": Case(
        lambda P, c, x: _filter_op(P).mult_block(c(np.stack([x, -x]))),
        lambda x: _filter_dense(np.stack([x, -x]), rows=True), None,
        complex_=False),
    "st.sinvert_jit:SinvertCGOperator.mult": Case(
        lambda P, c, x: _m(P, "st.sinvert_jit").SinvertCGOperator.from_dia(
            _tridiag(P), sigma=-0.5, iters=100).mult(c(x)),
        lambda x: np.linalg.solve(TRI_M + 0.5 * np.eye(N), x), None,
        complex_=False),
    "st.st:ST.apply": Case(
        lambda P, c, x: P.STShift([_dia(P)], 0.5).apply(c(x)),
        lambda x: (DIA_M - 0.5 * np.eye(N)) @ x),
    **{k: Case(_on_ranks) for k in ON_RANKS},
}

# public callables of the walk's modules whose vector-named parameters are
# not operands, with the reason
NOT_OPERANDS = {
    "mat.linop:as_operand": "the array rule itself",
    "mat.linop:apply_by_parts": "a helper the products call after the rule",
    "mat.linop:LinearOperator.mult": "abstract",
    "mat.linop:LinearOperator.mult_h": "abstract",
    "mat.structured:create_tile": "a, b, c, d are the blocks' coefficients",
}
_LAYOUT = ("the row layout of a rank's own slab tensors (views and in-place "
           "writes; local_rows takes numpy already), not a product")
NOT_OPERANDS.update({name: _LAYOUT for name in (
    "mat.linop:LinearOperator.local_rows", "mat.linop:LinearOperator.interior",
    "parallel.halo:SlabOperator.local_rows",
    "parallel.halo:SlabOperator.interior", "parallel.halo:SlabOperator.gather",
    "parallel.halo:SlabOperator.zero_halos")})

ARRAY_SCOPE = ("mat", "ksp", "st", "parallel/halo.py",
               "parallel/halo_pallas.py")
OPERAND_NAMES = {"x", "X", "b", "rhs", "Ab"}


def _operand_callables():
    """Every public function and class method of the array rule's modules
    with a parameter named as an operand, read with ast."""
    root = REPO / "slepc_tpu_torch"
    files = []
    for s in ARRAY_SCOPE:
        files += [root / s] if s.endswith(".py") else sorted(
            (root / s).glob("*.py"))
    found = set()
    for f in files:
        mod = ".".join(f.relative_to(root).with_suffix("").parts)
        for node in ast.parse(f.read_text()).body:
            defs = [("", node)] if isinstance(node, ast.FunctionDef) else [
                (node.name + ".", b) for b in getattr(node, "body", ())
                if isinstance(b, ast.FunctionDef)] \
                if isinstance(node, ast.ClassDef) \
                and not node.name.startswith("_") else []
            for prefix, fn in defs:
                if fn.name.startswith("_"):
                    continue
                if {a.arg for a in fn.args.args} & OPERAND_NAMES:
                    found.add(f"{mod}:{prefix}{fn.name}")
    return found


def test_the_array_sweep_covers_every_callable_that_takes_an_operand():
    assert _operand_callables() == set(ARRAY_CALLS) | set(NOT_OPERANDS)
    assert not set(ARRAY_CALLS) & set(NOT_OPERANDS)


@pytest.fixture(scope="module")
def cpu_default():
    tst.set_default_device("cpu")
    yield
    tst.set_default_device(None)


def _reference():
    """The JAX package, imported by the tests that call it (the name walk
    above reads it with ast)."""
    import slepc_tpu

    return slepc_tpu


def _host(y):
    return y.numpy() if torch.is_tensor(y) else np.asarray(y)


SWEEP = sorted(k for k in ARRAY_CALLS if k not in ON_RANKS)


@pytest.mark.parametrize("name", SWEEP)
def test_numpy_operands_follow_the_array_rule(name, cpu_default):
    case = ARRAY_CALLS[name]
    ref_pkg = _reference()
    for x in (X64, XC) if case.complex_ else (X64,):
        y = case.call(tst, lambda a: a, x)
        assert torch.is_tensor(y) and y.device.type == "cpu", name
        y_t = case.call(tst, torch.from_numpy, x)
        assert y.dtype == y_t.dtype, name
        np.testing.assert_allclose(_host(y), _host(y_t), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
        if case.truth is not None:
            want = case.truth(x)
            np.testing.assert_allclose(_host(y), want, rtol=1e-10,
                                       atol=1e-10 * max(1, np.abs(want).max()),
                                       err_msg=name)
        if isinstance(case.ref, str) and case.ref != "same":
            with pytest.raises(Exception) as err:  # the reference's side
                case.call(ref_pkg, lambda a: a, x)
            assert type(err.value).__name__ == case.ref, name
            continue
        if case.ref is None:
            continue
        call = case.call if case.ref == "same" else case.ref
        r = np.asarray(call(ref_pkg, lambda a: a, x))
        assert _host(y).dtype == r.dtype, (name, _host(y).dtype, r.dtype)
        np.testing.assert_allclose(_host(y), r, rtol=1e-12,
                                   atol=1e-12 * max(1, np.abs(r).max()),
                                   err_msg=name)


@pytest.mark.parametrize("name", SWEEP)
def test_a_bad_operand_raises_a_named_error(name, cpu_default):
    """A list, or an array of the wrong length, raises a TypeError or a
    ValueError that names the public method, never an AttributeError from
    a helper."""
    case = ARRAY_CALLS[name]
    short = name.partition(":")[2].rpartition(".")[2]
    if not case.operand:  # the matrix arguments, as lists
        with pytest.raises(TypeError, match=short):
            case.call(tst, lambda a: a.tolist(), X64)
        return
    with pytest.raises(TypeError, match=short):
        case.call(tst, lambda a: a.tolist(), X64)
    if name.partition(":")[0] in ("ksp.ksp", "ksp.iterative_jit") \
            and "." not in name.partition(":")[2]:
        return  # a free solver's length is its callback's to check
    with pytest.raises(ValueError, match=short):
        case.call(tst, lambda a: a, X64[:-1])


# the operators of the dtype check, and the element types tried on each side
DTYPE_OPS = {
    "DIAOperator": lambda P, dt: P.DIAOperator((-1, 0, 1), DIA_D.astype(dt)),
    "DenseOperator": lambda P, dt: P.DenseOperator(DENSE.astype(dt)),
    "SumOperator": lambda P, dt: P.DIAOperator((-1, 0, 1), DIA_D.astype(dt))
    + P.DenseOperator(DENSE.astype(dt)),
    "ScaledOperator": lambda P, dt: 2.5 * P.DIAOperator(
        (-1, 0, 1), DIA_D.astype(dt)),
}
DTYPES = (np.float32, np.float64, np.complex128)


def _precision_kept(op_dt, x_dt):
    """The port's element type where the reference promotes: the
    operator's precision (its kernel takes one element type), complex when
    either is; the reference promotes an f32 operator's product with an
    f64 or c128 array to f64 / c128."""
    if np.dtype(op_dt) == np.float32:
        return np.complex64 if np.iscomplexobj(np.empty(0, x_dt)) \
            else np.float32
    return None


@pytest.mark.parametrize("x_dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("op_dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("op", sorted(DTYPE_OPS))
def test_the_dtype_of_a_numpy_operand(op, op_dt, x_dt, cpu_default):
    """f32, f64 and c128 arrays on f32, f64 and c128 operators: the result
    has the reference's dtype, except where the port keeps an f32
    operator's precision (held here; docs/torch.md, the array rule)."""
    ref_pkg = _reference()
    x = (XC if np.iscomplexobj(np.empty(0, x_dt)) else X64).astype(x_dt)
    for meth in ("mult", "mult_h"):
        y = _host(getattr(DTYPE_OPS[op](tst, op_dt), meth)(x))
        r = np.asarray(getattr(DTYPE_OPS[op](ref_pkg, op_dt), meth)(x))
        kept = _precision_kept(op_dt, x_dt)
        assert y.dtype == (np.dtype(kept) if kept is not None else r.dtype), \
            (op, meth, op_dt, x_dt, y.dtype, r.dtype)
        tol = 1e-5 if np.finfo(y.dtype).bits <= 32 else 1e-12
        np.testing.assert_allclose(y, r, rtol=tol, atol=tol * np.abs(r).max())


def test_aij_mult_takes_numpy_where_the_reference_raises(cpu_default):
    """F6, the reference's side: its AIJOperator.mult gathers inside jit
    and a numpy x raises TracerArrayConversionError there; the port's
    answers, on K6's path."""
    ref_pkg = _reference()
    x = X64
    with pytest.raises(Exception) as err:
        ref_pkg.from_scipy(AIJ).mult(x)
    assert type(err.value).__name__ == "TracerArrayConversionError"
    np.testing.assert_allclose(tst.from_scipy(AIJ).mult(x).numpy(), AIJ @ x,
                               rtol=1e-12)


@pytest.mark.parametrize("backend", ["tridiag_device", "ldl", "splu",
                                     "dense"])
def test_a_complex_rhs_on_a_real_factor(backend, cpu_default):
    """F7, the reference's side: its tridiag_device, ldl and splu solves
    cast a complex right-hand side to the real factor's dtype and drop its
    imaginary part, its dense LU raises; the port solves the real and
    imaginary parts, so x is the complex solution on every backend."""
    from slepc_tpu.ksp.direct import DirectSolver as RefSolver
    from slepc_tpu_torch.ksp.direct import DirectSolver

    ref_pkg = _reference()
    want = _solve_tri(XC)
    A = _tridiag(tst) if backend != "dense" else tst.DenseOperator(TRI_M)
    x = DirectSolver(A, backend=backend).solve(XC)
    assert x.dtype == torch.complex128
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-12)
    Ar = _tridiag(ref_pkg) if backend != "dense" \
        else ref_pkg.DenseOperator(TRI_M)
    if backend == "dense":
        with pytest.raises(TypeError):
            RefSolver(Ar, backend=backend).solve(XC)
        return
    with np.testing.suppress_warnings() as sup:
        sup.filter(np.exceptions.ComplexWarning)
        r = np.asarray(RefSolver(Ar, backend=backend).solve(XC))
    # tridiag_device answers in float64, ldl and splu in complex128 with a
    # zero imaginary part: the solution for Re(b) alone
    assert r.dtype == (np.float64 if backend == "tridiag_device"
                       else np.complex128)
    np.testing.assert_allclose(r, want.real, rtol=1e-10)


# ---- the map of the JAX package's tests --------------------------------------

MAPPED_FILES = ("test_classes.py", "test_eps_advanced.py",
                "test_eps_krylovschur.py", "test_eps_solvers.py",
                "test_modules.py", "test_modules_advanced.py",
                "test_reference_golden.py", "test_round2.py",
                "test_round3.py", "test_round4.py", "test_round5.py",
                "test_native_ldl.py", "test_multichip.py",
                "test_multihost_2proc.py", "test_bv_pallas.py")


def _tests_of(path):
    """The test functions of a test file, as "name" or "Class::name"."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            out |= {f"{node.name}::{b.name}" for b in node.body
                    if isinstance(b, ast.FunctionDef)
                    and b.name.startswith("test")}
    return out


def test_the_map_of_the_reference_tests_names_real_tests():
    """docs/torch.md maps every test of the fifteen files once, as (a) a
    twin of the same name in the twins' files, (b) or (c) named port tests,
    and every port test it names exists."""
    import re

    doc = (REPO / "docs" / "torch.md").read_text()
    rows = re.findall(r"^\| `(test_\w+\.py)::([\w:]+)` \| \((a|b|c)\) \| "
                      r"(.*) \|$", doc, re.M)
    mapped = {(f, t) for f, t, _, _ in rows}
    assert len(mapped) == len(rows) == 184
    want = {(f, t) for f in MAPPED_FILES
            for t in _tests_of(REPO / "tests" / f)}
    assert mapped == want
    port = {}
    for f, t, how, held in rows:
        if how == "a":
            twins = re.findall(r"`(test_torch_reference_\w+\.py)`", held)
            assert len(twins) == 1, (f, t)
            path = REPO / "tests" / twins[0]
            assert t in port.setdefault(path, _tests_of(path)), (f, t)
            continue
        named = re.findall(r"`(test_torch_\w+\.py)(?:::([\w:]+))?`", held)
        assert named, (f, t)
        for pf, pt in named:
            path = REPO / "tests" / pf
            have = port.setdefault(path, _tests_of(path))
            assert pt in have if pt else t in have, (f, t, pf, pt)
