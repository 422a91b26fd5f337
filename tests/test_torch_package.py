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

import copy
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


_RUN_WITH_JAX_BLOCKED = _IMPORT_ALL_WITHOUT_JAX.split("import slepc_tpu_torch")[0] \
    + """import runpy
runpy.run_path(sys.argv[1], run_name="__main__")
print('ran', 'jax' in sys.modules)
"""


def test_example_copies_run_with_jax_blocked():
    """The blocked-import check on examples_torch/: a copy runs with every
    import of jax and slepc_tpu refused (the other nine run the same way in
    tests/test_torch_examples*.py)."""
    env = dict(__import__("os").environ, SLEPC_TPU_TORCH_DEVICE="cpu",
               PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _RUN_WITH_JAX_BLOCKED,
         str(ROOT / "examples_torch" / "ex5_markov.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ran False")


def test_sources_do_not_import_jax():
    import re

    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|slepc_tpu)\b(?!_torch)",
                     re.M)
    paths = list((ROOT / "slepc_tpu_torch").rglob("*.py"))
    assert len(paths) > 30
    examples = list((ROOT / "examples_torch").glob("*.py"))
    assert len(examples) == 10
    for path in paths + examples + [ROOT / "chip_smoke.py"]:
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
    ("markov", lambda: tst.markov(5)),
    ("from_complex_dia", lambda: tst.from_complex_dia(
        (0,), np.ones((1, 4), complex))),
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


# ---- the EPS surface and sys/ against slepc_tpu ---------------------------

import slepc_tpu as jst
from slepc_tpu.sys import events as jevents
from slepc_tpu.sys import options as joptions
from slepc_tpu.sys import sort as jsort
from slepc_tpu_torch.sys import events as tevents
from slepc_tpu_torch.sys import options as toptions
from slepc_tpu_torch.sys import sort as tsort


def _setter_driven(pkg, A, cli=""):
    """An EPS configured by its setters alone (no constructor keywords)."""
    eps = pkg.EPS(options=pkg.Options.from_cli(cli))
    eps.set_operators(A)
    eps.set_problem_type("hep")
    eps.set_type("krylovschur")
    eps.set_which("largest_real")
    eps.set_dimensions(nev=4, ncv=20)
    eps.set_tolerances(tol=1e-10, max_it=500)
    eps.solve()
    return eps


def test_eps_driven_by_setters_matches_the_reference(capsys):
    jA = jst.laplacian_2d(18, 17)
    tA = interop.dia_from_slepc_tpu(jA, device="cpu")
    je = _setter_driven(jst, jA)
    te = _setter_driven(tst, tA, "-eps_view -eps_converged_reason "
                                 "-eps_error_relative")
    out = capsys.readouterr().out
    assert "EPS Object:" in out and "EPS solve CONVERGED" in out \
        and "rel.err" in out
    assert te.get_converged() >= 4 and je.get_converged() >= 4
    np.testing.assert_allclose(te.eigenvalues[:4], je.eigenvalues[:4].real,
                               rtol=1e-10)
    X = te.get_eigenvectors()  # the reference's (n, nconv) columns, a view
    Xj = np.asarray(je.get_eigenvectors())
    assert X.shape == (tA.shape[0], te.nconv) == Xj.shape[:1] + (te.nconv,)
    assert X.data_ptr() == te._eigenvectors.data_ptr()
    for i in range(4):
        assert abs(abs(float(X[:, i].numpy() @ Xj[:, i].real)) - 1) < 1e-8
        assert te.get_error_estimate(i) < 1e-10
    assert te.view() == je.view()


def test_unknown_solver_raises_eps_error_listing_the_registered():
    A = tst.laplacian_1d(20, device="cpu")
    with pytest.raises(tst.EPSError, match=r"unknown EPS solver 'bogus'; "
                       r"available: \['arnoldi', 'bse', 'ciss', 'gd', 'jd', "
                       r"'krylovschur', 'lanczos', 'lapack', 'lobpcg', "
                       r"'lyapii', 'power', 'rqcg', 'subspace'\]"):
        tst.EPS(A, problem_type="hep").set_type("bogus").solve()
    from slepc_tpu.eps.base import EPSError as JEPSError

    with pytest.raises(JEPSError, match="unknown EPS solver 'bogus'"):
        jst.EPS(jst.laplacian_1d(20), problem_type="hep",
                solver="bogus").solve()
    from slepc_tpu_torch.eps import EPSSolver

    assert tst.EPS._solvers["krylovschur"].__mro__[1] is EPSSolver


def _spi_op(x):
    xa = x.cpu().numpy()
    A0 = tst.laplacian_1d(20, device="cpu").to_dense().numpy()
    return tst.DenseOperator(A0 + 0.5 * np.diag(xa ** 2), device="cpu")


def _spi_op_complex(x):
    xa = x.cpu().numpy()
    A0 = tst.laplacian_1d(20, device="cpu").to_dense().numpy()
    return tst.DenseOperator(A0 * (1 + 0j) + 0.5 * np.diag(np.abs(xa) ** 2),
                             device="cpu")


# set_two_sided on a real operator raised until item 11d was ported; it now
# solves, Hermitian (the left vectors a copy of the right ones) and
# non-Hermitian (the coupled Krylov-Schur), against the reference.
@pytest.mark.parametrize("pt", ["hep", "nhep"])
def test_set_two_sided_solves_as_the_reference(pt):
    L = tst.laplacian_1d(20, device="cpu")
    out = []
    for pkg in (jst, tst):
        A = pkg.laplacian_1d(20) if pkg is jst else L
        eps = pkg.EPS(A, problem_type=pt, nev=2, options=pkg.Options())
        eps.set_two_sided()
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv >= 2 and te.its == je.its
    np.testing.assert_allclose(np.real(te.eigenvalues[:2]),
                               np.real(je.eigenvalues[:2]), rtol=0,
                               atol=1e-10)
    Ld = L.to_dense().numpy()
    for i in range(2):
        y = te.get_left_eigenvector(i).numpy()
        lam = np.conj(te.eigenvalues[i])
        assert np.linalg.norm(Ld.T @ y - lam * y) < 1e-7


# The complex paths that raised until they were ported: block_size and
# cheb_block, each reached through another way
# a problem turns complex (a complex A, a complex Hermitian B, a complex
# shift of a real A), go to the general loop, which reads neither, as the
# reference's: each solves exactly as it does without the setting.  The
# device shift-and-invert still raises for a complex shift, with a message
# that says the reference has no complex one.  The nonlinear power
# iteration has no blocked form: on a complex operator it solves (A(x)
# complex Hermitian), and the case holds its residual.
@pytest.mark.parametrize("setter,args", [
    ("block_size", ("complex A",)),
    ("block_size", ("complex shift",)),
    ("cheb_block", ("complex B",)),
    ("STSinvertDevice", ("complex shift",)),
    ("set_power_nonlinear", (_spi_op_complex,))],
    ids=["block_size-complex_A", "block_size-complex_shift",
         "cheb_block-complex_B", "STSinvertDevice-complex_shift",
         "set_power_nonlinear"])
def test_complex_variants_solve_and_the_device_sinvert_refuses(setter, args):
    L = tst.laplacian_1d(20, device="cpu")
    if setter == "set_power_nonlinear":
        A = tst.DenseOperator(np.diag(np.arange(1.0, 21.0)) * (1 + 1j),
                              device="cpu")
        eps = tst.EPS(A, problem_type="hep", nev=2, options=tst.Options())
        eps.set_power_nonlinear(*args)
        eps.set_tolerances(tol=1e-9, max_it=200)
        eps.solve()
        lam, x = eps.get_eigenpair(0)
        assert eps.nconv == 1 and x.is_complex()
        r = _spi_op_complex(x).mult(x) - lam * x
        assert float(torch.linalg.vector_norm(r)) < 1e-7
        return
    (how,) = args
    if how == "complex A":
        A = tst.DenseOperator(np.diag(np.arange(1.0, 21.0)) * (1 + 1j),
                              device="cpu")
        eps = tst.EPS(A, problem_type="nhep", nev=2, options=tst.Options())
    elif how == "complex B":  # Hermitian, eigenvalues 1 +- 0.2 cos(.)
        up = np.eye(20, k=1)
        B = tst.DenseOperator(np.eye(20) + 0.1j * (up - up.T), device="cpu")
        eps = tst.EPS(L, B, problem_type="ghep", nev=2,
                      options=tst.Options())
    else:
        eps = tst.EPS(L, problem_type="hep", nev=2, options=tst.Options())
        eps.set_target(0.5 + 0.1j)
        eps.set_st((tst.STSinvertDevice if setter == "STSinvertDevice"
                    else tst.STShift)([L], sigma=0.5 + 0.1j))
    if setter == "STSinvertDevice":
        before = tst.launch_counts()
        with pytest.raises(NotImplementedError,
                           match=r"\(STSinvertDevice\) takes a real problem "
                                 r"only; the reference has no complex device "
                                 r"shift-and-invert"):
            eps.solve()
        assert tst.launch_counts() == before
        return
    plain = copy.deepcopy(eps)
    if setter == "block_size":
        eps.block_size = 2
    else:
        eps.cheb_degree, eps.cheb_block = 20, 2
    eps.solve()
    plain.solve()
    assert eps.nconv == plain.nconv >= 2 and eps.its == plain.its
    np.testing.assert_array_equal(eps.eigenvalues, plain.eigenvalues)
    for i in range(2):
        assert eps.compute_error(i) < 1e-7


@pytest.mark.parametrize("setter,args", [
    ("set_balance", ()), ("set_extraction", ("harmonic",)),
    ("set_arbitrary_selection", (lambda lam, x: -abs(lam),)),
    ("set_rg", (tst.RGInterval(1.0, np.inf, -1.0, 1.0),)),
    ("set_power_nonlinear", (_spi_op,))])
def test_setters_of_the_non_hermitian_slice_take_effect(setter, args):
    pt = "hep" if setter == "set_power_nonlinear" else "nhep"
    eps = tst.EPS(tst.laplacian_1d(20, device="cpu"), problem_type=pt,
                  nev=2, options=tst.Options())
    getattr(eps, setter)(*args)
    eps.solve()
    assert eps.nconv >= 1 and eps.errests[0] < 1e-8
    if setter != "set_power_nonlinear":  # A(x) is not A there
        assert eps.compute_error(0) < 1e-8
    if setter == "set_rg":
        assert np.all(np.real(eps.eigenvalues[:eps.nconv]) >= 1.0)


def test_save_and_load_state_round_trip_across_packages(tmp_path):
    jA = jst.laplacian_2d(18, 17)
    tA = interop.dia_from_slepc_tpu(jA, device="cpu")
    te = _setter_driven(tst, tA)
    path = str(tmp_path / "state.npz")
    te.save_state(path)
    d = np.load(path)
    assert d["eigenvectors"].shape == (tA.shape[0], te.nconv)
    assert int(d["nconv"]) == te.nconv
    warm_t = tst.EPS(tA, problem_type="hep").load_state(path)
    warm_j = jst.EPS(jA, problem_type="hep").load_state(path)
    assert warm_t.initial_space.shape == (tA.shape[0], 1 + te.nconv)
    np.testing.assert_array_equal(warm_t.initial_space, warm_j.initial_space)
    warm_t.set_which("largest_real").set_dimensions(nev=4, ncv=20)
    warm_t.set_tolerances(tol=1e-10)
    warm_t.solve()
    assert warm_t.nconv >= 4 and warm_t.its <= te.its
    np.testing.assert_allclose(warm_t.eigenvalues[:4], te.eigenvalues[:4],
                               rtol=1e-10)


def test_sort_eigenvalues_matches_the_reference():
    rng = np.random.default_rng(0)
    eigs = rng.standard_normal(9)
    V = rng.standard_normal((5, 9))
    for which in ("largest_magnitude", "smallest_real", "target_magnitude"):
        want = jsort.sort_eigenvalues(jsort.SortCriterion(
            jsort.Which(which), 0.3), eigs, V)
        got = tsort.sort_eigenvalues(tsort.SortCriterion(
            tsort.Which(which), 0.3), eigs, torch.from_numpy(V))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[2], want[2])
        e, perm = tsort.sort_eigenvalues(tsort.SortCriterion(
            tsort.Which(which), 0.3), eigs)
        np.testing.assert_array_equal(perm, want[2])


def test_apply_module_options_matches_the_reference():
    class Obj:
        def set_target(self, t):
            self.targeted = t

    cli = ("-svd_nsv 3 -svd_tol 1e-7 -svd_type cross -svd_explicit "
           "-svd_target 0.5 -svd_ncv 12")
    got = []
    for pkg, mod in ((jst, joptions), (tst, toptions)):
        pkg.set_global_options(cli)
        try:
            obj = Obj()
            mod.apply_module_options(obj, "svd_", int_keys=("nsv",),
                                     float_keys=("tol",), str_keys=("type",),
                                     bool_keys=("explicit",),
                                     count_key="ncv")
            got.append(vars(obj))
        finally:
            pkg.set_global_options(pkg.Options())
    assert got[0] == got[1] and got[1]["solver"] == "cross" \
        and got[1]["targeted"] == 0.5


def test_log_event_end_sync_returns_its_value():
    x = torch.ones(3)
    assert tevents.log_event_end_sync(x) is x
    assert tevents.log_event_end_sync((x, 2))[0] is x
    y = jnp.ones(3)
    assert jevents.log_event_end_sync(y) is y


def test_the_non_hermitian_slice_is_exported_and_registered():
    for name in ("STFilter", "RG", "RGEllipse", "RGInterval", "RGPolygon",
                 "RGRing", "DSNHEP", "DSGNHEP", "markov", "from_complex_dia"):
        assert name in tst.__all__ and hasattr(tst, name), name
    from slepc_tpu_torch.st import STFilter, estimate_spectral_bounds  # noqa
    from slepc_tpu_torch.ds import DSGNHEP, DSNHEP, schur  # noqa

    # the preconditioned and contour solvers (items 11b, 11c), bse (11d)
    # and lyapii (13) since they were ported
    assert sorted(tst.EPS._solvers) == ["arnoldi", "bse", "ciss", "gd", "jd",
                                        "krylovschur", "lanczos", "lapack",
                                        "lobpcg", "lyapii", "power", "rqcg",
                                        "subspace"]
    assert tst.DS.create("nhep").__class__ is tst.DSNHEP
    assert tst.DS.create("gnhep").__class__ is tst.DSGNHEP
    # -st_type filter builds the filter (it raised before the slice)
    eps = tst.EPS(tst.laplacian_1d(20, device="cpu"), problem_type="hep",
                  options=tst.Options.from_cli(
                      "-st_type filter -st_filter_interval 1,2"))
    assert isinstance(eps.setup().st, tst.STFilter)


@pytest.mark.parametrize("solver", ["krylovschur", "arnoldi", "power",
                                    "subspace"])
def test_complex_operators_raise_naming_11a_ii(solver):
    """Named for the refusal it held until item 11a-ii (complex operators)
    was ported: each solver now solves the same complex problem, held
    against the reference (the same its and eigenvalues to 1e-9)."""
    Ad = np.diag(np.arange(1.0, 21.0)) * (1 + 1j)
    Ad = Ad + 0.01 * np.triu(np.ones((20, 20)), 1)  # no invariant start
    out = []
    for pkg in (jst, tst):
        kw = {} if pkg is jst else {"device": "cpu"}
        eps = pkg.EPS(pkg.DenseOperator(Ad, **kw), problem_type="nhep",
                      nev=2, solver=solver, options=pkg.Options(),
                      max_it=3000)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv and te.nconv >= 2 and te.its == je.its
    np.testing.assert_allclose(te.eigenvalues[:2], je.eigenvalues[:2],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.sort_complex(te.eigenvalues[:2]),
                               [19 + 19j, 20 + 20j], atol=1e-8)


def test_lyapii_solves_and_bse_refuses_a_plain_operator():
    """lyapii (item 13) solves in both packages alike (the rightmost
    eigenvalue of -laplacian_1d(20), the same iterations, value and
    vector); bse (item 11d) is registered and refuses an operator that is
    not a MatBSE, as the reference's does."""
    A = tst.laplacian_1d(20, device="cpu")
    out = []
    for pkg, op in ((jst, -1.0 * jst.laplacian_1d(20)), (tst, -1.0 * A)):
        eps = pkg.EPS(op, problem_type="nhep", solver="lyapii", nev=1,
                      tol=1e-8, max_it=60)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv >= 1 and te.its == je.its
    assert abs(te.eigenvalues[0] - je.eigenvalues[0]) < 1e-9
    assert abs(te.eigenvalues[0] + tst.laplacian_1d_eigs(20).min()) < 1e-7
    x = te.get_eigenpair(0)[1]
    xj = np.asarray(je.get_eigenvectors())[:, 0]
    assert 1 - abs(np.vdot(xj, x.numpy())) < 1e-8
    assert "bse" in tst.EPS._solvers
    with pytest.raises(ValueError, match="MatBSE"):
        tst.EPS(A, problem_type="hep", solver="bse").solve()


def test_the_preconditioned_and_contour_slice_is_in_the_import_checks():
    """The modules of items 11b / 11c are among those the JAX-free import
    check (test_import_leaves_jax_out) walks and whose sources
    test_sources_do_not_import_jax reads."""
    import pkgutil

    walked = {info.name for info in pkgutil.walk_packages(
        tst.__path__, "slepc_tpu_torch.")}
    new = {"slepc_tpu_torch.parallel", "slepc_tpu_torch.parallel.tasks",
           "slepc_tpu_torch.sys.contour", "slepc_tpu_torch.eps.davidson",
           "slepc_tpu_torch.eps.gd_jit", "slepc_tpu_torch.eps.lobpcg",
           "slepc_tpu_torch.eps.rqcg", "slepc_tpu_torch.eps.ciss",
           # and those of item 11d
           "slepc_tpu_torch.eps.bse", "slepc_tpu_torch.eps.ks_twosided",
           "slepc_tpu_torch.mat.structured", "slepc_tpu_torch.ds.bdc",
           # and those of items 13 and 14
           "slepc_tpu_torch.fn", "slepc_tpu_torch.fn.fn",
           "slepc_tpu_torch.mfn", "slepc_tpu_torch.mfn.mfn",
           "slepc_tpu_torch.lme", "slepc_tpu_torch.lme.lme",
           "slepc_tpu_torch.eps.lyapii", "slepc_tpu_torch.pep",
           "slepc_tpu_torch.pep.pep", "slepc_tpu_torch.pep.toar",
           "slepc_tpu_torch.pep.qarnoldi", "slepc_tpu_torch.pep.stoar",
           "slepc_tpu_torch.pep.qslice",
           # and those of item 15
           "slepc_tpu_torch.nep", "slepc_tpu_torch.nep.nep",
           "slepc_tpu_torch.nep.nleigs_toar"}
    assert new <= walked, new - walked
    sources = {p.relative_to(ROOT).as_posix()
               for p in (ROOT / "slepc_tpu_torch").rglob("*.py")}
    for mod in new:
        path = mod.replace(".", "/")
        assert f"{path}.py" in sources or f"{path}/__init__.py" in sources
