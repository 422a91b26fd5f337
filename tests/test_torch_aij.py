"""The port's general-sparsity (AIJ) path against slepc_tpu.

Every input is built with numpy/scipy from a seed and handed to both
packages.  Tolerances:

* the CSR SpMV's plain version (what the port runs for CPU tensors) against
  the Pallas hybrid-ELL kernel ``hyb_spmv_padded`` (interpret mode, through
  ``GELLPaddedOperator.from_scipy(A, block_rows=64)``): f64 1e-12 relative
  (both sum at most a row's entries in f64), f32 1e-5 relative (single
  rounding of the row sums in two orders);
* against scipy's ``A @ x`` where the reference cannot pack the matrix:
  1e-13 relative in f64, 1e-5 in f32;
* EPS (hep, smallest, nev=4, ncv=24, tol=1e-9) on RCM-ordered
  laplacian_3d(15, 16, 18) (4,320 rows, so the reference takes its Pallas
  route, n >= 4096): both packages within 1e-10 of the closed form and of
  each other.  The grid dimensions differ so that the wanted eigenvalues
  are simple;
* PETSc binary files and CSR round trips: exact.

Each JAX reference solve runs once per module, in a fixture.
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee
from scipy.sparse.linalg import eigsh

import slepc_tpu as jst
from slepc_tpu.mat import petsc_io as jio
from slepc_tpu.mat.generators import random_sparse as j_random_sparse
from slepc_tpu.ops import dia_pallas
from slepc_tpu.ops.ell_pallas import GELLPaddedOperator
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop
from slepc_tpu_torch.ops import csr
from slepc_tpu_torch.st.cheb import gershgorin_upper


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """The reference's jit caches keep the AIJ operators this module ran
    (their pytree metadata holds a scipy matrix), and the reference raises
    when a later module of the same process runs another operator of that
    shape (tests/test_eps_krylovschur.py's Markov chain after the one of
    tests/test_torch_nhep.py): drop them when the module ends."""
    yield
    jax.clear_caches()


DIMS = (15, 16, 18)
NEV = 4


def _rcm_laplacian():
    L = sp.csr_matrix(tst.laplacian_3d(*DIMS, device="cpu").to_scipy())
    perm = reverse_cuthill_mckee(L, symmetric_mode=True)
    return L[perm][:, perm].tocsr()


def _round2_matrix():
    """tests/test_round2.py:21-31: a 2-D stencil with 200 irregular entries
    within +-300 columns (dense-diagonal and gather slots)."""
    rng = np.random.default_rng(0)
    side = 64
    n = side * side
    offs = [-side, -1, 0, 1, side]
    A = sp.diags([rng.standard_normal(n) for _ in offs], offs,
                 shape=(n, n), format="lil")
    for _ in range(200):
        i = rng.integers(0, n)
        j = np.clip(i + rng.integers(-300, 300), 0, n - 1)
        A[i, j] = rng.standard_normal()
    return sp.csr_matrix(A)


def _unpackable_matrix():
    """Empty rows, and a row with 100 entries in one 128-column block (the
    hybrid pack takes at most 64)."""
    rng = np.random.default_rng(4)
    n = 300
    A = sp.random(n, n, density=0.02, random_state=rng, format="lil")
    A[7, :] = 0
    A[8, :] = 0
    A[100, 128:228] = rng.standard_normal(100)
    return sp.csr_matrix(A)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype,np_dtype,tol", [
    (torch.float64, np.float64, 1e-12), (torch.float32, np.float32, 1e-5)])
@pytest.mark.parametrize("kind", ["round2", "rcm"])
def test_csr_spmv_matches_hybrid_ell_kernel(kind, dtype, np_dtype, tol):
    A = _round2_matrix() if kind == "round2" else _rcm_laplacian()
    jop = GELLPaddedOperator.from_scipy(A, block_rows=64, dtype=np_dtype)
    top = tst.from_scipy(A, dtype=dtype, device="cpu")
    x = np.random.default_rng(1).standard_normal(A.shape[0]).astype(np_dtype)
    yj = np.asarray(jop.unpad(jop.mult2d(jop.pad2d(jnp.asarray(x)))))
    y = top.mult(torch.from_numpy(x)).numpy()
    assert y.dtype == np_dtype
    assert _rel(y, yj) < tol
    # the plain version itself, as the kernel's reference on the card
    y2 = csr.csr_spmv_ref(top.rowptr, top.cols, top.vals, torch.from_numpy(x))
    assert torch.equal(y2, torch.from_numpy(y))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_csr_spmv_where_the_reference_cannot_pack(dtype, tol):
    A = _unpackable_matrix()
    with pytest.raises(ValueError, match="64 slots"):
        GELLPaddedOperator.from_scipy(A, block_rows=64)
    top = tst.from_scipy(A, dtype=dtype, device="cpu")
    assert isinstance(top.fast_form(), tst.AIJOperator)
    x = np.random.default_rng(2).standard_normal(A.shape[0])
    y = top.mult(torch.from_numpy(x).to(dtype)).numpy()
    assert y[7] == 0 and y[8] == 0
    assert _rel(y, A @ x) < tol
    # the kernel's row blocks: rows 0..m once each, none past the budget
    # unless it is one row
    rowptr = top.rowptr
    _check_row_blocks(rowptr, csr.csr_row_blocks(rowptr, 16), 16,
                      csr.CSR_MAX_ROWS)
    assert csr.csr_plan(rowptr, 16).budget == 16
    # a budget for each dtype the kernel takes (complex since item 11a-ii)
    assert set(csr.CSR_BUDGET) == {torch.float32, torch.float64,
                                   torch.complex64, torch.complex128}


def _check_row_blocks(rowptr, starts, budget, max_rows):
    """starts: 0 .. m, strictly increasing (every row in exactly one block);
    a block holds at most ``budget`` entries unless it is one row, at most
    ``max_rows`` rows, and is greedy (one more row would break a limit)."""
    rp = rowptr.numpy()
    st = starts.numpy().astype(np.int64)
    m = len(rp) - 1
    assert starts.dtype == torch.int32
    assert st[0] == 0 and st[-1] == m
    if m == 0:
        assert len(st) == 1
        return
    assert (np.diff(st) > 0).all()
    for r0, r1 in zip(st[:-1], st[1:]):
        nnz = rp[r1] - rp[r0]
        assert nnz <= budget or r1 - r0 == 1
        assert r1 - r0 <= max_rows
        if r1 < m:
            assert rp[r1 + 1] - rp[r0] > budget or r1 + 1 - r0 > max_rows


def _lengths(kind):
    rng = np.random.default_rng(5)
    if kind == "stencil":
        return rng.poisson(7, 3001)
    if kind == "empty_rows":  # long runs of empty rows
        ln = np.zeros(5000, np.int64)
        ln[::997] = 3
        return ln
    if kind == "long_rows":  # rows past the budget among short ones
        ln = rng.integers(0, 9, 2000)
        ln[[0, 7, 8, 1999]] = [300, 257, 1000, 400]
        return ln
    if kind == "at_budget":  # blocks of exactly the budget
        return np.full(640, 8)
    if kind == "one_row":
        return np.array([5])
    return np.zeros(0, np.int64)  # no rows


@pytest.mark.parametrize("budget,max_rows", [(64, 1024), (256, 16), (1, 1024)])
@pytest.mark.parametrize("kind", ["stencil", "empty_rows", "long_rows",
                                  "at_budget", "one_row", "no_rows"])
def test_csr_row_blocks_cover_every_row_once_within_budget(kind, budget,
                                                           max_rows):
    ln = _lengths(kind)
    rowptr = torch.from_numpy(np.concatenate([[0], np.cumsum(ln)])
                              .astype(np.int64))
    starts = csr.csr_row_blocks(rowptr, budget, max_rows)
    _check_row_blocks(rowptr, starts, budget, max_rows)
    if kind == "at_budget" and budget == 64:  # 8 rows of 8 entries a block
        assert torch.equal(starts, torch.arange(0, 641, 8, dtype=torch.int32))


@pytest.mark.parametrize("budget", [64, 256])
def test_csr_plan_cuts_long_rows_into_chunks(budget):
    ln = _lengths("long_rows")
    rowptr = torch.from_numpy(np.concatenate([[0], np.cumsum(ln)])
                              .astype(np.int64))
    plan = csr.csr_plan(rowptr, budget)
    assert plan.chunk == csr.CSR_CHUNKS * budget
    long_rows = np.flatnonzero(ln > budget)
    assert plan.long_rows.tolist() == long_rows.tolist()
    first = plan.chunk_first.numpy()
    assert first[0] == 0 and first[-1] == plan.nchunks
    for i, r in enumerate(long_rows):  # chunks cover the row, none empty
        nch = first[i + 1] - first[i]
        assert (nch - 1) * plan.chunk < ln[r] <= nch * plan.chunk
        assert (plan.chunk_row[first[i]:first[i + 1]] == i).all()
    # each long row is also alone in its block of the row plan
    starts = plan.starts.numpy()
    for r in long_rows:
        k = np.searchsorted(starts, r)
        assert starts[k] == r and starts[k + 1] == r + 1


def test_csr_plan_is_checked_and_shared_by_abs_values():
    A = _rcm_laplacian()
    op = tst.from_scipy(A, device="cpu")
    assert op.row_plan() is None  # the plain version needs none
    plan = csr.csr_plan(op.rowptr, 128)
    assert plan.m == A.shape[0] and plan.nblocks == len(plan.starts) - 1
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(A.shape[0]))
    y = csr.csr_spmv(op.rowptr, op.cols, op.vals.abs(), x, A.shape[1],
                     plan=plan)
    assert _rel(y.numpy(), abs(A) @ x.numpy()) < 1e-13
    with pytest.raises(ValueError, match="plan for"):
        csr.csr_spmv(op.rowptr[:-1], op.cols[:-6], op.vals[:-6], x,
                     A.shape[1], plan=plan)
    with pytest.raises(ValueError, match="budget"):
        csr.csr_plan(op.rowptr, csr.CSR_MAX_BUDGET + 1)


def test_edge_shapes_of_the_plain_version():
    empty = tst.AIJOperator(torch.zeros(1, dtype=torch.int64),
                            torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0), (0, 3))
    assert empty.mult(torch.ones(3)).shape == (0,)
    zeros = tst.from_scipy(sp.csr_matrix((5, 5)), device="cpu")
    assert zeros.nnz == 0 and zeros.fast_form() is zeros
    assert torch.equal(zeros.mult(torch.ones(5, dtype=torch.float64)),
                       torch.zeros(5, dtype=torch.float64))


@pytest.mark.parametrize("method", ["mult", "mult_h"])
def test_x_of_the_wrong_length_raises(method):
    # the kernel gathers x[cols] unchecked, so the wrapper checks the length
    # on every device; a 3x4 operator takes x of 4 entries, its adjoint 3
    op = tst.from_scipy(sp.random(3, 4, density=0.5, random_state=6),
                        device="cpu")
    right = 4 if method == "mult" else 3
    assert getattr(op, method)(torch.ones(right, dtype=torch.float64)).shape \
        == (7 - right,)
    for wrong in (right - 1, right + 1):
        with pytest.raises(ValueError, match=f"{right} columns"):
            getattr(op, method)(torch.ones(wrong, dtype=torch.float64))


def test_routing_dense_diagonals_to_dia_and_the_rest_to_csr(monkeypatch):
    L = jst.laplacian_2d(70, 69).to_scipy()  # the test_round2.py:44 matrix
    R = _rcm_laplacian()
    x = np.random.default_rng(3).standard_normal(L.shape[0])
    # port: dense diagonals -> DIAOperator (K1/K2), with the CSR's values
    fast = tst.from_scipy(L, device="cpu").fast_form()
    assert isinstance(fast, tst.DIAOperator)
    assert fast.offsets == (-70, -1, 0, 1, 70)
    assert _rel(fast.mult(torch.from_numpy(x)).numpy(), L @ x) < 1e-15
    # reference on the CPU: its DIA kernel is TPU-only (dia_spmv_supported),
    # so it packs the same matrix into hybrid ELL with diagonal slots only
    g = jst.from_scipy(L).to_gell()
    assert isinstance(g, GELLPaddedOperator)
    assert len(g.dslots) == 0 and len(g.qr_slots) == 5
    # ... and where its DIA kernel applies it picks DIAPaddedOperator,
    # with the port's offsets
    monkeypatch.setattr(dia_pallas, "dia_spmv_supported",
                        lambda *a, **k: True)
    jdia = jst.from_scipy(L)._try_dia_padded()
    assert isinstance(jdia, dia_pallas.DIAPaddedOperator)
    assert jdia.offsets == fast.offsets
    monkeypatch.undo()
    # irregular pattern: the port keeps CSR (K6), the reference hybrid ELL
    aij = tst.from_scipy(R, device="cpu")
    assert aij.fast_form() is aij
    assert jst.from_scipy(R)._try_dia_padded() is None
    assert isinstance(jst.from_scipy(R).to_gell(), GELLPaddedOperator)


def _eps(pkg, A, degree):
    eps = pkg.EPS(A, problem_type="hep", which="smallest_real", nev=NEV,
                  ncv=24, tol=1e-9)
    eps.cheb_degree = degree
    eps.solve()
    return eps


@pytest.fixture(scope="module")
def jax_eps():
    out = {}
    for degree in (0, 20):
        A = jst.from_scipy(_rcm_laplacian())
        eps = _eps(jst, A, degree)
        assert isinstance(A._gell, GELLPaddedOperator)  # the Pallas route
        out[degree] = np.sort(np.asarray(eps.eigenvalues[:eps.nconv]).real)
    return out


@pytest.mark.parametrize("degree", [0, 20])
def test_eps_on_csr_matches_reference_and_closed_form(jax_eps, degree):
    exact = tst.laplacian_3d_eigs(*DIMS, k=NEV)
    A = tst.from_scipy(_rcm_laplacian(), device="cpu")
    eps = _eps(tst, A, degree)
    assert eps.nconv >= NEV and len(jax_eps[degree]) >= NEV
    lam = np.sort(eps.eigenvalues[:NEV])
    assert np.abs(lam - exact).max() < 1e-10
    assert np.abs(jax_eps[degree][:NEV] - exact).max() < 1e-10
    assert np.abs(lam - jax_eps[degree][:NEV]).max() < 1e-10
    assert max(eps.compute_error(i) for i in range(NEV)) < 1e-8
    assert A._fast is A  # solved on the CSR form


@pytest.mark.parametrize("degree", [0, 20])
def test_eps_on_a_shell_operator(degree):
    aij = tst.from_scipy(_rcm_laplacian(), device="cpu")
    shell = tst.ShellOperator(aij.shape, torch.float64, aij.mult, aij.mult_h,
                              nnz=aij.nnz, device="cpu")
    eps = _eps(tst, shell, degree)
    assert eps.nconv >= NEV
    exact = tst.laplacian_3d_eigs(*DIMS, k=NEV)
    assert np.abs(np.sort(eps.eigenvalues[:NEV]) - exact).max() < 1e-10


def test_gershgorin_upper_of_aij_is_the_row_sum_bound():
    A = _rcm_laplacian() + 0.1 * sp.csr_matrix(
        j_random_sparse(4320, density=0.001, seed=6, symmetric=True)
        .to_scipy())
    A = sp.csr_matrix(A)
    hi = gershgorin_upper(tst.from_scipy(A, device="cpu"))
    rowsum = float(abs(A).sum(axis=1).max())
    assert abs(hi - rowsum) <= 1e-14 * rowsum
    assert hi >= float(eigsh(A, k=1, which="LA")[0][0])
    # another operator: power iteration x 1.1, seeded
    shell = tst.ShellOperator(A.shape, torch.float64,
                              tst.from_scipy(A, device="cpu").mult,
                              device="cpu")
    est = gershgorin_upper(shell)
    assert est == gershgorin_upper(shell) and est > 0.9 * rowsum


def test_aij_from_slepc_tpu_round_trips():
    A = _round2_matrix()
    jop = jst.from_scipy(A)
    top = interop.aij_from_slepc_tpu(jop, device="cpu")
    back = top.to_scipy()
    for name in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(back, name), getattr(A, name)), name
    x = np.random.default_rng(7).standard_normal(A.shape[0])
    yj = np.asarray(jop.mult(jnp.asarray(x)))
    assert _rel(top.mult(torch.from_numpy(x)).numpy(), yj) < 1e-14
    assert top.nnz == jop.nnz == A.nnz


@pytest.mark.parametrize("kw", [{"m": 40}, {"symmetric": True}])
def test_random_sparse_is_the_references_matrix(kw):
    a = j_random_sparse(60, density=0.1, seed=3, **kw)
    b = tst.random_sparse(60, density=0.1, seed=3, **kw, device="cpu")
    assert b.shape == a.shape
    assert abs(sp.csr_matrix(a.to_scipy()) - b.to_scipy()).max() == 0


def test_petsc_binary_files_cross_between_packages(tmp_path):
    A = _round2_matrix()
    ref_file, port_file = tmp_path / "ref.petsc", tmp_path / "port.petsc"
    jio.write_petsc_matrix(str(ref_file), A)
    tst.write_petsc_matrix(str(port_file), A)
    assert ref_file.read_bytes() == port_file.read_bytes()
    for path in (ref_file, port_file):
        Bj = jio.read_petsc_matrix(str(path))
        Bt = tst.read_petsc_matrix(str(path))
        for name in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(Bt, name), getattr(Bj, name)), name
    op = tst.load_operator(str(ref_file), device="cpu")
    assert isinstance(op, tst.AIJOperator) and op.dtype == torch.float64
    assert np.array_equal(op.to_scipy().toarray(), A.toarray())
    v = np.random.default_rng(8).standard_normal(11)
    jio.write_petsc_vector(str(tmp_path / "v"), v)
    from slepc_tpu_torch.mat import petsc_io

    assert np.array_equal(petsc_io.read_petsc_vector(str(tmp_path / "v")), v)
    petsc_io.write_petsc_vector(str(tmp_path / "w"), v)
    assert (tmp_path / "w").read_bytes() == (tmp_path / "v").read_bytes()
