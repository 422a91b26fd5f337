"""The Chebyshev amplifier and the whole EPS slice of slepc_tpu_torch against
slepc_tpu.

* ChebAmplifyOperator apply: the same operator, window and vector (or a
  (3, n) block, the reference's ``jax.vmap`` of its ``mult``) through both
  packages, relative 1e-12.
* The filter's step: a DIA base takes ``cheb_step`` / ``cheb_step_block``
  (the fused kernel's plain version on the CPU), bitwise equal to the
  product and three passes; an AIJ base, a complex vector on a real DIA
  and a shell base keep the passes.
* The Chebyshev-amplified EPS (-eps_cheb_degree 60) on laplacian_2d(60, 60),
  f64, nev=8, ncv=24 (the tests/test_round5.py:407-433 case): both packages
  agree with the closed-form spectrum and with each other to 1e-10, and the
  port's true residuals are within 1e-8.
* A plain-path EPS solve (laplacian_2d(18, 17), nev=4, largest; the
  tests/test_eps_krylovschur.py:41-46 case): eigenvalues agree to 1e-10.

Each JAX reference runs once per module, in a fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slepc_tpu as jst
from slepc_tpu.st.cheb import ChebAmplifyOperator as JCheb
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop
from slepc_tpu_torch.mat import linop
from slepc_tpu_torch.ops import dia
from slepc_tpu_torch.st.cheb import ChebAmplifyOperator, gershgorin_upper

CHEB_OPTS = "-eps_cheb_degree 60"


def _cheb_eps(pkg):
    A = pkg.laplacian_2d(60, 60, **({"device": "cpu"} if pkg is tst else {}))
    eps = pkg.EPS(A, problem_type="hep", which="smallest_real", nev=8, ncv=24,
                  tol=1e-8, options=pkg.Options.from_cli(CHEB_OPTS))
    eps.solve()
    return eps


@pytest.fixture(scope="module")
def jax_cheb():
    eps = _cheb_eps(jst)
    return np.sort(np.asarray(eps.eigenvalues[:eps.nconv]).real)


@pytest.fixture(scope="module")
def jax_plain():
    eps = jst.EPS(jst.laplacian_2d(18, 17), problem_type="hep",
                  which="largest_real", nev=4)
    eps.solve()
    return np.sort(np.asarray(eps.eigenvalues[:4]).real)


def test_amplifier_apply_matches_reference():
    _apply_matches_reference("mult")


def test_amplifier_apply_block_matches_reference():
    _apply_matches_reference("mult_block")


def _apply_matches_reference(form):
    A = jst.laplacian_2d(30, 28)
    top = interop.dia_from_slepc_tpu(A, device="cpu")
    lo, hi, deg = 0.05, gershgorin_upper(top), 60
    assert hi == 8.0
    rng = np.random.default_rng(4)
    if form == "mult":
        x = rng.standard_normal(A.shape[0])
        yj = np.asarray(JCheb(A, lo, hi, deg).mult(jnp.asarray(x)))
    else:
        x = rng.standard_normal((3, A.shape[0]))
        yj = np.asarray(jax.vmap(JCheb(A, lo, hi, deg).mult)(jnp.asarray(x)))
    yt = getattr(ChebAmplifyOperator(top, lo, hi, deg), form)(
        torch.from_numpy(x)).numpy()
    assert np.abs(yt - yj).max() / np.abs(yj).max() < 1e-12


def _three_passes(apply, x, lo, hi, deg):
    """The filter as the recurrence ran before its step was fused: the
    product, then mul_, add_ and sub_ in place."""
    a, b = 2.0 / (hi - lo), (hi + lo) / (hi - lo)
    tm1, tk = x, apply(x).mul_(-a).add_(x, alpha=b)
    for _ in range(1, deg):
        tm1, tk = tk, apply(tk).mul_(-2.0 * a).add_(tk, alpha=2.0 * b) \
            .sub_(tm1)
    return tk


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts of the calls DIAOperator makes to the fused steps."""
    calls = {"dia_cheb_step": 0, "dia_cheb_step_block": 0}

    def counted(name):
        fn = getattr(dia, name)

        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    for name in calls:
        monkeypatch.setattr(linop, name, counted(name))
    return calls


@pytest.mark.parametrize("form,dtype", [("mult", torch.float64),
                                        ("mult_block", torch.float64),
                                        ("mult", torch.float32),
                                        ("mult_block", torch.float32)])
def test_amplifier_takes_the_fused_step_on_a_dia_base(fused_calls, form,
                                                     dtype):
    A = tst.laplacian_3d(9, 10, 11, dtype=dtype, device="cpu")
    lo, hi, deg = 0.3, gershgorin_upper(A), 25
    shape = (A.shape[0],) if form == "mult" else (4, A.shape[0])
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(shape)) \
        .to(dtype)
    x0 = x.clone()
    y = getattr(ChebAmplifyOperator(A, lo, hi, deg), form)(x)
    name = "dia_cheb_step" if form == "mult" else "dia_cheb_step_block"
    assert fused_calls[name] == deg
    assert sum(fused_calls.values()) == deg
    apply = A.mult if form == "mult" else A.mult_block
    assert torch.equal(y, _three_passes(apply, x, lo, hi, deg))
    assert torch.equal(x, x0)  # the input is not written


def test_fused_step_plain_versions_are_the_passes():
    offsets = (-7, -1, 0, 1, 7)
    rng = np.random.default_rng(6)
    d = torch.from_numpy(rng.standard_normal((5, 50)))
    T = torch.from_numpy(rng.standard_normal((3, 50)))
    P = torch.from_numpy(rng.standard_normal((3, 50)))
    T0, P0 = T.clone(), P.clone()
    for p in (None, P):
        y = dia.dia_cheb_step(offsets, d, T[1], None if p is None else p[1],
                              -0.7, 1.3)
        want = dia.dia_spmv_ref(offsets, d, T[1]).mul_(-0.7).add_(T[1],
                                                                  alpha=1.3)
        assert torch.equal(y, want if p is None else want.sub_(p[1]))
        Y = dia.dia_cheb_step_block(offsets, d, T, p, -0.7, 1.3)
        assert torch.equal(Y[1], y)
    assert torch.equal(T, T0) and torch.equal(P, P0)
    with pytest.raises(ValueError, match="does not match"):
        dia.dia_cheb_step(offsets, d, T[1], P[1, :49], -0.7, 1.3)
    with pytest.raises(ValueError, match="does not match"):
        dia.dia_cheb_step_block(offsets, d, T, P[:2], -0.7, 1.3)


def _shell(A):
    return tst.ShellOperator(A.shape, A.dtype, A.mult, device="cpu")


@pytest.mark.parametrize("case", ["aij", "complex_x", "shell", "row_shard"])
def test_amplifier_keeps_the_passes_elsewhere(fused_calls, case):
    A = tst.laplacian_2d(16, 16, device="cpu")  # n = 256: no ragged tail
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        A.shape[0]))
    if case == "aij":
        base = tst.from_scipy(A.to_scipy(), device="cpu")
    elif case == "shell":
        base = _shell(A)
    elif case == "row_shard":
        # a row-partitioned DIA operator (sys/mesh.py sets these hooks to
        # its ranks' products); plain products stand in for them here
        base = tst.DIAOperator(A.offsets, A.diags)
        base.row_shard = lambda v: dia.dia_spmv_ref(A.offsets, A.diags, v)
        base.row_shard_block = lambda V: dia.dia_spmm_ref(A.offsets, A.diags,
                                                          V)
    else:
        base = A
        x = torch.complex(x, torch.from_numpy(
            np.random.default_rng(8).standard_normal(A.shape[0])))
    lo, hi, deg = 0.2, 8.0, 15
    op = ChebAmplifyOperator(base, lo, hi, deg)
    y = op.mult(x)
    Y = op.mult_block(torch.stack([x, 2 * x]))
    assert sum(fused_calls.values()) == 0
    assert torch.equal(y, _three_passes(base.mult, x, lo, hi, deg))
    assert torch.equal(Y[0], y)


def test_cheb_eps_slice_matches_reference_and_closed_form(jax_cheb):
    exact = tst.laplacian_2d_eigs(60, 60, k=8)
    eps = _cheb_eps(tst)
    assert eps.nconv >= 8 and len(jax_cheb) >= 8
    lam = np.sort(eps.eigenvalues[:8])
    assert np.abs(lam - exact).max() < 1e-10
    assert np.abs(jax_cheb[:8] - exact).max() < 1e-10
    assert np.abs(lam - jax_cheb[:8]).max() < 1e-10
    assert max(eps.compute_error(i) for i in range(8)) < 1e-8
    assert eps.cheb_stats["certs"] >= 1


def test_plain_eps_matches_reference(jax_plain):
    eps = tst.EPS(tst.laplacian_2d(18, 17, device="cpu"), problem_type="hep",
                  which="largest_real", nev=4)
    eps.solve()
    assert eps.nconv >= 4
    lam = np.sort(eps.eigenvalues[:4])
    assert np.abs(lam - jax_plain).max() < 1e-10
    exact = np.sort(tst.laplacian_2d_eigs(18, 17))[::-1][:4]
    assert np.abs(lam[::-1] - exact).max() < 1e-10
    lam0, x0 = eps.get_eigenpair(0)
    assert x0.shape == (18 * 17,) and eps.compute_error(0) < 1e-8


# GHIEP (no B: the identity metric, signature +1 throughout) and the
# two-sided variant (a Hermitian problem: the general loop, the left
# vectors a copy of the right ones) raised NotImplementedError until item
# 11d was ported; each now solves and is held against the reference (the
# same nconv and its, the values to 1e-10).  The ids are the ones the
# raising cases had.
@pytest.mark.parametrize("kw", [
    {"problem_type": "ghiep"},
    {"problem_type": "hep", "which": "largest_real", "cli": "-eps_two_sided"},
], ids=["kw0-item 11", "kw1-item 11"])
def test_ghiep_and_two_sided_paths_solve_as_the_reference(kw):
    kw = dict(kw)
    cli = kw.pop("cli", "")
    out = []
    for pkg in (jst, tst):
        A = pkg.laplacian_1d(20) if pkg is jst else \
            pkg.laplacian_1d(20, device="cpu")
        eps = pkg.EPS(A, nev=2, options=pkg.Options.from_cli(cli), **kw)
        eps.solve()
        out.append(eps)
    je, te = out
    assert te.nconv == je.nconv >= 2 and te.its == je.its
    np.testing.assert_allclose(np.real(te.eigenvalues[:2]),
                               np.real(je.eigenvalues[:2]), rtol=0, atol=1e-10)
    exact = np.sort(tst.laplacian_1d_eigs(20))[::-1][:2]
    np.testing.assert_allclose(np.real(te.eigenvalues[:2]), exact, rtol=0,
                               atol=1e-10)
    if te.two_sided:
        for i in range(2):
            y = te.get_left_eigenvector(i)
            assert te.compute_error(i) < 1e-8
            assert torch.equal(y, te._eigenvectors[i])


@pytest.mark.parametrize("block", [1, 4])
def test_a_window_that_amplified_nothing_raises(block):
    # degree 450 on a small grid: the first window, clamped against
    # lambda_1 = 0, puts lo at 0.017, below lambda_1 = 0.2995, so nothing
    # is amplified and bulk rows get locked; the next window, clamped
    # against their Rayleigh quotient, amplifies lambda_1 past the range
    # bound.  The solve raises, naming the degree and the window (the
    # reference returns a short count, or nconv 0 at b = 4; the
    # laplacian_3d(30, 32, 34) case of ROADMAP.md shows the same)
    from slepc_tpu_torch.eps.cheb_accel import ks_cheb_smallest

    A = tst.laplacian_3d(8, 9, 10, device="cpu")
    with pytest.raises(tst.EPSError, match=r"degree 450 on the window "
                       r"\[[0-9.]+, 12\]") as err:
        ks_cheb_smallest(A, nev=3, tol=1e-8, ncv=12, degree=450,
                         keep_den=3, block=block)
    assert "amplified nothing" in str(err.value)
