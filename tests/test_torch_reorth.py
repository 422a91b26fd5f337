"""The light reorthogonalizations of the port's Krylov-Schur cycle against
slepc_tpu.

* Restart cycles with ``reorth`` = "partial" (Simon's omega monitor),
  "selective" (nsel locked rows) and a period of 3, run after four full
  cycles have locked rows, all chained from the same start vector through
  both packages on a flat f64 operator (laplacian_2d(10, 9), ncv 20):
  the same kl and k2 every cycle, Ritz values within 1e-11, basis rows
  within 1e-10 after aligning each row's sign (projected eigenvectors are
  defined up to sign).
* EPS with each of the six kinds of ``set_reorthogonalization`` (and the
  ``-eps_lanczos_reorthog`` option): the port within 1e-10 of the closed
  form, and for "partial" within 1e-10 of the reference EPS
  (laplacian_2d(18, 17), nev=4, largest; the
  tests/test_eps_krylovschur.py:41-46 case).
* ks_cheb_smallest(reorth="partial") on laplacian_2d(80, 80), nev 10,
  ncv 32, degree 80 (tests/test_round5.py:55-76): both packages within
  1e-10 of the closed form and of each other, residuals within 1e-8, and
  at most 1.5x the columns of reorth="full".

Each JAX reference solve runs once per module, in a fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slepc_tpu as jst
from slepc_tpu.eps.cheb_accel import ks_cheb_smallest as j_cheb
from slepc_tpu.eps.ks_jit import ks_hep_cycle as j_cycle
from slepc_tpu.mat.generators import laplacian_2d
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop
from slepc_tpu_torch.eps.cheb_accel import ks_cheb_smallest
from slepc_tpu_torch.eps.ks_jit import _init_rows, ks_hep_cycle

_MODES = {"partial": {"reorth": "partial"},
          "selective": {"reorth": "selective", "nsel": 4},
          "periodic": {"reorth": "periodic", "reorth_period": 3}}


@pytest.mark.parametrize("mode", list(_MODES))
def test_light_reorth_cycles_match_reference(mode):
    # four full-CGS2 cycles lock the leading Ritz rows, then three cycles of
    # the light mode run from that restart state (selective projects
    # against the locked rows; the omega monitor starts on a restarted
    # block)
    side, ncv = 10, 20
    A = laplacian_2d(side, side - 1)
    n = A.shape[0]
    v0 = _init_rows(n, 1, np.float64)
    Vj = jnp.zeros((ncv + 1, n)).at[0].set(jnp.asarray(v0[0]))
    Hj = jnp.zeros((ncv + 1, ncv))
    top = interop.dia_from_slepc_tpu(A, device="cpu")
    V = torch.zeros((ncv + 1, n), dtype=torch.float64)
    V[0] = torch.from_numpy(v0[0])
    H = np.zeros((ncv + 1, ncv))
    gen = torch.Generator().manual_seed(0)
    j0 = k2 = 0
    for cycle in range(7):
        kw = _MODES[mode] if cycle >= 4 else {}
        if cycle == 4:
            assert k2 >= 2
        oj = j_cycle(A, Vj, Hj, jnp.asarray(j0), 1e-8, jax.random.PRNGKey(0),
                     ncv=ncv, which="largest", nlock=k2, **kw)
        ot = ks_hep_cycle(top, V, H, j0, 1e-8, gen, ncv=ncv, which="largest",
                          nlock=k2, **kw)
        assert (int(oj[2]), int(oj[3])) == (ot[2], ot[3])  # kl, k2
        assert np.abs(np.asarray(oj[4]) - ot[4]).max() < 1e-11
        Vj, Hj, j0, k2 = oj[0], oj[1], ot[2], ot[3]
        V, H = ot[0], ot[1]
        Vjn, Vt = np.asarray(Vj), V.numpy()
        sign = np.sign(np.sum(Vjn * Vt, axis=1))
        assert np.abs(Vjn - sign[:, None] * Vt).max() < 1e-10


def _plain_eps(pkg, kind=None, options=None):
    kw = {"device": "cpu"} if pkg is tst else {}
    eps = pkg.EPS(pkg.laplacian_2d(18, 17, **kw), problem_type="hep",
                  which="largest_real", nev=4, options=options)
    if kind is not None:
        eps.set_reorthogonalization(kind)
    eps.solve()
    return eps


@pytest.fixture(scope="module")
def jax_ref():
    eps = _plain_eps(jst, "partial")
    res = j_cheb(laplacian_2d(80, 80), nev=10, tol=1e-8, ncv=32, degree=80,
                 reorth="partial", key=jax.random.PRNGKey(7))
    return {"eps": np.sort(np.asarray(eps.eigenvalues[:4]).real),
            "cheb": (res["nconv"], np.sort(np.asarray(res["lam"])))}


@pytest.mark.parametrize("kind", ["full", "partial", "periodic", "selective",
                                  "delayed", "local"])
def test_eps_reorthogonalization_kinds(jax_ref, kind):
    exact = np.sort(tst.laplacian_2d_eigs(18, 17))[::-1][:4]
    eps = _plain_eps(tst, kind)
    assert eps.reorth == kind and eps.nconv >= 4
    lam = np.sort(eps.eigenvalues[:4])[::-1]
    assert np.abs(lam - exact).max() < 1e-10
    assert max(eps.compute_error(i) for i in range(4)) < 1e-8
    if kind == "partial":
        assert np.abs(np.sort(lam) - jax_ref["eps"]).max() < 1e-10
    if kind == "periodic":
        assert eps.reorth_period == 4


def test_reorthogonalization_option_and_unknown_kind():
    eps = _plain_eps(tst, options=tst.Options.from_cli(
        "-eps_lanczos_reorthog partial"))
    assert eps.reorth == "partial" and eps.nconv >= 4
    with pytest.raises(ValueError, match="one of"):
        tst.EPS(tst.laplacian_1d(10, device="cpu")).set_reorthogonalization("sometimes")


def test_cheb_partial_matches_reference_and_closed_form(jax_ref):
    A = tst.laplacian_2d(80, 80, device="cpu")
    exact = tst.laplacian_2d_eigs(80, 80, k=10)
    cols = {}
    for reo in ("full", "partial"):
        res = ks_cheb_smallest(A, nev=10, tol=1e-8, ncv=32, degree=80,
                               reorth=reo)
        assert res["nconv"] >= 10
        cols[reo] = res["stats"]["cols"]
    lam = np.sort(res["lam"][:10])
    j_nconv, j_lam = jax_ref["cheb"]
    assert j_nconv >= 10
    assert np.abs(lam - exact).max() < 1e-10
    assert np.abs(j_lam[:10] - exact).max() < 1e-10
    assert np.abs(lam - j_lam[:10]).max() < 1e-10
    assert np.max(res["resid"][:10]) < 1e-8
    # the whole point of the partial mode: no column penalty
    assert cols["partial"] <= 1.5 * cols["full"]
