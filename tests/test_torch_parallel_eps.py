"""The Hermitian fast path on the port's row partition (gloo ranks, CPU):
the Krylov-Schur cycle on the halo operator, EPS in f64 and f32, the
Chebyshev driver plain and blocked, the blocked cycle, partial
reorthogonalization and the partitioned CSR form, each against the
one-rank port and, where it runs in seconds, the reference; with the
collective budget read from the mesh's counters.

The ranks are ``tests/_torch_ranks.py`` processes (no JAX), 2 and 4 of
them, one spawn a world size.  The reference's sharded fast path takes
minutes to compile on its 8-device mesh (``tests/test_multichip.py`` marks
it slow), so the EPS cases hold the partition to the reference's
one-device solve and to the closed forms its tests use.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import slepc_tpu as jst
from slepc_tpu.mat.generators import laplacian_2d_eigs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_ranks as ranks  # noqa: E402

CASES = ("ks_cycle", "eps_f64", "eps_f32", "eps_c128", "cheb",
         "cheb_blocked", "blocked", "partial", "csr_rcm", "fallback")


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranked(request, tmp_path_factory):
    return ranks.spawn(tmp_path_factory.mktemp(f"w{request.param}"),
                       request.param, CASES)


@pytest.fixture(scope="module")
def one_rank():
    torch.set_num_threads(1)
    return {c: ranks.run_case(c, None) for c in CASES}


@pytest.fixture(scope="module")
def reference():
    """The reference's counterparts: the halo cycle on its 8-device mesh,
    the one-device fast path and Chebyshev solves."""
    from slepc_tpu.eps.ks_jit import ks_hep_cycle
    from slepc_tpu.parallel import HaloDIAOperator
    from slepc_tpu.sys import mesh as jmesh

    out = {}
    m = Mesh(np.asarray(jax.devices()).reshape(-1), ("rows",))
    jmesh.set_mesh(m)
    try:
        A = jst.laplacian_2d(32, 30)
        H = HaloDIAOperator.from_dia(A, m)
        n, ncv = A.shape[0], 24
        v0 = np.random.default_rng(0).standard_normal(n)
        v0 /= np.linalg.norm(v0)
        V = jnp.zeros((ncv + 1, n)).at[0].set(jnp.asarray(v0))
        V = jax.device_put(V, NamedSharding(m, P(None, "rows")))
        Hm = jnp.zeros((ncv + 1, ncv))
        j0, key = jnp.asarray(0), jax.random.PRNGKey(0)
        for _ in range(60):
            V, Hm, j0, k2, theta, errest, beta = ks_hep_cycle(
                H, V, Hm, j0, 1e-10, key, ncv=ncv, which="largest")
            if int(k2) >= 4:
                break
        out["ks_cycle"] = np.asarray(theta)[:4]
    finally:
        jmesh.set_mesh(None)
    eps = jst.EPS(jst.laplacian_1d(128), problem_type="hep",
                  which="smallest_real", nev=4, ncv=48, max_it=400)
    eps.solve()
    out["eps_f64"] = (eps.nconv, np.asarray(eps.eigenvalues[:eps.nconv]))
    eps = jst.EPS(jst.laplacian_3d(10, 11, 12), problem_type="hep",
                  which="smallest_real", nev=6, tol=1e-8,
                  options=jst.Options.from_cli(
                      "-eps_ncv 24 -eps_cheb_degree 40"))
    eps.solve()
    out["cheb"] = (eps.nconv, np.asarray(eps.eigenvalues[:eps.nconv]))
    return out


def teardown_module():
    jax.clear_caches()


def test_halo_ks_cycle_end_to_end(ranked, one_rank, reference):
    """The cycle over the halo operator reaches the closed form, as the
    reference's does on its 8-device mesh."""
    r = ranked["ks_cycle"]
    exact = laplacian_2d_eigs(32, 30)[::-1][:4]
    np.testing.assert_allclose(r["theta"], exact, rtol=1e-9)
    np.testing.assert_allclose(r["theta"], reference["ks_cycle"], rtol=1e-9)
    np.testing.assert_allclose(r["theta"], one_rank["ks_cycle"]["theta"],
                               rtol=1e-12)


def test_plain_cycle_collective_budget(ranked):
    """At most 3 all-reduces a column of the plain cycle (the two CGS2
    sweeps' coefficients and the norm), one halo exchange an SpMV and no
    all-gather."""
    r = ranked["ks_cycle"]
    ncv = int(r["ncv"])
    assert r["first_allreduce"] <= 3 * ncv
    assert r["first_halo"] == ncv and r["first_allgather"] == 0


def test_sharded_eps_fast_path(ranked, one_rank, reference):
    """EPS routes the DIA operator to the halo form under a mesh; f64, the
    reference's sharded case (laplacian_1d(128), nev 4, ncv 48)."""
    r, one = ranked["eps_f64"], one_rank["eps_f64"]
    exact = jst.mat.generators.laplacian_1d_eigs(128)
    assert int(r["nconv"]) == int(one["nconv"]) >= 4
    np.testing.assert_allclose(r["lam"][:4], exact[:4], rtol=1e-7)
    np.testing.assert_allclose(r["lam"], one["lam"], rtol=1e-10)
    nconv_ref, lam_ref = reference["eps_f64"]
    np.testing.assert_allclose(r["lam"][:4], lam_ref[:4], rtol=1e-10)
    assert r["resid"].max() <= 1e-8
    assert r["n_halo"] > 0 and r["n_allgather"] == 0


def test_sharded_pallas_ks_end_to_end(ranked, one_rank):
    """The reference's f32 case on its padded sharded kernel:
    laplacian_2d(64, 64), nev 4, tol 1e-5, to 1e-3 of the closed form."""
    r = ranked["eps_f32"]
    exact = laplacian_2d_eigs(64, 64, k=4)
    assert int(r["nconv"]) >= 4
    np.testing.assert_allclose(np.sort(r["lam"]), exact[:4], rtol=1e-3)
    np.testing.assert_allclose(r["lam"], one_rank["eps_f32"]["lam"],
                               rtol=1e-3)
    assert r["n_halo"] > 0 and r["n_allgather"] == 0


def test_complex_hermitian_on_the_mesh(ranked, one_rank):
    """A complex Hermitian DIA operator: K2c on the slab, the complex
    coefficients summed over the ranks."""
    r, one = ranked["eps_c128"], one_rank["eps_c128"]
    d = ranks.c128_diags()
    dense = np.diag(d[1]) + np.diag(d[0][1:], -1) + np.diag(d[2][:-1], 1)
    exact = np.linalg.eigvalsh(dense)[::-1]
    assert int(r["nconv"]) == int(one["nconv"]) >= 4
    np.testing.assert_allclose(r["lam"][:4], exact[:4], rtol=1e-10)
    np.testing.assert_allclose(r["lam"], one["lam"], rtol=1e-10)
    assert r["resid"].max() <= 1e-8
    assert r["n_halo"] > 0 and r["n_allgather"] == 0


def test_cheb_smallest_on_the_mesh(ranked, one_rank, reference):
    r, one = ranked["cheb"], one_rank["cheb"]
    assert int(r["nconv"]) == int(one["nconv"]) == reference["cheb"][0]
    np.testing.assert_allclose(r["lam"], one["lam"], rtol=1e-10)
    np.testing.assert_allclose(r["lam"], reference["cheb"][1], rtol=1e-10)
    assert r["resid"].max() <= 1e-8
    assert r["n_allgather"] == 0 and r["n_halo"] > 0


def test_cheb_blocked_on_the_mesh(ranked, one_rank):
    r, one = ranked["cheb_blocked"], one_rank["cheb_blocked"]
    assert int(r["nconv"]) == int(one["nconv"])
    np.testing.assert_allclose(r["lam"], one["lam"], rtol=1e-10)
    assert r["resid"].max() <= 1e-8
    assert r["n_allgather"] == 0


def test_blocked_cycle_on_the_mesh(ranked, one_rank):
    r, one = ranked["blocked"], one_rank["blocked"]
    exact = laplacian_2d_eigs(30, 29, k=4)
    assert int(r["nconv"]) == int(one["nconv"]) >= 4
    np.testing.assert_allclose(r["lam"][:4], exact[:4], rtol=1e-9)
    np.testing.assert_allclose(r["lam"], one["lam"], rtol=1e-10)
    assert r["resid"].max() <= 1e-8
    assert r["n_allgather"] == 0 and r["n_halo"] > 0


def test_partial_reorthogonalization_on_the_mesh(ranked, one_rank):
    r, one = ranked["partial"], one_rank["partial"]
    assert int(r["nconv"]) == int(one["nconv"]) >= 4
    np.testing.assert_allclose(r["lam"], one["lam"], rtol=1e-10)
    assert r["resid"].max() <= 1e-8


def test_csr_rcm_partitioned(ranked, one_rank):
    """An RCM-ordered laplacian_2d(64, 64) CSR (4,096 rows) routes to the
    partitioned CSR form: K6 on the slab, halo exchanges, no all-gather."""
    r, one = ranked["csr_rcm"], one_rank["csr_rcm"]
    exact = laplacian_2d_eigs(64, 64, k=10)
    distinct = exact[np.r_[True, np.diff(exact) > 1e-9]]  # single Krylov
    assert int(r["nconv"]) == int(one["nconv"]) >= 4     # sees one copy
    np.testing.assert_allclose(np.sort(r["lam"])[:4], distinct[:4],
                               rtol=1e-9)
    np.testing.assert_allclose(r["lam"], one["lam"], rtol=1e-10)
    assert r["resid"].max() <= 1e-8
    assert r["n_halo"] > 0 and r["n_allgather"] == 0


def test_wide_reach_falls_back_without_touching_the_operator(ranked,
                                                              one_rank):
    """A reach past the nearest neighbour takes shard_operator's form for
    the solve (all-gathers, no halo); the operator handed in is not
    sharded afterwards (its products issue no collective)."""
    r, o = ranked["fallback"], one_rank["fallback"]
    assert int(r["nconv"]) == int(o["nconv"]) >= 4
    np.testing.assert_allclose(r["lam"][:4], o["lam"][:4], rtol=0,
                               atol=1e-10)
    assert np.max(r["resid"][:4]) <= 1e-8
    assert r["n_allgather"] > 0 and r["n_halo"] == 0
    assert bool(r["untouched"]) and int(r["after_gathers"]) == 0
    # A times ones: every row's sum, the diagonal less its two -1 entries
    np.testing.assert_allclose(
        r["y_after"], 6.0 * np.linspace(0.0, 1.0, 64) ** 8, rtol=0,
        atol=1e-14)
