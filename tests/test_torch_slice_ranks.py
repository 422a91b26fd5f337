"""Spectrum slicing's partitions as ``torch.distributed`` ranks, on gloo
ranks on the CPU, against slepc_tpu's threaded partitions.

Every rank of a task mesh (``set_partitions(p, mesh=make_task_mesh())``)
solves the same whole operator on the same interval with the same p; the
port runs partition i on the lead rank of group i mod the number of
groups (``parallel/tasks.py`` ``slice_partition_leads``, the reference's
``slice_submeshes`` rule) and every rank ends with the whole result.  The
ranks are separate processes (``tests/_torch_ranks.py``, which imports no
JAX), one spawn per world size with all of its cases, each under a
timeout; the reference runs here while they do.  Checked: the
reference's nconv, values (1e-9) and factorization count,
CONVERGED_TOL, every true residual <= 1e-8, rank 1's values and
eigenvectors equal to rank 0's, the one-process port's result, an idle
rank (three ranks, two partitions), complex Hermitian operators (held
against the one-process port and the closed form: the reference counts
the inertia of Re(A), ROADMAP F1), an empty interval, a rank's own solve
without a mesh, and a failed boundary search, a failed partition or
ranks that disagree raising EPSError on every rank.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import slepc_tpu as jst
from slepc_tpu.parallel.tasks import slice_submeshes as jslice
import slepc_tpu_torch as tst
from slepc_tpu_torch.parallel.tasks import (slice_partition_leads,
                                            slice_submeshes)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_ranks as ranks  # noqa: E402

RUNS = {2: ("slice_tri_p2", "slice_tri_p3", "slice_ldl_p2", "slice_ldl_p3",
            "slice_cgrid_p2", "slice_c1d_p3", "slice_empty", "slice_own",
            "slice_fail", "slice_search_fail", "slice_differ"),
        3: ("slice_tri_p2", "slice_ldl_p2")}
SOLVES = [(2, "tri", 2), (2, "tri", 3), (2, "ldl", 2), (2, "ldl", 3),
          (3, "tri", 2), (3, "ldl", 2)]
COMPLEX = [("cgrid", 2, lambda: tst.laplacian_2d_eigs(12, 9)),
           ("c1d", 3, lambda: tst.laplacian_1d_eigs(300))]


def _reference_ops(problem):
    if problem == "tri":
        return [jst.laplacian_1d(400)], (0.5, 0.9), "hep"
    As, bd = ranks.host_ldl_pencil()
    return ([jst.from_scipy(As), jst.DIAOperator((0,), bd[None, :])],
            (0.8, 1.7), "ghep")


def _reference(problem, npart):
    ops, interval, pt = _reference_ops(problem)
    je = jst.EPS(*ops, problem_type=pt, options=jst.Options())
    je.set_interval(*interval)
    je.set_partitions(npart)
    je.solve()
    return je


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, in the background while the reference and the
    one-process port run here."""
    with ThreadPoolExecutor(2) as ex:
        spawned = {w: ex.submit(ranks.spawn,
                                tmp_path_factory.mktemp(f"slice{w}"), w,
                                cases, 90.0)
                   for w, cases in RUNS.items()}
        ref = {(pb, p): _reference(pb, p)
               for pb, p in {(pb, p) for _, pb, p in SOLVES}}
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = {(pb, p): ranks.run_slice(None, pb, p)
                   for pb, p in {(pb, p) for _, pb, p in SOLVES}
                   | {(pb, p) for pb, p, _ in COMPLEX}}
        finally:
            torch.set_num_threads(n)
        return {"ranks": {w: f.result() for w, f in spawned.items()},
                "ref": ref, "one": one}


def teardown_module():
    jax.clear_caches()


@pytest.mark.parametrize("npart,world", [(2, 2), (3, 2), (2, 3), (2, 4),
                                         (4, 8), (3, 8), (9, 8), (1, 4),
                                         (4, 1)])
def test_rank_groups_match_slice_submeshes(npart, world):
    """Partition i goes to the first rank of the card group that
    thread_map_submesh pins item i to (group i mod the number of
    slice_submeshes' groups), and the groups' sizes are the reference's
    on its 8 devices; rank 0 takes all when there is nothing to split."""
    leads = slice_partition_leads(npart, world)
    cards = slice_submeshes(npart, devices=[f"cuda:{i}"
                                            for i in range(world)])
    if cards is None:
        assert leads == [0] * npart
        return
    assert leads == [cards[i % len(cards)][0].index for i in range(npart)]
    assert sorted(set(leads)) == [g[0].index for g in cards]
    if world == len(jax.devices()):
        assert [len(g) for g in cards] == [m.devices.size
                                           for m in jslice(npart)]


def test_the_pencil_is_the_slice_tests():
    """tests/_torch_ranks.py builds tests/test_torch_slice.py's pencil and
    tests/test_torch_inertia.py's gauge transform."""
    from test_torch_inertia import gauge

    As, bd = ranks.host_ldl_pencil()
    perm = np.random.default_rng(0).permutation(70)
    L = np.asarray(jst.laplacian_2d(10, 7).to_dense())
    np.testing.assert_array_equal(As.toarray(), L[perm][:, perm])
    np.testing.assert_array_equal(bd, 1.0 + 0.3 * np.cos(np.arange(70)
                                                         * 0.2))
    L = jst.laplacian_2d(12, 9)
    d = np.asarray(L.diags)
    np.testing.assert_array_equal(ranks.gauge(tuple(L.offsets), d),
                                  gauge(tuple(L.offsets), d))


@pytest.mark.parametrize("world,problem,npart", SOLVES,
                         ids=[f"w{w}-{pb}-p{p}" for w, pb, p in SOLVES])
def test_ranks_match_the_reference(runs, world, problem, npart):
    r = runs["ranks"][world][f"slice_{problem}_p{npart}"]
    je, one = runs["ref"][(problem, npart)], runs["one"][(problem, npart)]
    assert bool(r["ranks"])
    assert int(r["nconv"]) == je.nconv > 5
    assert str(r["reason"]) == "CONVERGED_TOL"
    np.testing.assert_allclose(r["lam"], je.eigenvalues, rtol=1e-9)
    assert int(r["facts"]) == je.slice_factorizations
    # every rank holds rank 0's values and eigenvectors
    assert float(r["dlam"]) == 0.0 and float(r["dX"]) == 0.0
    # F3: the pairs are certified on the pencil, and the errests say so
    assert r["resid"].max() <= 1e-8
    np.testing.assert_allclose(r["errests"], r["resid"], rtol=1e-6,
                               atol=1e-15)
    # the one-process port: the same pairs, iterations and factorizations
    assert not bool(one["ranks"])
    np.testing.assert_allclose(r["lam"], one["lam"], rtol=0, atol=1e-10)
    assert int(r["its"]) == int(one["its"])
    assert int(r["facts"]) == int(one["facts"])
    assert str(r["backends"]) == str(one["backends"])
    # partition i on the lead of group i mod the groups, each one
    # Slice_Partition event on its rank; one gather
    leads = slice_partition_leads(npart, world)
    assert list(r["leads"]) == leads and list(one["leads"]) == [0] * npart
    assert int(r["ev_Partition_count"]) == leads.count(0)
    assert int(one["ev_Partition_count"]) == npart
    assert int(r["ev_Search_count"]) == int(r["ev_Gather_count"]) == 1
    assert int(r["s_allreduce"]) == 2 and int(r["s_allgather"]) == 1
    # a rank sends the largest count's eigenvectors (the counter's bytes
    # are this rank's), so the world's sends hold every pair's
    assert world * int(r["s_allgather_bytes"]) \
        >= int(r["nconv"]) * int(r["n"]) * 8


def test_an_idle_rank_waits_and_returns_the_result(runs):
    """Three ranks, two partitions: rank 2 runs none and still returns
    the whole result (the agreement in dlam / dX spans all three)."""
    r = runs["ranks"][3]["slice_tri_p2"]
    assert list(r["leads"]) == [0, 1]
    assert float(r["dlam"]) == 0.0 and float(r["dX"]) == 0.0
    assert int(r["nconv"]) == runs["ref"][("tri", 2)].nconv


@pytest.mark.parametrize("problem,npart,eigs", COMPLEX,
                         ids=[f"{pb}-p{p}" for pb, p, _ in COMPLEX])
def test_complex_hermitian_ranks(runs, problem, npart, eigs):
    """Complex Hermitian slicing on two ranks, where the largest count a
    rank sends is odd, so the 24-byte rows of values, errests and
    partitions end 8 bytes off the complex128 eigenvectors' alignment
    unless padded: the one-process port's values, iterations and
    factorizations, and every value of the closed form in the interval."""
    r = runs["ranks"][2][f"slice_{problem}_p{npart}"]
    one = runs["one"][(problem, npart)]
    a, b = (1.0, 2.0) if problem == "cgrid" else (0.5, 0.9)
    exact = np.sort(np.asarray(eigs()))
    want = exact[(exact > a) & (exact < b)]
    assert int(r["nconv"]) == int(one["nconv"]) == len(want)
    assert str(r["reason"]) == "CONVERGED_TOL"
    np.testing.assert_allclose(r["lam"], want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(r["lam"], one["lam"], rtol=0, atol=1e-10)
    assert int(r["its"]) == int(one["its"])
    assert int(r["facts"]) == int(one["facts"])
    assert float(r["dlam"]) == 0.0 and float(r["dX"]) == 0.0
    assert r["resid"].max() <= 1e-8
    assert list(r["leads"]) == slice_partition_leads(npart, 2)
    # a rank sends ceil16(24 m) + 16 m n bytes for its largest count m
    n, sent = int(r["n"]), int(r["s_allgather_bytes"])
    m = sent // (24 + 16 * n)
    assert m % 2 == 1 and sent == m * (24 + 16 * n) + 8


def test_empty_interval_on_two_ranks(runs):
    r = runs["ranks"][2]["slice_empty"]
    assert int(r["nconv"]) == 0 and r["lam"].size == 0
    assert str(r["reason"]) == "CONVERGED_TOL"
    assert int(r["facts"]) == 2 and float(r["dlam"]) == 0.0
    # the header alone: every rank returns at the same point
    assert int(r["s_allreduce"]) == 1 and int(r["s_allgather"]) == 0


def test_a_solve_without_a_mesh_is_the_ranks_own(runs):
    """Under a process group of two, a solve given no task mesh runs its
    partitions one after another on its own rank (SLEPc's
    PETSC_COMM_SELF): each rank slices another half of the interval with
    no collective, rank 0's half the one-process port's values there."""
    r = runs["ranks"][2]["slice_own"]
    one = runs["one"][("tri", 2)]
    assert not bool(r["ranks"]) and list(r["leads"]) == [0, 0]
    assert not any(k.startswith("s_") for k in r)
    half = one["lam"][one["lam"] < 0.7]
    np.testing.assert_allclose(r["lam"], half, rtol=0, atol=1e-10)
    assert list(r["counts"]) == [len(half), int(one["nconv"]) - len(half)]


@pytest.mark.parametrize("case,want", [
    ("slice_search_fail", "boundary search failed on rank(s) [1]"),
    ("slice_differ", "differ")])
def test_a_failed_search_or_a_mismatch_raises_on_every_rank(runs, case,
                                                            want):
    """Rank 1's boundary search raises, or rank 1 slices another interval
    over the same mesh: the header all-reduce runs before any branch, so
    every rank raises EPSError (asserted in the spawn) and none waits."""
    r = runs["ranks"][2][case]
    assert bool(r["raised"]) and want in str(r["msg"])


def test_a_failed_partition_raises_on_every_rank(runs):
    """Rank 1's partition raises; each rank asserts in the spawn that it
    raised EPSError naming rank 1 (a rank that did not would fail the
    spawn, and one left waiting would outlive its timeout)."""
    r = runs["ranks"][2]["slice_fail"]
    assert bool(r["raised"])
    assert "rank(s) [1]" in str(r["msg"])
