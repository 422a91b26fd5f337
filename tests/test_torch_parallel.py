"""The port's row partition on gloo ranks (CPU): the mesh, the halo SpMVs,
``shard_operator``, TSQR and the task meshes, against the reference's
counterparts on its 8-device mesh and against the one-rank port.

Mirrors ``tests/test_multichip.py`` and ``tests/test_multihost_2proc.py``.
The ranks are separate processes (``tests/_torch_ranks.py``, which imports
no JAX), 2 and 4 of them, one spawn for all the cases of a world size, with
a timeout; the reference runs here.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import slepc_tpu as jst
from slepc_tpu.sys import mesh as jmesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_ranks as ranks  # noqa: E402

CASES = ("spmv_shard", "halo_spmv", "halo_spmm", "halo_adjoint",
         "halo_numpy",
         "padded_f32", "ring",
         "tsqr", "bv_tsqr", "task_ciss", "markov_nhep", "svd_shard",
         "svd_dense")
@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranked(request, tmp_path_factory):
    return ranks.spawn(tmp_path_factory.mktemp(f"w{request.param}"),
                       request.param, CASES)


@pytest.fixture(scope="module")
def one_rank():
    """The same cases on the one-rank port (no mesh), here."""
    torch.set_num_threads(1)
    return {c: ranks.run_case(c, None) for c in CASES}


@pytest.fixture
def row_mesh():
    m = Mesh(np.asarray(jax.devices()).reshape(-1), ("rows",))
    jmesh.set_mesh(m)
    yield m
    jmesh.set_mesh(None)


def teardown_module():
    jax.clear_caches()


def test_halo_rmult_and_to_dense_match(ranked, one_rank):
    """HaloDIAOperator.rmult is the adjoint apply and to_dense the global
    matrix on every rank, as the one-rank operator's mult_h and to_dense
    (and the reference's to_dense of the same diagonals)."""
    from slepc_tpu.parallel import HaloDIAOperator

    r, one = ranked["halo_adjoint"], one_rank["halo_adjoint"]
    np.testing.assert_allclose(r["yh"], one["yh"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(r["dense"], one["dense"])
    rng = np.random.default_rng(2)
    d = rng.standard_normal((3, 300))
    x = rng.standard_normal(300)
    np.testing.assert_array_equal(r["dense"], np.asarray(
        HaloDIAOperator((-2, 0, 1), d, Mesh(np.asarray(jax.devices()[:1]),
                                            ("rows",))).to_dense()))
    np.testing.assert_allclose(r["yh"], one["dense"].T @ x, atol=1e-12)


def test_sharded_spmv_matches(ranked, row_mesh):
    r = ranked["spmv_shard"]
    x = np.random.default_rng(0).standard_normal(1024)
    A = jst.laplacian_1d(1024)
    As = A.to_scipy()
    jmesh.shard_operator(A, row_mesh)
    xj = jax.device_put(jnp.asarray(x), NamedSharding(row_mesh, P("rows")))
    y_ref = np.asarray(jax.jit(A.mult)(xj))
    np.testing.assert_allclose(r["y"], As @ x, rtol=1e-12)
    np.testing.assert_allclose(r["y"], y_ref, rtol=1e-12)
    assert str(r["form"]) == "rows"
    assert r["n_allgather"] == 1 and r["n_halo"] == 0
    # shard_operator returns a copy: the operator handed in still runs
    # alone, with no collective
    assert str(r["orig_form"]) == "None" and int(r["orig_gathers"]) == 0
    assert bool(r["orig_equal"])


def test_halo_spmv_matches_and_avoids_allgather(ranked, one_rank,
                                                row_mesh):
    from slepc_tpu.parallel import HaloDIAOperator

    r, one = ranked["halo_spmv"], one_rank["halo_spmv"]
    # the one-rank port's K2 (plain version here), and the reference
    np.testing.assert_allclose(r["y"], one["y"], atol=1e-12)
    np.testing.assert_allclose(r["y2"], one["y2"], atol=1e-12)
    A = jst.laplacian_2d(40, 40)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    H = HaloDIAOperator.from_dia(A, row_mesh)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(row_mesh, P("rows")))
    np.testing.assert_allclose(r["y"], np.asarray(H.mult(xs)), atol=1e-12)
    assert bool(r["halos_zero"]) and bool(r["fn_equal"])
    # one exchange an SpMV, no all-gather
    assert r["n_halo"] == 2 and r["n_allgather"] == 0
    assert r["n_halo_bytes"] > 0


def test_halo_spmm_one_exchange_a_block(ranked, one_rank):
    """The twin of tests/test_round2.py::test_halo_block_mult_single_exchange:
    a block of 5 rows is one halo exchange (read from RowMesh.counters; the
    reference reads two collective-permutes off the HLO) and its product is
    A X to 1e-12."""
    r = ranked["halo_spmm"]
    np.testing.assert_allclose(r["Y"], one_rank["halo_spmm"]["Y"],
                               atol=1e-12)
    X = np.random.default_rng(1).standard_normal((5, 1600))
    np.testing.assert_allclose(
        r["Y"], (jst.laplacian_2d(40, 40).to_scipy() @ X.T).T, atol=1e-12)
    assert r["n_halo"] == 1 and r["n_allgather"] == 0
    assert bool(r["fn_equal"])


def test_sharded_pallas_dia_spmv(ranked, row_mesh):
    from slepc_tpu.parallel.halo_pallas import ShardedDIAPaddedOperator

    r = ranked["padded_f32"]
    A = jst.laplacian_2d(64, 64, dtype=np.float32)
    As = A.to_scipy()
    x = np.random.default_rng(0).standard_normal(A.shape[0]).astype(
        np.float32)
    ref = As @ x
    np.testing.assert_allclose(r["y"], ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["y2"], As @ ref, rtol=1e-4, atol=1e-4)
    op = ShardedDIAPaddedOperator.from_dia(A, row_mesh)
    np.testing.assert_allclose(r["y"], op.unpad(op.mult2d(op.pad2d(x))),
                               rtol=1e-5, atol=1e-5)
    assert r["n_halo"] == 2 and r["n_allgather"] == 0


def test_halo_takes_numpy_shards(ranked):
    """The array rule on the partition: HaloDIAOperator's mult, mult_h,
    rmult and mult_block, the module's dia_spmv_halo / dia_spmm_halo and
    ShardedGELLPaddedOperator.mult_h take a rank's numpy shard (its slab
    row, or its own rows between zero halos) and give the tensor slab's
    answer, as a tensor on the rank's device; the gathered tensor products
    are the global operator's."""
    r = ranked["halo_numpy"]
    names = [str(s) for s in r["names"]]
    assert len(names) == 7 * 2 + 5
    for name, err, is_t in zip(names, r["errs"], r["tensors"]):
        assert is_t, name
        assert err <= (1e-12 if name.endswith(":tensor") else 0.0), \
            (name, err)


def test_two_rank_reduction_and_exchange(ranked):
    """``test_multihost_2proc.py``'s checks: a reduction across the ranks
    and boundary rows crossing a rank boundary."""
    r = ranked["ring"]
    x = np.arange(1024, dtype=np.float64)
    assert abs(float(r["sumsq"]) - float(np.sum(x * x))) <= 1e-6 * np.sum(x * x)
    assert bool(r["halo_ok"])
    assert r["n_allreduce"] == 1 and r["n_halo"] == 1


def test_tsqr(ranked, row_mesh):
    from slepc_tpu.bv.orthog import tsqr_shard_map

    r = ranked["tsqr"]
    X = np.random.default_rng(0).standard_normal((512, 12))
    Q, R = r["Q"].T, r["R"]
    np.testing.assert_allclose(Q.T @ Q, np.eye(12), atol=1e-12)
    np.testing.assert_allclose(Q @ R, X, atol=1e-12)
    assert np.abs(np.tril(R, -1)).max() < 1e-12
    assert r["n_allgather"] == 1 and r["n_allreduce"] == 0
    Xs = jax.device_put(jnp.asarray(X), NamedSharding(row_mesh,
                                                      P("rows", None)))
    _, R_ref = tsqr_shard_map(Xs, row_mesh)
    # R is unique up to the signs of its rows
    np.testing.assert_allclose(np.abs(R), np.abs(np.asarray(R_ref)),
                               atol=1e-12)


def test_bv_tsqr_block_type(ranked, one_rank):
    r, one = ranked["bv_tsqr"], one_rank["bv_tsqr"]
    X = np.random.default_rng(2).standard_normal((8, 600))
    Q = r["Q"]
    np.testing.assert_allclose(Q @ Q.T, np.eye(8), atol=1e-12)
    np.testing.assert_allclose(Q.T @ r["R"], X.T, atol=1e-12)
    np.testing.assert_allclose(np.abs(r["R"]), np.abs(one["R"]), atol=1e-12)


def test_ciss_batched_task_parallel(ranked, one_rank):
    from slepc_tpu.parallel.tasks import batched_shifted_solves, make_task_mesh

    r = ranked["task_ciss"]
    n = 120
    A = jst.laplacian_1d(n)
    V = np.random.default_rng(0).standard_normal((n, 4))
    rg = jst.RGEllipse(center=0.65, radius=0.16, vscale=0.3)
    z, _ = rg.contour(16)
    Ad = np.asarray(A.to_dense())
    for j, got in ((0, r["Y0"]), (7, r["Y7"])):
        Yref = np.linalg.solve(z[j] * np.eye(n) - Ad, V.astype(complex))
        np.testing.assert_allclose(got.T, Yref, atol=1e-7)
    tm = make_task_mesh(8)
    Y_ref = np.asarray(batched_shifted_solves(A, None, z, V, tol=1e-12,
                                              mesh=tm))
    np.testing.assert_allclose(r["Y0"].T, Y_ref[0], atol=1e-7)
    assert int(r["npt"]) == 16 and r["n_allgather"] == 1
    eps = jst.EPS(A, problem_type="hep", solver="ciss", tol=1e-9)
    eps.ciss_solver = "batched"
    eps.ciss_task_mesh = tm
    eps.set_rg(rg)
    eps.solve()
    exact = jst.mat.generators.laplacian_1d_eigs(n)
    inside = np.sort(exact[np.abs(exact - 0.65) < 0.16])
    assert int(r["nconv"]) == eps.nconv == len(inside)
    np.testing.assert_allclose(r["lam"], inside, rtol=1e-7)
    np.testing.assert_allclose(r["lam"], one_rank["task_ciss"]["lam"],
                               rtol=1e-10)


@pytest.fixture(scope="module")
def markov_reference():
    """The reference's sharded NHEP solve, once a module (its jit cache
    cannot hold two CSR operators of one shape)."""
    m = Mesh(np.asarray(jax.devices()).reshape(-1), ("rows",))
    jmesh.set_mesh(m)
    try:
        A = jst.mat.generators.markov(15)
        jmesh.shard_operator(A, m)
        eps = jst.EPS(A, problem_type="nhep", which="largest_magnitude",
                      nev=3)
        eps.solve()
    finally:
        jmesh.set_mesh(None)
    return eps.nconv, np.asarray(eps.eigenvalues[:3])


@pytest.fixture(scope="module")
def svd_reference():
    m = Mesh(np.asarray(jax.devices()).reshape(-1), ("rows",))
    jmesh.set_mesh(m)
    try:
        rng = np.random.default_rng(1)
        As = sp.random(512, 256, density=0.02, random_state=rng,
                       format="csr")
        A = jst.from_scipy(As)
        jmesh.shard_operator(A, m)
        svd = jst.SVD(A, nsv=3, solver="trlanczos")
        svd.solve()
    finally:
        jmesh.set_mesh(None)
    return As, np.asarray(svd.sigma[:3])


def test_sharded_eps_general_path(ranked, one_rank, markov_reference):
    r = ranked["markov_nhep"]
    nconv_ref, lam_ref = markov_reference
    assert int(r["nconv"]) >= 3 and nconv_ref >= 3
    assert abs(np.max(np.abs(r["lam"])) - 1.0) < 1e-6
    key = lambda v: np.sort_complex(np.round(np.asarray(v), 8))
    np.testing.assert_allclose(key(r["lam"]), key(lam_ref), atol=1e-8)
    np.testing.assert_allclose(r["lam"], one_rank["markov_nhep"]["lam"],
                               atol=1e-10)
    assert str(r["form"]) == "rows" and r["n_allgather"] > 0


def test_sharded_svd(ranked, one_rank, svd_reference):
    r = ranked["svd_shard"]
    As, sigma_ref = svd_reference
    s_ref = np.linalg.svd(As.toarray(), compute_uv=False)
    np.testing.assert_allclose(r["sigma"], s_ref[:3], rtol=1e-6)
    np.testing.assert_allclose(r["sigma"], sigma_ref, rtol=1e-8)
    np.testing.assert_allclose(r["sigma"], one_rank["svd_shard"]["sigma"],
                               rtol=1e-10)
    assert str(r["form"]) == str(r["form_h"]) == "rows"


def test_sharded_dense_svd(ranked, one_rank):
    """tests/test_modules.py's 120 x 80 SVD with the dense matrix's rows
    (and its adjoint's) split over the ranks."""
    r = ranked["svd_dense"]
    Ad = np.random.default_rng(0).standard_normal((120, 80)) / np.sqrt(120)
    np.testing.assert_allclose(r["sigma"], np.linalg.svd(
        Ad, compute_uv=False)[:5], rtol=1e-8)
    svd = jst.SVD(jst.DenseOperator(Ad), nsv=5, solver="trlanczos")
    svd.solve()
    np.testing.assert_allclose(r["sigma"], svd.sigma[:5], rtol=1e-10)
    np.testing.assert_allclose(r["sigma"], one_rank["svd_dense"]["sigma"],
                               rtol=1e-12)
    assert int(r["nconv"]) == svd.nconv
    assert str(r["form"]) == str(r["form_h"]) == "rows"
    assert r["n_allgather"] > 0


@pytest.mark.parametrize("ndev", [8, 6])
def test_slice_submeshes_disjoint(ndev):
    """Slicing's card groups: disjoint, contiguous, in order (the
    reference's sub-meshes of its 8 devices, ks-slice.c:341-416)."""
    from slepc_tpu.parallel.tasks import slice_submeshes as jslice
    from slepc_tpu_torch.parallel.tasks import (slice_submeshes,
                                                thread_map_submesh)

    devs = [f"cuda:{i}" for i in range(ndev)]
    groups = slice_submeshes(4, devices=devs)
    if ndev == len(jax.devices()):  # the reference's groups of its devices
        assert [len(g) for g in groups] == [m.devices.size
                                            for m in jslice(4)]
    assert len(groups) <= 4
    seen = []
    for g in groups:
        ids = [d.index for d in g]
        assert ids == list(range(ids[0], ids[0] + len(ids)))
        assert not set(ids) & set(seen)
        seen += ids
    assert seen == sorted(seen)
    assert len(slice_submeshes(9, devices=devs)) <= ndev
    assert slice_submeshes(1, devices=devs) is None
    assert slice_submeshes(4, devices=devs[:1]) is None
    cpu = slice_submeshes(2, devices=["cpu"] * 4)
    assert thread_map_submesh(lambda v: v * 2, [1, 2, 3, 4, 5], cpu) == \
        [2, 4, 6, 8, 10]
    assert thread_map_submesh(lambda v: v + 1, [1, 2], None) == [2, 3]


# one rank of a torchrun launch: the environment names the rendezvous
_TORCHRUN_RANK = r"""
import json, torch
import slepc_tpu_torch as stt
from slepc_tpu_torch.sys.mesh import nrows_padded
torch.set_num_threads(1)
multi = stt.init_distributed()
mesh = stt.make_row_mesh(device="cpu")
r = mesh.rank + 1.0
t = mesh.allreduce(torch.tensor([r]))
M = torch.arange(6.0, dtype=torch.float64).reshape(2, 3).T * r
mesh.allreduce(M)  # a strided tensor is reduced in place too
print(json.dumps({"multi": multi, "world": mesh.world, "rank": mesh.rank,
                  "backend": mesh.backend, "sum": float(t[0]),
                  "strided": M.tolist(), "padded": nrows_padded(5, mesh)}))
torch.distributed.destroy_process_group()
"""


def test_init_distributed_from_torchrun_env(monkeypatch):
    """init_distributed reads torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and picks gloo without a card;
    without that environment it starts nothing."""
    import json
    import socket
    import subprocess

    import torch.distributed as dist

    from slepc_tpu_torch.sys.mesh import init_distributed

    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False and not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    procs = [subprocess.Popen([sys.executable, "-c", _TORCHRUN_RANK],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    assert [g["rank"] for g in got] == [0, 1]
    want = (np.arange(6.0).reshape(2, 3).T * 3.0).tolist()
    for g in got:
        assert g["multi"] is True and g["world"] == 2
        assert g["backend"] == "gloo" and g["sum"] == 3.0
        assert g["strided"] == want and g["padded"] == 6
