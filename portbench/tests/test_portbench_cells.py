"""A whole run of each cell's code path on the CPU at a tiny grid, through
the port's plain versions, traced and untraced; and the command's refusal
without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import CELLS, REPO
from portbench.harness import runner

SEED = 2 ** 31 + 12_345  # wider than 32 signed bits, as a run's seed may be


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_cpu(tiny_root, cell, traced):
    r = runner.run(cell, SEED, 0.5, traced, root=tiny_root, device="cpu",
                   log=lambda msg: None)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert {"missing", "eig_err", "resid", "orth"} <= set(r["checks"])
    assert r["device"]["platform"] == "cpu"
    if traced:
        # a CPU run has no device trace and no card peaks: only the count
        assert set(r["metrics"]) == {"cheb_cols"}
        assert {"spmv_err", "filter_err"} <= set(r["checks"])
    else:
        assert set(r["metrics"]) == {"solve_s", "setup_s"}
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("config", ["lap3d-200x225x230-dia",
                                    "lap3d-200x225x230-csr-rcm"])
def test_makers_match_reference(tiny_root, config):
    """Each maker's operator is the reference's c A for its seed: the same
    product, stored values that differ between seeds by the ratio of their
    scales exactly, and (CSR) the stencil's 7n - 2(ny nz + nx nz + nx ny)
    nonzeros in RCM order."""
    import torch

    from portbench.harness import spec

    cfg = spec.config(config, tiny_root)
    mk = spec.maker(cfg["maker"], tiny_root)
    shared = mk.shared_inputs(cfg, tiny_root / "_cache")
    ref_mod = spec.reference(cfg["reference"], tiny_root)
    x = torch.randn(3, 1320, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    stored = []
    for seed in (1, SEED):
        op, layout = mk.build(cfg, seed, "cpu", shared)
        ref = ref_mod.make(cfg, seed, "cpu", shared)
        for row in x:
            want = ref.apply(row)
            assert float((op.mult(row) - want).abs().max()) <= \
                1e-14 * float(want.abs().max())
        stored.append(op.diags if layout["format"] == "dia" else op.vals)
    ratio = ref_mod.scale(SEED) / ref_mod.scale(1)
    assert ratio != 1.0
    assert torch.equal(stored[0] * ratio, stored[1])
    if layout["format"] == "csr":
        assert layout["nnz"] == 7 * 1320 - 2 * (132 + 120 + 110) == 8516
        perm = shared["perm"]
        assert sorted(perm.tolist()) == list(range(1320))
        assert list(perm) != list(range(1320))


def test_command_refuses_without_card(tiny_root):
    # run from a copy: the command keeps its bytecode cache in its checkout
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, str(tiny_root / "run.py"), "--workload",
         CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tiny_root.parent, env=env,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in proc.stderr


def test_command_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and portbench/ gives no
    result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-I", "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, cell):
    """On a card: one short traced run of each cell at its own size gives
    every per-layer metric and comes out correct."""
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "1", "--trace", "1"],
        capture_output=True, text=True, cwd=REPO, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"cheb_cols", "filter_roofline",
                                 "spmv_roofline", "idle_pct"}
    assert r["device"]["busy_s"] > 0
