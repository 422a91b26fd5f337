"""The import guard: nothing the harness runs loads jax, jaxlib, flax or
the JAX package slepc_tpu (top-level names compared whole, so the port
slepc_tpu_torch passes), and the reference loads nothing of the port or
of the harness either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import CELLS, REPO
from portbench.harness import guard

HARNESS_RUN = """
import json, sys
sys.path.insert(0, {repo!r})
from pathlib import Path
from portbench.harness import runner
for cell in {cells!r}:
    r = runner.run(cell, 5, 0.1, True, root=Path({root!r}), device="cpu",
                   log=lambda m: None)
    assert r["correct"], r
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE_RUN = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
from portbench.reference import checks, control, lap3d
ref = lap3d.Lap3D([10, 11, 12], 5, "cpu")
lam, X = control.solve_outputs(ref, 6)
checks.solve_numbers(ref, lam, X, 6)
x = torch.randn(1320, dtype=torch.float64)
checks.probe_numbers(ref, {{"spmv": {{"x": x, "y": ref.apply(x)}},
                           "filter": {{"x": x, "y": x, "lo": 1.0, "hi": 12.0,
                                      "degree": 5}}}})
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_guard_compares_whole_top_level_names():
    mods = ["slepc_tpu_torch", "slepc_tpu_torch.eps", "jaxtyping", "numpy"]
    assert guard.banned_modules(mods) == []
    assert guard.banned_modules(mods + ["jax.numpy"]) == ["jax"]
    assert guard.banned_modules(["slepc_tpu.eps", "flax"]) == ["flax",
                                                               "slepc_tpu"]


def test_harness_loads_no_jax(tiny_root):
    mods = _modules(HARNESS_RUN.format(repo=str(REPO), cells=list(CELLS),
                                       root=str(tiny_root)))
    assert guard.banned_modules(mods) == []
    assert "slepc_tpu_torch" in mods  # the program under test ran


def test_reference_loads_neither_jax_nor_the_port():
    mods = _modules(REFERENCE_RUN.format(repo=str(REPO)))
    assert guard.banned_modules(
        mods, guard.BANNED + ("slepc_tpu_torch",)) == []
    assert not [m for m in mods if m.startswith("portbench.harness")]


def test_reference_sources_import_only_plain_libraries():
    allowed = {"__future__", "numpy", "torch", "portbench"}
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or "."] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)
                assert not name.startswith("portbench.harness"), path.name
