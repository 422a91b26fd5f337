"""The benchmark's own tests: CPU tests at a tiny grid through the port's
plain versions, and card tests (marker ``gpu``) that skip without a card.

    python -m pytest portbench/tests -q          # on the CPU
    python -m pytest portbench/tests -q -m gpu   # on a machine with a card
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELLS = ("lap3d-dia.cheb20", "lap3d-csr.cheb20", "lap3d-dia.cheb20-block4")
TINY_GRID = [10, 11, 12]
TINY_DEGREE = 40  # degree 450 outgrows the filter's range on a tiny grid


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips on a machine without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_copy(dest: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ under ``dest`` in which every
    configuration's grid is TINY_GRID and every traffic's degree
    TINY_DEGREE; returns the copy's portbench/ (the harness's root)."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    root = dest / "portbench"
    shutil.copytree(REPO / "portbench", root,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                  "tests"))
    for path in (root / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["grid"] = TINY_GRID
        path.write_text(json.dumps(cfg))
    for path in (root / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic["cheb_degree"] = TINY_DEGREE
        path.write_text(json.dumps(traffic))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_copy(tmp_path)
