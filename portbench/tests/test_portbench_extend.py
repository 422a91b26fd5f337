"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and BENCHMARK.json entries only; the harness
runs them with no edit to any file it already has."""

from __future__ import annotations

import hashlib
import json

from portbench.harness import runner


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and "_cache" not in p.parts}


def test_new_config_cell_and_metric_are_files_only(tiny_root):
    before = _digests(tiny_root)
    cfg = json.loads((tiny_root / "configs"
                      / "lap3d-200x225x230-dia.json").read_text())
    cfg.update(name="lap3d-9x10x11-dia", grid=[9, 10, 11])
    (tiny_root / "configs" / "lap3d-9x10x11-dia.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((tiny_root / "traffic" / "cheb20.json").read_text())
    traffic.update(name="cheb8", nev=8, ncv=24,
                   attrs={"cheb_rot_mode": "exact"}, options="-eps_ncv 24")
    (tiny_root / "traffic" / "cheb8.json").write_text(json.dumps(traffic))
    cell = json.loads((tiny_root / "cells"
                       / "lap3d-dia.cheb20.json").read_text())
    cell.update(name="lap3d-small.cheb8", config="lap3d-9x10x11-dia",
                traffic="cheb8")
    (tiny_root / "cells" / "lap3d-small.cheb8.json").write_text(
        json.dumps(cell))
    (tiny_root / "metrics" / "solves_in_window.py").write_text(
        "def read(records):\n    return len(records['solves']) or None\n")
    bench_path = tiny_root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "lap3d-9x10x11-dia",
                             "source": "https://example.org/a-source",
                             "file": "portbench/configs/lap3d-9x10x11-dia.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "lap3d-small.cheb8",
                               "config": "lap3d-9x10x11-dia",
                               "traffic": "cheb8", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "solves_in_window", "unit": "solves",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "Chebyshev driver (eps/cheb_accel.py)",
                               "moves": "solve_s",
                               "workloads": ["lap3d-small.cheb8"]})
    bench_path.write_text(json.dumps(bench))

    r = runner.run("lap3d-small.cheb8", 3, 0.2, True, root=tiny_root,
                   device="cpu", log=lambda msg: None)
    assert r["correct"] is True
    assert r["metrics"]["solves_in_window"]["value"] == r["attempted"]
    assert r["metrics"]["solves_in_window"]["unit"] == "solves"
    assert set(r["metrics"]) == {"solves_in_window"}  # others list cells
    after = _digests(tiny_root)
    assert all(after[p] == d for p, d in before.items())
    # the cells that were there before report no new metric
    old = runner.run("lap3d-dia.cheb20", 3, 0.2, True, root=tiny_root,
                     device="cpu", log=lambda msg: None)
    assert "solves_in_window" not in old["metrics"]
