"""Where the harness finds what belongs to one cell, one configuration or one
per-layer metric: each in a file of its own, found by the name that
``BENCHMARK.json`` and the cell files give.

- ``cells/<cell>.json``: its configuration's and its traffic's names, its
  limits and why it exists;
- ``traffic/<traffic>.json``: the request every solve of the window makes;
- ``configs/<config>.json``: sizes, format, maker, reference;
- ``makers/<maker>.py``: ``shared_inputs(cfg, cache_dir)`` and
  ``build(cfg, seed, device, shared)`` -> (operator, layout);
- ``reference/<reference>.py``: ``make(cfg, seed, device, shared)``;
- ``metrics/<metric>.py``: ``read(records)`` -> a number or None.

A cell, configuration, maker or metric is added by adding its file and its
``BENCHMARK.json`` entry; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # portbench/


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(root: Path, folder: str, name: str, suffix: str) -> Path:
    path = Path(root) / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} "
                                f"({path} is missing)")
    return path


def cell(name: str, root: Path = ROOT) -> dict:
    return load_json(_named(root, "cells", name, ".json"))


def traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(_named(root, "traffic", name, ".json"))


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(_named(root, "configs", name, ".json"))


def _module(root: Path, folder: str, name: str):
    """The module in ``<root>/<folder>/<name>.py``, loaded by its path (a
    name may hold dots or dashes)."""
    path = _named(root, folder, name, ".py")
    key = f"portbench_{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def maker(name: str, root: Path = ROOT):
    return _module(root, "makers", name)


def reference(name: str, root: Path = ROOT):
    return _module(root, "reference", name)


def metric_reader(name: str, root: Path = ROOT):
    return _module(root, "metrics", name).read


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` beside the harness's folder."""
    return load_json(Path(root).parent / "BENCHMARK.json")


def _for_cell(entries, cell_name: str):
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]


def end_to_end(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics the cell reports."""
    return _for_cell(bench.get("end_to_end", []), cell_name)


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics the cell reports in its traced run."""
    return _for_cell(bench.get("per_layer", []), cell_name)


def workload(bench: dict, cell_name: str) -> dict:
    """The cell's entry in BENCHMARK.json, which has to name the same
    configuration and traffic as the cell's file."""
    for w in bench.get("workloads", []):
        if w["name"] == cell_name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload named {cell_name!r}")


def load_cell(bench: dict, cell_name: str, root: Path = ROOT):
    """(cell, configuration, request, chips) of ``cell_name``."""
    entry = workload(bench, cell_name)
    spec = cell(cell_name, root)
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"cell {cell_name!r}: its file names {key} "
                             f"{spec[key]!r}, BENCHMARK.json {entry[key]!r}")
    return (spec, config(spec["config"], root), traffic(spec["traffic"], root),
            int(entry["chips"]))
