"""The control, the plain reference in float32 in the program's place,
comes out not correct at a small grid, on several seeds, under each cell's
own limits; the program on the same cells comes out correct
(test_portbench_cells.py)."""

from __future__ import annotations

import pytest
import torch

from conftest import CELLS
from portbench import control


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 7])
def test_control_fails(tiny_root, cell, seed):
    r = control.readings(cell, seed, torch.device("cpu"), 2.0, 12.0,
                         root=tiny_root)
    assert r["correct"] is False
    c = r["checks"]
    # float32 eigenvectors miss the residual limit by orders of magnitude;
    # float32 products miss the probes' limits
    assert c["resid"]["value"] > 10 * c["resid"]["limit"]
    assert c["spmv_err"]["value"] > c["spmv_err"]["limit"]
    assert c["filter_err"]["value"] > c["filter_err"]["limit"]
    assert c["missing"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_reference_in_float64_passes(tiny_root, cell):
    """The same readings with the reference in float64 pass: the control
    fails by its precision, not by the comparison."""
    from portbench.harness import runner, spec
    from portbench.reference import checks
    from portbench.reference import control as ref_control

    cellspec, cfg, req, _ = spec.load_cell(spec.benchmark(tiny_root), cell,
                                           tiny_root)
    shared = spec.maker(cfg["maker"], tiny_root).shared_inputs(
        cfg, tiny_root / "_cache")
    ref = spec.reference(cfg["reference"], tiny_root).make(cfg, 3, "cpu",
                                                          shared)
    lam, X = ref_control.solve_outputs(ref, 20, torch.float64)
    nums = checks.solve_numbers(ref, lam, X, 20)
    limits = runner.limits_of(cellspec, req)
    assert all(nums[k] <= limits[k] for k in nums), nums
