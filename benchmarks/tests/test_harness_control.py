"""The control: the plain reference computed in float8 (e4m3, one scale per
tensor, on the trunk's and the MLP's inputs and weights), put in the
program's place, comes out not correct under each cell's limits, on three
seeds, at the cell's own size; the program itself, on the same set-up,
comes out correct.  It needs the card (the cells' sizes), so it carries the
`cuda` marker and skips without one.

    python -m pytest benchmarks/tests/test_harness_control.py -q -m cuda
"""

import importlib
import json
import os

import pytest
import torch

from benchmarks.harness import checks
from benchmarks.harness.main import Context, cell_files, sized
from benchmarks.reference.model import fp8

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    wl, cfg = cell_files(name)
    wl, cfg = sized(wl, "full"), sized(cfg, "full")
    ctx = Context(name, wl, cfg, 3000000101, torch.device("cuda", 0), False, "full")
    cell = importlib.import_module(f"benchmarks.drivers.{wl['driver']}").Cell(ctx)
    for seed in (3000000102, 3000000103, 3000000104):
        got = checks.compare(cell.reading(seed, control=fp8), wl["limits"])
        assert not checks.passed(got), (seed, got)
    assert checks.passed(checks.compare(cell.reading(3000000105), wl["limits"]))
