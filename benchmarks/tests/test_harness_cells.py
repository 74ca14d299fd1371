"""The benchmark's files against each other and against the contract, and
each cell end to end at its tiny size on the CPU.

    python -m pytest benchmarks/tests -q

Tests marked `cuda` run a cell on the card; they skip where there is none.
"""

import json
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DEVICE_METRICS = ("idle", "roofline", "mfu")


def load(kind, name):
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    named = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind


@pytest.mark.parametrize("cell", CELLS)
def test_workload_files(cell):
    wl = load("workloads", cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"]
    assert os.path.isfile(os.path.join(HERE, "configs", f"{wl['config']}.json"))
    assert os.path.isfile(os.path.join(HERE, "drivers", f"{wl['driver']}.py"))
    assert wl["limits"], "a cell compares at least one number"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert os.path.isfile(os.path.join(HERE, "metrics", f"{metric['name']}.py"))
    moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert cell in moves.get("workloads", CELLS), (metric["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)]
    per = [m["name"] for m in BENCH["per_layer"] if cell in m.get("workloads", CELLS)]
    assert "setup_s" in e2e and len(e2e) >= 2 and per


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for layer in layers:
        assert layer == layer.strip() and "\n" not in layer


def run_cell(cell, trace, device="cpu", size="tiny", seconds="1"):
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload", cell, "--seed",
         "3000000019", "--seconds", seconds, "--trace", str(trace), "--device", device,
         "--size", size], cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_tiny_on_cpu(cell, trace):
    line, err = run_cell(cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, err[-2000:]
    assert line["device"]["platform"] == "cpu"
    traced = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
              if m["source"] == "device_trace"}
    for name in line["metrics"]:
        assert not any(k in name for k in DEVICE_METRICS) and name not in traced, name
    assert "busy_s" not in line["device"]
    # The CPU has no device timeline: its run reports the rest.
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", CELLS) and m["name"] not in traced}
    if trace == 0:
        assert set(line["metrics"]) == e2e
    for name in line["checks"]:
        assert f"check {name} = " in err


def test_no_card_no_result():
    """On a machine without CUDA a full-size run prints no result and fails."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    line, err = run_cell(cell, 1, device="cuda", size="full", seconds="3")
    assert line["correct"] is True, err[-2000:]
    assert line["device"]["busy_s"] > 0


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu",
                          "--size", "tiny"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and not out.stdout.strip()
