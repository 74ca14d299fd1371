"""The run of one cell: load its files by name, set up, measure, check, report.

A cell is `workloads/<cell>.json`.  It names a configuration
(`configs/<config>.json`) and a driver (`drivers/<driver>.py`), and holds the
parameters of its traffic and the limits of its correctness check.  Which
metrics a cell reports comes from `BENCHMARK.json` at the root of the
checkout: an end-to-end metric where its `workloads` lists the cell (or it has
no such list), a per-layer metric likewise, read by `metrics/<name>.py`.  An
end-to-end metric whose source is `device_trace` is read by its own
`metrics/<name>.py` too, from the window's device timeline, which an untraced
run then records (the device's operations only).
Adding a cell or a metric adds files and entries; no file of the harness
changes.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from typing import Dict, List

from benchmarks.harness import checks, isolation, record, trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def sized(entry: dict, size: str) -> dict:
    """A configuration or workload file's entries, with the block named
    `size` (e.g. "tiny") laid over them; the full size is the file itself."""
    out = {k: v for k, v in entry.items() if k != "sizes"}
    if size != "full":
        out.update(entry.get("sizes", {})[size])
    return out


class Context:
    """What a driver is given: its cell's and configuration's entries, the
    seed, the device, and the recorder of spans and counters."""

    def __init__(self, cell: str, wl: dict, cfg: dict, seed: int, device,
                 tracing: bool, size: str, seconds: float = 10.0):
        self.cell, self.wl, self.cfg, self.seed = cell, wl, cfg, seed
        self.seconds = seconds
        self.device, self.tracing, self.size = device, tracing, size
        self.on_card = device.type == "cuda"
        self.rec = record.Recorder(tracing)

    def span(self, name: str):
        return self.rec.span(name)

    def sync(self) -> None:
        if self.on_card:
            import torch

            torch.cuda.synchronize(self.device)


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmarks/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--size", default="full")
    return p.parse_args(argv)


def cell_files(cell: str) -> tuple:
    wl_path = os.path.join(HERE, "workloads", f"{cell}.json")
    if not os.path.isfile(wl_path):
        raise SystemExit(f"benchmark: no workload file {wl_path}")
    wl = load_json(wl_path)
    cfg = load_json(os.path.join(HERE, "configs", f"{wl['config']}.json"))
    return wl, cfg


def metric_names(bench: dict, section: str, cell: str) -> List[dict]:
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl_full, cfg_full = cell_files(args.workload)
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), 1)

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: the cell needs {chips} CUDA device(s); "
                  f"cuda available={torch.cuda.is_available()}, "
                  f"count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr, flush=True)
            return 2
        device = torch.device("cuda", 0)
    else:
        if args.size == "full":
            print("benchmark: the CPU runs only the tiny sizes (--size tiny); "
                  "a full cell measures the card", file=sys.stderr, flush=True)
            return 2
        device = torch.device("cpu")

    wl, cfg = sized(wl_full, args.size), sized(cfg_full, args.size)
    ctx = Context(args.workload, wl, cfg, args.seed, device, bool(args.trace), args.size,
                  args.seconds)
    driver = importlib.import_module(f"benchmarks.drivers.{wl['driver']}")

    cell = driver.Cell(ctx)
    ctx.sync()
    setup_s = time.time() - t_start
    print(f"benchmark: set-up {setup_s:.3f} s", file=sys.stderr, flush=True)
    if ctx.on_card:
        from benchmarks.harness.peaks import power_limit_w

        print(f"benchmark: {torch.cuda.get_device_name(device)}, power limit "
              f"{power_limit_w()} W", file=sys.stderr, flush=True)

    # A traced run may measure a shorter window (the cell's `trace_seconds`),
    # where reading the trace of the whole one would outlast the run's time.
    seconds = args.seconds
    if args.trace:
        seconds = min(seconds, float(wl.get("trace_seconds", seconds)))
    if ctx.on_card:
        torch.cuda.reset_peak_memory_stats(device)
    # An end-to-end metric read from the device's timeline has the window
    # traced in an untraced run too, the device's operations alone.
    e2e_traced = [m for m in metric_names(bench, "end_to_end", args.workload)
                  if m["source"] == "device_trace"]
    prof = (trace.start(ctx) if args.trace
            else trace.start(ctx, host=False) if e2e_traced else None)
    ctx.rec.open_window()
    cell.window(seconds)
    ctx.sync()
    ctx.rec.close_window()
    reduced = trace.stop(prof, ctx) if prof is not None else None
    print(f"benchmark: window {ctx.rec.window[1] - ctx.rec.window[0]:.3f} s; "
          f"{ctx.rec.summary()}", file=sys.stderr, flush=True)

    device_info = {"platform": "gpu" if ctx.on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if ctx.on_card else "cpu",
                   "count": chips if ctx.on_card else 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
                   if ctx.on_card else 0}
    e2e = cell.end_to_end()
    counters = dict(cell.counters)
    print("benchmark: counters " + json.dumps(
        {k: v for k, v in counters.items() if isinstance(v, (int, float))}),
        file=sys.stderr, flush=True)
    print(f"benchmark: host clock {json.dumps(e2e)}", file=sys.stderr, flush=True)
    rec = ctx.rec.view(counters, reduced, device_info, ctx)
    attempted, failed = cell.attempted, cell.failed

    compared = cell.check()
    correct = checks.passed(compared)

    found = isolation.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}: the port or the harness imports "
              f"the JAX package or JAX; no result", file=sys.stderr, flush=True)
        return 3

    metrics: Dict[str, dict] = {}
    if not args.trace:
        values = dict(e2e, setup_s=setup_s)
        for m in e2e_traced:
            values[m["name"]] = load_metric(m["name"]).read(rec)
        for m in metric_names(bench, "end_to_end", args.workload):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in metric_names(bench, "per_layer", args.workload):
            value = load_metric(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if reduced is not None:
            device_info["busy_s"] = reduced["busy_s"]
            device_info["window_s"] = reduced["window_s"]

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if args.trace and reduced is not None:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = checks.as_json(compared)
    for line in checks.lines(compared):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def load_metric(name: str):
    """`metrics/<name>.py` as a module (a name may hold dots)."""
    import importlib.util

    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmarks.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

