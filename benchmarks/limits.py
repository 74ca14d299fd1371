"""Readings that the limits of `correct` are set from.

    python3 benchmarks/limits.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

Sets the cell up once, then for each seed of `--seeds` loads that seed's
weights and inputs into the same program, runs the cell's entry at its own
size once and prints the compared numbers (the lower readings); for each of
`--control-seeds` it puts the reference computed in float8 (e4m3, one scale
per tensor, on the trunk's and the MLP's inputs and weights: the precision
below the configuration's bf16) in the program's place and prints its
numbers (the upper readings).  One JSON line per reading, then the largest
program reading and the smallest control reading of each number.  The
benchmark's own runs do not run this.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)


def main(argv):
    import argparse
    import importlib

    import torch

    from benchmarks.harness.main import Context, cell_files, sized
    from benchmarks.reference.model import fp8

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", default="full")
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    wl, cfg = cell_files(a.workload)
    wl, cfg = sized(wl, a.size), sized(cfg, a.size)
    device = torch.device("cuda", 0) if a.device == "cuda" else torch.device("cpu")
    ctx = Context(a.workload, wl, cfg, (seeds or controls)[0], device, False, a.size)
    cell = importlib.import_module(f"benchmarks.drivers.{wl['driver']}").Cell(ctx)
    lower, upper = {}, {}
    for kind, group in (("program", seeds), ("control", controls)):
        for seed in group:
            t0 = time.time()
            r = cell.reading(seed, control=fp8 if kind == "control" else None)
            into = lower if kind == "program" else upper
            for k, v in r.items():
                into[k] = max(into.get(k, v), v) if kind == "program" else min(into.get(k, v), v)
            print(json.dumps({"kind": kind, "seed": seed, "seconds": time.time() - t0, **r}),
                  flush=True)
    print(json.dumps({"lower": lower, "upper": upper, "limits": wl.get("limits")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
