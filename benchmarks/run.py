"""Run one cell of the benchmark of `stabnet_tpu_torch` once, in this process.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is `benchmarks/workloads/<cell>.json`;
it names its configuration (`benchmarks/configs/<name>.json`) and its driver
(`benchmarks/drivers/<driver>.py`).  The run sets up (weights and inputs from
`--seed`, warm-up of every shape the cell uses), measures for `--seconds`,
checks the outputs against the plain reference (`benchmarks/reference/`), and
prints one JSON line as the last line of standard output.  With `--trace 1` the
window runs under `torch.profiler`, and the line carries the cell's per-layer
metrics (`benchmarks/metrics/<name>.py`) instead of its end-to-end ones; an
end-to-end metric taken from the device's timeline has the profiler record the
device alone in a `--trace 0` run.

`--device cpu --size tiny` runs a cell at a tiny size on the CPU, for the
harness's own tests; no device metric is reported from such a run.
"""

import os
import sys
import time

T_START = time.time()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# Fixed cache directories inside the checkout, set before torch is imported
# (the port's own nvcc build goes to stabnet_tpu_torch/_build/).
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")

# Import the harness as the package `benchmarks`, never its folders as
# top-level modules.
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmarks.harness.main import main

    sys.exit(main(sys.argv[1:], T_START))
