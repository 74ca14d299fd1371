"""Rig diagnostics: bounded liveness and kernel probes of the card (the
PyTorch port of stabnet_tpu/cli/doctor.py).

Serving needs a way to tell "the card is wedged" from "the job is slow"
without hanging the caller.  Every probe that touches a device runs in a
SUBPROCESS with a hard deadline, so `doctor` always returns, and returns
structured JSON:

    {"ok": true/false, "checks": {name: {"ok": ..., "seconds": ...}, ...}}

Checks:
  host     - CPU count, host RAM (no subprocess).
  backend  - import torch, find the card (name, compute capability, memory
             in total and in use), run one computation on it and read it
             back: the readback is the liveness test.  Asked for CUDA
             without one, it fails ("CUDA is not available"); it never
             reports the CPU in the card's place.  `--device cpu` checks
             the CPU's liveness.
  kernels  - build the CUDA kernels (ops/cuda_build.py, seconds recorded),
             call each `torch.ops.stabnet` op once at a small shape on the
             card (K1, K2 in both edge modes, K2m, K3, K4, K6b, K7, and K7n:
             K7's three iterations on chip in one launch) and hold it
             against the same op on CPU tensors, its plain version, bit for
             bit; each kernel's launches and max error.  With `--device
             cpu` the plain versions run and the check says so.
  mesh     - the host side of data parallelism: eight CPU devices, a batch
             sharded over them, one all-reduce in a one-rank gloo group.

Exit status: 0 when every check passes, 1 otherwise.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

# Each probe is a small script run as `python -c CODE DEVICE`: a wedged card
# blocks the CHILD, the parent's deadline still fires, and killing the child
# never takes the caller down with it.
_BACKEND_PROBE = """
import json, sys, time
t0 = time.time()
import torch
from stabnet_tpu_torch.cli.doctor import backend_probe
print(json.dumps(backend_probe(sys.argv[1], t0)))
"""

_KERNELS_PROBE = """
import json, sys
from stabnet_tpu_torch.cli.doctor import kernel_probe
print(json.dumps(kernel_probe(sys.argv[1])))
"""

_MESH_PROBE = """
import json
from stabnet_tpu_torch.cli.doctor import mesh_probe
print(json.dumps(mesh_probe()))
"""


def backend_probe(device: str, t0: float) -> dict:
    """Find the device, compute on it and read the result back; times from
    `t0`, the probe process's start."""
    import torch

    from stabnet_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    report = {"device": str(dev), "torch": torch.__version__}
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        report.update(name=torch.cuda.get_device_name(index),
                      capability=list(torch.cuda.get_device_capability(index)),
                      device_count=torch.cuda.device_count(), cuda=torch.version.cuda)
    else:
        report.update(name="cpu", device_count=1)
    report["enumerate_seconds"] = round(time.time() - t0, 3)
    x = torch.arange(128.0, device=dev).sum().item()   # first computation + readback
    if x != 8128.0:
        raise RuntimeError(f"arange(128).sum() read back {x}, not 8128")
    report["first_compute_seconds"] = round(time.time() - t0, 3)
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        report["memory_gb"] = round(total / 2**30, 1)
        report["memory_in_use_gb"] = round((total - free) / 2**30, 2)
    return report


def _kernel_cases(device):
    """(kernel, its launch counter, [(op, args)]) at a small ragged size,
    seeded with numpy, on `device`; the mesh op reads its frame in place
    from a 13-channel stack, as the serving warp does."""
    import numpy as np
    import torch

    from stabnet_tpu_torch.ops import cuda_warp, flow
    from stabnet_tpu_torch.ops.warp import mesh_tables

    rng = np.random.RandomState(0)
    B, H, W = 2, 24, 40

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    im = t(rng.rand(B, H, W, 3).astype(np.float32))
    x = t(rng.uniform(-1.2, 1.2, (B, H, W)).astype(np.float32))
    y = t(rng.uniform(-1.2, 1.2, (B, H, W)).astype(np.float32))
    imc = t(rng.randint(0, 256, (B, 3, H, W), dtype=np.uint8))
    g = t(rng.rand(B, H, W, 3).astype(np.float32))
    stack = t(rng.rand(B, 13, H, W).astype(np.float32)).permute(0, 2, 3, 1)
    Hs = t(np.eye(3, dtype=np.float32)
           + rng.uniform(-0.05, 0.05, (B, 4, 4, 3, 3)).astype(np.float32))
    tables = tuple(mesh_tables(H, W, 4, 4, torch.device(device)))
    u = t(rng.randn(B, 2, H, W).astype(np.float32))
    p = t(rng.randn(B, 2, 2, H, W).astype(np.float32))
    rho_c, gx, gy = (t(s * rng.randn(B, H, W).astype(np.float32)) for s in (20, 10, 10))
    ops = torch.ops.stabnet
    return [
        ("K1", cuda_warp.warp_uint8_cf_lowres,
         [(ops.warp_uint8_cf_lowres, (imc, x[:, ::4, ::4].contiguous(),
                                      y[:, ::4, ::4].contiguous(), [H, W]))]),
        ("K2", cuda_warp.bilinear_sample,
         [(ops.bilinear_sample, (im, x, y, True)), (ops.bilinear_sample, (im, x, y, False))]),
        ("K2m", cuda_warp.warp_mesh, [(ops.warp_mesh, (stack[..., 12:13], Hs, *tables))]),
        ("K3", cuda_warp.warp_uint8_cf, [(ops.warp_uint8_cf, (imc, x, y))]),
        ("K4", cuda_warp.bilinear_splat, [(ops.bilinear_splat, (g, x, y, [H, W]))]),
        ("K6b", cuda_warp.sample_map_grad, [(ops.sample_map_grad, (im, x, y, g))]),
        ("K7", flow.tvl1_iterate,
         [(ops.tvl1_iterate, (u, p, rho_c, gx, gy, 0.25, 0.15, 0.3))]),
        ("K7n", flow.tvl1_iterate_n,
         [(ops.tvl1_iterate_n, (u, p, rho_c, gx, gy, 3, 0.25, 0.15, 0.3))]),
    ]


def _outputs(out):
    import torch

    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def kernel_probe(device: str) -> dict:
    """Build the kernels and hold each op on `device` against its plain
    version on the CPU; `failed` names the kernels that did not launch once
    per call or did not agree bit for bit."""
    import torch

    from stabnet_tpu_torch.ops import cuda_build
    from stabnet_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    report = {"device": dev.type}
    if dev.type == "cuda":
        t0 = time.time()
        cuda_build.build(["warp", "warp_grad", "tvl1"])
        report["build_seconds"] = round(time.time() - t0, 3)
    kernels = {}
    with torch.inference_mode():
        plain = {name: calls for name, _, calls in _kernel_cases("cpu")}
        for name, counter, calls in _kernel_cases(dev):
            before = counter.launches
            t0 = time.time()
            got = [_outputs(op(*args)) for op, args in calls]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds = time.time() - t0
            launches = counter.launches - before
            want = [_outputs(op(*args)) for op, args in plain[name]]
            pairs = [(a.cpu(), b) for ga, wa in zip(got, want) for a, b in zip(ga, wa)]
            equal = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
            err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
            expected = len(calls) if dev.type == "cuda" else 0
            kernels[name] = {"ok": equal and launches == expected, "calls": len(calls),
                             "launches": launches, "max_abs_err": err,
                             "seconds": round(seconds, 4)}
    report["kernels"] = kernels
    report["failed"] = sorted(n for n, k in kernels.items() if not k["ok"])
    return report


def mesh_probe() -> dict:
    """Shard an (8, 4) batch over eight CPU devices and sum it with one
    all-reduce in a one-rank gloo group whose TCP store the OS gives a
    free local port."""
    import torch
    import torch.distributed as dist

    from stabnet_tpu_torch.parallel import data_devices, shard_batch

    t0 = time.time()
    devices = data_devices(["cpu"] * 8)
    shards = shard_batch(torch.arange(float(8 * 4)).reshape(8, 4), devices)
    if [tuple(s.shape) for s in shards] != [(1, 4)] * 8:
        raise RuntimeError(f"shards {[tuple(s.shape) for s in shards]}")
    # The store binds a port the OS picks: no other process can take it
    # between a pick and the bind.
    store = dist.TCPStore("localhost", 0, world_size=1, is_master=True)
    dist.init_process_group("gloo", store=store, world_size=1, rank=0)
    try:
        total = torch.stack([s.sum() for s in shards]).sum()
        dist.all_reduce(total)
    finally:
        dist.destroy_process_group()
    if float(total) != sum(range(32)):
        raise RuntimeError(f"the all-reduced sum is {float(total)}, not 496")
    return {"mesh_devices": len(devices), "all_reduce_sum": float(total),
            "seconds": round(time.time() - t0, 3)}


def _run_probe(code: str, timeout_s: float, args=()) -> dict:
    """Run probe code in a subprocess; never block past the deadline.

    A child wedged in uninterruptible sleep inside a CUDA call can ignore
    SIGKILL, so after killing the child's process group the parent waits
    only a few seconds, then ORPHANS the child and reports the wedge anyway
    (subprocess.run's timeout path waits without a bound).
    """
    if timeout_s < 1.0:
        return {"ok": False, "seconds": 0.0,
                "error": "total doctor budget exhausted before this probe "
                         "ran (an earlier probe consumed the deadline)"}
    env = dict(os.environ)
    # Probes must see the repository's package even when doctor runs from
    # elsewhere.
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True,    # own process group: killpg cannot hit us
    )
    try:
        stdout, stderr = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            pass  # SIGKILL-immune (kernel D-state): orphan it, report anyway
        return {
            "ok": False,
            "seconds": round(time.time() - t0, 1),
            "error": f"probe did not respond within {timeout_s:.0f}s: "
                     "device wedged or severely overloaded",
        }
    out = stdout.strip().splitlines()
    if proc.returncode != 0 or not out:
        return {"ok": False, "seconds": round(time.time() - t0, 1),
                "error": (stderr or "no output").strip()[-500:]}
    try:
        detail = json.loads(out[-1])
    except ValueError:
        return {"ok": False, "seconds": round(time.time() - t0, 1),
                "error": f"unparseable probe output: {out[-1][:200]}"}
    detail["ok"] = not detail.get("failed")
    detail["seconds"] = round(time.time() - t0, 1)
    return detail


def _host_check() -> dict:
    info = {"ok": True, "cpus": os.cpu_count()}
    try:
        with open("/proc/meminfo") as f:
            mem = {ln.split(":")[0]: ln.split()[1] for ln in f if ":" in ln}
        info["ram_gb"] = round(int(mem["MemTotal"]) / 1e6, 1)
        info["ram_available_gb"] = round(int(mem["MemAvailable"]) / 1e6, 1)
    except (OSError, KeyError, ValueError):
        pass  # non-Linux host: the CPU count alone
    return info


_ALL_CHECKS = ("host", "backend", "kernels", "mesh")


def run_doctor(timeout_s: float = 120.0, checks=None, device: str = "cuda") -> dict:
    """Run the probes; return the report dict (see the module docstring).

    `timeout_s` is the TOTAL budget: each probe gets what is left of it, so
    even with every probe wedged the call returns within about timeout_s
    (plus a few seconds of kill grace), not checks * timeout_s.
    `checks=None` means all; an explicit empty list and unknown names are
    errors (a vacuous {"checks": {}, "ok": true} must be impossible).
    `device` is the one the backend and kernels checks probe (the card
    unless "cpu").
    """
    if checks is None:
        checks = _ALL_CHECKS
    unknown = set(checks) - set(_ALL_CHECKS)
    if unknown:
        raise ValueError(f"unknown doctor checks: {sorted(unknown)}; "
                         f"valid: {list(_ALL_CHECKS)}")
    if not checks:
        raise ValueError("empty check list: pass None for all checks")
    hang = os.environ.get("STABNET_DOCTOR_FAKE_HANG")  # test hook
    wanted = set(checks)
    deadline = time.time() + timeout_s
    remaining = lambda: deadline - time.time()  # noqa: E731
    report: dict = {"checks": {}}
    if "host" in wanted:
        report["checks"]["host"] = _host_check()
    if "backend" in wanted:
        code = "import time; time.sleep(3600)" if hang == "backend" else _BACKEND_PROBE
        report["checks"]["backend"] = _run_probe(code, remaining(), (device,))
    if "kernels" in wanted:
        report["checks"]["kernels"] = _run_probe(_KERNELS_PROBE, remaining(), (device,))
    if "mesh" in wanted:
        report["checks"]["mesh"] = _run_probe(_MESH_PROBE, remaining())
    report["ok"] = all(c.get("ok") for c in report["checks"].values())
    return report


def cmd_doctor(args) -> None:
    report = run_doctor(timeout_s=args.timeout,
                        checks=args.only if args.only else None, device=args.device)
    print(json.dumps(report, indent=None if args.compact else 2))
    if not report["ok"]:
        sys.exit(1)


def add_parser(sub) -> None:
    p = sub.add_parser(
        "doctor",
        help="bounded rig diagnostics: card liveness, the kernels against "
             "their plain versions, the data-parallel host path (never hangs "
             "on a wedged card)")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="TOTAL deadline in seconds across all probes (default "
                        "120; a wedged card is reported within this bound, not "
                        "waited out)")
    p.add_argument("--only", nargs="+", default=None, choices=list(_ALL_CHECKS),
                   help="run a subset of checks")
    p.add_argument("--compact", action="store_true", help="single-line JSON")
    p.add_argument("--device", default="cuda",
                   help="the device the backend and kernels checks probe "
                        "(default cuda; cpu checks the CPU and runs the plain "
                        "versions)")
    p.set_defaults(fn=cmd_doctor)
