"""Headline benchmark of the PyTorch port: online 720p stabilization on one card.

    python -m stabnet_tpu_torch.bench [--device cuda|cpu]
    python -m stabnet_tpu_torch.cli.main bench [--device cuda|cpu]

The port of the JAX package's root `bench.py`: the same six legs in the same
order, the same headline line on stdout (`metric`, `value`, `unit` and the
`fps_*` / `online_*` keys), re-emitted after every leg with the stats line on
stderr, and the same budget machinery under the same `STABNET_BENCH_*` hooks:
one total deadline (`STABNET_BENCH_DEADLINE_S`, default 480 s) shared by
retried attempts, a guard that exits 0 at the deadline once a leg has landed
(112 before that), an init watchdog (113) over whatever can hang before the
first device computation (torch's import, CUDA's initialization, the kernels'
build), a transient CUDA error at that computation (114), and measured legs
kept across attempts.

The legs (defaults v2_93, 720x1280, S=6 streams, T=61 frames, 2 repeats):
batch (`StreamEngine.stabilize_clip` on S streams; with several cards
`stabilize_clips_sharded`, S per card, frames/s per card), out2 (1080x1920,
S2=6), single_stream, latency_slope (two clip lengths), online_latency (frame
at a time: wall, upload, dispatch, compute+readback, and the device-resident
step against a fence floor) and pipelined.  Inputs go to the device before
each timed window; a window ends with a scalar read-back of a strided sum.
On the card the serving step launches kernels K1 and K2m of `csrc/warp.cu`
once per frame and refine pass, inside the engine's captured CUDA graph
(one replay per frame; launches counted per replay); a failed build,
capture or launch fails the run.

Where it differs from the JAX bench, by design:

  * paired latency: each device-resident step is timed right after a
    fence-floor call (a trivial device op and a scalar read-back), and
    `online_latency_device_p50_ms` / `_p90_ms` are percentiles of the
    paired differences, so p90 >= p50 (the JAX bench subtracts the floor's
    percentiles from the steps' apart, which inverted them once);
  * FLOPs from the model: `flops_per_frame_g` is the regressor's forward at
    batch 1 as `torch.utils.flop_counter.FlopCounterMode` counts it, the MFU
    basis; the JAX formula's value is `flops_per_frame_g_analytic` beside it
    (it takes ResNet-50's 4.1 G multiply-adds for FLOPs);
  * the card's own peak: the MFU denominator is the dense bf16 tensor-core
    peak of the card by name (`PEAK_BF16_TFLOPS`, or
    `STABNET_BENCH_PEAK_TFLOPS`); an unknown card raises; on the CPU the
    share is null.  The stats line names the card and its power limit;
  * no target: `vs_baseline` is null (no baseline is set for the card);
  * launch counts: the stats line carries `kernel_launches`, each kernel's
    launches in this process so far (all 0 on the CPU, where the plain
    versions run), so each leg shows the kernels it went through.

Without CUDA the bench exits 1 unless the CPU is asked for
(`--device cpu` or `STABNET_BENCH_DEVICE=cpu`, a smoke run of the plain
versions at small sizes); it never measures the CPU in the card's place.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

# Exit codes shared by the attempts and the retry wrapper.
WATCHDOG_EXIT_CODE = 113        # the device did not come up; a fresh attempt may work
NO_MEASUREMENT_EXIT_CODE = 112  # total deadline hit before any leg completed
TRANSIENT_INIT_EXIT_CODE = 114  # the first device computation raised a CUDA error

# Dense bf16 tensor-core peak (TFLOP/s, no sparsity) by the name torch
# reports for the card: NVIDIA's H100 SXM data sheet, at its 700 W limit.
PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}


def _deadline_ts() -> float:
    """Absolute wall-clock deadline, shared across retry attempts via env.

    STABNET_BENCH_DEADLINE_S <= 0 disables the budget (interactive runs).
    """
    ts = os.environ.get("STABNET_BENCH_DEADLINE_TS")
    if ts:
        return float(ts)
    budget = float(os.environ.get("STABNET_BENCH_DEADLINE_S", "480"))
    return float("inf") if budget <= 0 else time.time() + budget


def _arm_deadline_guard(deadline: float, state: dict) -> None:
    """Exit cleanly at the total deadline instead of being killed.

    A daemon thread, so it fires while the main thread is blocked in a hung
    device call.  Once a leg has emitted its lines (state["emitted"]) the run
    exits 0, its latest headline already on stdout; before that it exits
    NO_MEASUREMENT_EXIT_CODE, for the retry wrapper to judge.  A leg that
    fails raises and ends the run non-zero; only the deadline exits 0.
    """
    if deadline == float("inf"):
        return

    def watch():
        while True:
            rem = deadline - time.time()
            if rem <= 0:
                break
            time.sleep(min(rem, 5.0))
        if state.get("emitted"):
            sys.stderr.write("bench: total deadline reached — exiting with the legs "
                             "measured so far\n")
            sys.stderr.flush()
            os._exit(0)
        sys.stderr.write("bench: total deadline reached before any measurement "
                         "completed\n")
        sys.stderr.flush()
        os._exit(NO_MEASUREMENT_EXIT_CODE)

    threading.Thread(target=watch, daemon=True).start()


def _persist_path(deadline: float) -> Optional[str]:
    """The file that carries measured legs across the attempts of one run,
    keyed by the absolute deadline they share (to the microsecond, so two
    runs started in one second do not share it); None without a deadline."""
    if deadline == float("inf"):
        return None
    return os.path.join(tempfile.gettempdir(), f"stabnet_bench_legs_{deadline:.6f}.json")


def _load_legs(path) -> dict:
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                saved = json.load(f)
            if isinstance(saved.get("legs"), list):
                return saved
        except (OSError, ValueError):
            pass  # a torn write of a force-exited attempt: start clean
    return {"legs": [], "stats": {}, "headline": {}}


def _save_legs(path, legs, stats, headline) -> None:
    if not path:
        return
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"legs": sorted(legs), "stats": stats, "headline": headline}, f)
    os.replace(tmp, path)  # atomic: a force-exit mid-save cannot tear the file


def _arm_init_watchdog(seconds: float = 150.0) -> threading.Event:
    """Exit WATCHDOG_EXIT_CODE if the device has not come up in `seconds`.

    Covers what can hang before the first device computation: torch's
    import, CUDA's initialization, the kernels' first build.  Set the
    returned event to disarm it; `seconds` <= 0 disables it.
    """
    armed = threading.Event()
    if seconds <= 0:
        return armed

    def watch():
        if not armed.wait(seconds):
            print(f"bench: the device did not come up within {seconds:.0f}s (torch "
                  "import, CUDA init or the kernels' build appears wedged); no "
                  "measurement taken", file=sys.stderr, flush=True)
            os._exit(WATCHDOG_EXIT_CODE)

    threading.Thread(target=watch, daemon=True).start()
    return armed


# --- measurement helpers ---------------------------------------------------

def peak_tflops(device_name: str) -> float:
    """The dense bf16 peak of the card named `device_name` (TFLOP/s):
    STABNET_BENCH_PEAK_TFLOPS if set, else `PEAK_BF16_TFLOPS`; raises for a
    card in neither."""
    env = os.environ.get("STABNET_BENCH_PEAK_TFLOPS")
    if env:
        return float(env)
    if device_name not in PEAK_BF16_TFLOPS:
        raise RuntimeError(f"no published bf16 peak for {device_name!r}: add it to "
                           f"PEAK_BF16_TFLOPS or set STABNET_BENCH_PEAK_TFLOPS")
    return PEAK_BF16_TFLOPS[device_name]


def card_power_limit_w(index: int = 0) -> Optional[float]:
    """The card's power limit in watts as nvidia-smi reports it, or None
    where nvidia-smi cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index),
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             check=True, capture_output=True, text=True, timeout=60).stdout
        return float(out.strip().splitlines()[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def model_flops_per_frame(cfg) -> int:
    """The regressor's forward FLOPs at batch 1 and the model's input shape,
    as `torch.utils.flop_counter.FlopCounterMode` counts them (two per
    multiply-add of each convolution and matrix product): a property of the
    model's shapes, not of what implements them.  Counted on the meta
    device, where nothing is computed.  v2_93: 22,780,889,088."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from stabnet_tpu_torch.models.resnet import StabNetRegressor

    with torch.device("meta"):
        model = StabNetRegressor(cfg.in_channels, cfg.theta_dim,
                                 dtype=getattr(torch, cfg.compute_dtype)).eval()
        x = torch.zeros((1, cfg.height, cfg.width, cfg.in_channels))
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x)
    return counter.get_total_flops()


def analytic_gflops_per_frame(cfg) -> float:
    """The JAX bench's MFU basis (bench.py:413-414): ResNet-50's 4.1 G at
    224x224x3, linear in pixels, plus the stem's extra input channels.  4.1
    G is ResNet-50's multiply-add count, not its FLOPs, so this undercounts
    the model; reported beside the count, never used as the basis."""
    px_ratio = (cfg.height * cfg.width) / (224.0 * 224.0)
    return (4.1 + 0.236 * (cfg.in_channels - 3) / 3.0) * px_ratio


def paired_percentiles(fenced_s, floor_s, qs=(50, 90)):
    """Percentiles (ms) of the paired differences fenced_i - floor_i, each
    step's fenced time less the fence floor timed right before it: one
    distribution, so p90 >= p50 always."""
    diff_ms = (np.asarray(fenced_s, np.float64) - np.asarray(floor_s, np.float64)) * 1e3
    return [float(np.percentile(diff_ms, q)) for q in qs]


def clip_inputs(cfg, out_hw, T: int):
    """One stream's (gray (1, T, H, W) float32, color (1, T, Ho, Wo, 3)
    uint8): `make_video(8, Ho, Wo, seed=0, jitter=4.0)` tiled to T frames and
    its model-scale grays, as the JAX bench builds them."""
    from stabnet_tpu_torch.data.synthetic import make_video
    from stabnet_tpu_torch.stream.video_io import to_gray_train

    uniq = make_video(8, out_hw[0], out_hw[1], seed=0, jitter=4.0)
    grays = np.stack([to_gray_train(f, cfg.height, cfg.width) for f in uniq])
    idx = np.arange(T) % 8
    return grays[idx][None], uniq[idx][None]


def streams_on(a: np.ndarray, S: int, device):
    """S copies of the one stream `a` (1, T, ...), made on `device`."""
    import torch

    t = torch.from_numpy(a).to(device)
    return t.expand((S,) + tuple(t.shape[1:])).contiguous()


def fence(warped) -> int:
    """A scalar read-back of a strided sum of the clips' last frame: returns
    once the run's work is done (bench.py:316-317)."""
    return int(warped[:, -1, ::97, ::119, 0].sum())


def measure(run, gray, color, repeats: int, mark=None) -> float:
    """Frames/s of `run(gray, color)` (whole clips: frame 0 warms the
    history, frames 1..T-1 are processed) over `repeats` runs after one
    warm-up run, which takes the kernels' first launches, cuDNN's
    algorithm search and the capture of the engine's CUDA graph (its first
    frame runs eagerly, the rest replay it) out of the window.  `gray` and `color` are on their
    devices already: a tensor each, or a list of per-card shards."""
    mark = mark or (lambda phase: None)
    w, _ = run(gray, color)
    fence(w)
    mark("compiled + warm")
    t0 = time.perf_counter()
    for _ in range(repeats):
        w, _ = run(gray, color)
    fence(w)
    dt = time.perf_counter() - t0
    mark("measured")
    shards = gray if isinstance(gray, list) else [gray]
    streams = sum(g.shape[0] for g in shards)
    return streams * (shards[0].shape[1] - 1) * repeats / dt


# --- the run ----------------------------------------------------------------

def main(device: Optional[str] = None) -> None:
    deadline = _deadline_ts()
    state = {"emitted": False}
    _arm_deadline_guard(deadline, state)

    def remaining() -> float:
        return deadline - time.time()

    # Test hook: cap how many legs this attempt may MEASURE (restored legs
    # do not count), which pins the leg order without wall-clock staging.
    max_legs = int(os.environ.get("STABNET_BENCH_MAX_LEGS", "99"))
    measured_legs = [0]

    def fits(leg: str, est_s: float) -> bool:
        if measured_legs[0] >= max_legs:
            print(f"bench: skipping leg '{leg}' — STABNET_BENCH_MAX_LEGS={max_legs} "
                  f"reached", file=sys.stderr, flush=True)
            return False
        if remaining() >= est_s:
            return True
        print(f"bench: skipping leg '{leg}' — needs ~{est_s:.0f}s, "
              f"{max(remaining(), 0):.0f}s left in the budget", file=sys.stderr, flush=True)
        return False

    # A comma list gives per-attempt watchdog values (a short fuse for a
    # simulated wedge, a CI-sized one for the retry); the watchdog never
    # takes more than the deadline leaves after a minimal measurement.
    wd_parts = os.environ.get("STABNET_BENCH_WATCHDOG_S", "360,150").split(",")
    attempt = int(os.environ.get("STABNET_BENCH_ATTEMPT", "0"))
    watchdog_s = float(wd_parts[min(attempt, len(wd_parts) - 1)])
    if deadline != float("inf") and watchdog_s > 0:
        watchdog_s = min(watchdog_s, max(10.0, remaining() - 120.0))
    watchdog_disarm = _arm_init_watchdog(watchdog_s)

    # Test hook: a wedge on the listed attempts ("0" = first), before torch
    # is imported, so the watchdog must fire.
    fake = os.environ.get("STABNET_BENCH_FAKE_WEDGE_ATTEMPTS")
    if fake and str(attempt) in fake.split(","):
        time.sleep(3600)

    t_start = time.time()

    def mark(phase: str) -> None:
        # Phase times on stderr: a run cut by the deadline shows where its
        # budget went (init, build, warm-up, measurement).
        print(f"bench: +{time.time() - t_start:.0f}s {phase}", file=sys.stderr, flush=True)

    import torch

    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.models import make_model, scale_theta_head
    from stabnet_tpu_torch.ops import cuda_warp
    from stabnet_tpu_torch.stream import StreamEngine
    from stabnet_tpu_torch.stream.driver import _Readback
    from stabnet_tpu_torch.utils import resolve_device

    try:
        dev = resolve_device(device or os.environ.get("STABNET_BENCH_DEVICE", "cuda"))
    except RuntimeError as e:
        print(f"bench: {e}; the bench measures the card and never the CPU in its "
              f"place (--device cpu runs a CPU smoke run)", file=sys.stderr, flush=True)
        sys.exit(1)
    on_card = dev.type == "cuda"
    if on_card:
        from stabnet_tpu_torch.ops import cuda_build

        t0 = time.time()
        cuda_build.load("warp")  # K1 and K2m, the serving step's kernels
        mark(f"kernels built and loaded in {time.time() - t0:.1f}s")
        device_name = torch.cuda.get_device_name(dev)
        peak = peak_tflops(device_name)
        n_dev = torch.cuda.device_count()
        power_w = card_power_limit_w(dev.index or 0)
    else:
        device_name, peak, n_dev, power_w = "cpu", None, 1, None

    cfg = get_config(os.environ.get("STABNET_BENCH_CONFIG", "v2_93"))
    # Seeded random weights with the theta head scaled to production
    # magnitude, so the warps are of the size deployment sees.
    model = scale_theta_head(make_model(cfg, torch.Generator().manual_seed(0)))
    try:
        # Test hook: a transient error at the first computation on the
        # listed attempts.
        fake_tr = os.environ.get("STABNET_BENCH_FAKE_TRANSIENT_ATTEMPTS")
        if fake_tr and str(attempt) in fake_tr.split(","):
            raise RuntimeError("CUDA error: simulated failure at the first read-back")
        # The first device computation: a read-back of the first parameter.
        float(next(model.parameters()).detach().to(dev).sum())
    except RuntimeError as e:
        if "CUDA" not in str(e):
            raise
        print(f"bench: the first device computation failed with a transient error: "
              f"{e}", file=sys.stderr, flush=True)
        sys.exit(TRANSIENT_INIT_EXIT_CODE)
    watchdog_disarm.set()
    mark(f"{device_name} alive (first read-back done)")

    out_h, out_w = (int(v) for v in os.environ.get("STABNET_BENCH_OUT", "720,1280").split(","))
    T = int(os.environ.get("STABNET_BENCH_T", "61"))     # frames per clip (T-1 processed)
    if T < 9:
        raise SystemExit("bench: STABNET_BENCH_T must be >= 9 (the slope and latency legs)")
    S = int(os.environ.get("STABNET_BENCH_S", "6"))      # streams per card, batch mode
    repeats = int(os.environ.get("STABNET_BENCH_REPEATS", "2"))

    gray1, color1 = clip_inputs(cfg, (out_h, out_w), T)
    mark("inputs prepared")
    engine = StreamEngine(model, cfg, out_hw=(out_h, out_w), device=dev)

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    def leg_mark(label):
        return lambda phase: mark(f"leg '{label}' {phase}")

    headline = {"metric": f"stabilized_{out_h}p_throughput", "value": None,
                "unit": "frames/s/chip", "vs_baseline": None}
    stats = {"device": device_name, "power_limit_w": power_w, "n_devices": n_dev}

    # Legs measured by earlier attempts of the same run are kept.
    persist_path = _persist_path(deadline)
    saved = _load_legs(persist_path)
    done = set(saved["legs"])
    if done:
        for k, v in saved["stats"].items():
            stats.setdefault(k, v)
        for k, v in saved["headline"].items():
            if headline.get(k) is None and v is not None:
                headline[k] = v
        print(f"bench: restored completed legs from a previous attempt: {sorted(done)}",
              file=sys.stderr, flush=True)

    def emit() -> None:
        # The headline on stdout (the last line is the most complete), the
        # stats on stderr, both flushed before any later forced exit.
        stats["kernel_launches"] = {k.__name__: k.launches for k in cuda_warp.KERNELS}
        print(json.dumps(stats), file=sys.stderr, flush=True)
        print(json.dumps(headline), flush=True)
        state["emitted"] = True

    def leg_done(name: str) -> None:
        done.add(name)
        measured_legs[0] += 1
        _save_legs(persist_path, done, stats, headline)

    if done and headline["value"] is not None:
        emit()  # the restored headline is on stdout before any new leg runs

    # ---- Leg 1 (headline): 720p batch throughput ---------------------------
    if "batch" not in done and fits("batch", 120):
        if n_dev > 1:
            # S streams per card, one model replica each; the shards are
            # placed on their cards before the window.
            from stabnet_tpu_torch.parallel import data_devices

            devs = data_devices()
            gS = [streams_on(gray1, S, d) for d in devs]
            cS = [streams_on(color1, S, d) for d in devs]
            run_batch = engine.stabilize_clips_sharded
        else:
            gS, cS = streams_on(gray1, S, dev), streams_on(color1, S, dev)
            run_batch = engine.stabilize_clip
        fps_total = measure(run_batch, gS, cS, repeats, leg_mark("batch"))
        del gS, cS
        fps_batch = fps_total / n_dev
        stats[f"fps_{out_h}p_batch{S}_per_chip"] = fps_batch
        if n_dev > 1:
            stats[f"fps_{out_h}p_batch_total"] = fps_total
        headline["value"] = round(fps_batch, 2)
        flops_g = model_flops_per_frame(cfg) / 1e9
        achieved = fps_batch * flops_g / 1e3
        stats["flops_per_frame_g"] = flops_g
        stats["flops_per_frame_g_analytic"] = round(analytic_gflops_per_frame(cfg), 4)
        stats["achieved_tflops_per_s_per_chip"] = round(achieved, 7)
        stats["mfu_vs_bf16_peak"] = None if peak is None else round(achieved / peak, 9)
        mark(f"MFU basis {flops_g} GFLOP/frame (FlopCounterMode)"
             + (f", peak {peak} TFLOP/s bf16 ({device_name})" if peak else ""))
        emit()
        leg_done("batch")
    fps_batch = stats.get(f"fps_{out_h}p_batch{S}_per_chip")

    # ---- Leg 2: the second output geometry (default 1080p) ------------------
    # Same model, a second engine at the other warp size, batch mode, one
    # card.  An empty STABNET_BENCH_OUT2 disables it.
    out2 = os.environ.get("STABNET_BENCH_OUT2", "1080,1920")
    if out2 and "out2" not in done and fits("out2", 110):
        out2_h, out2_w = (int(v) for v in out2.split(","))
        S2 = int(os.environ.get("STABNET_BENCH_S2", "6"))
        gray2, color2 = clip_inputs(cfg, (out2_h, out2_w), T)
        engine2 = StreamEngine(model, cfg, out_hw=(out2_h, out2_w), device=dev)
        fps2 = measure(engine2.stabilize_clip, streams_on(gray2, S2, dev),
                       streams_on(color2, S2, dev), repeats, leg_mark("out2"))
        del engine2, gray2, color2
        stats[f"fps_{out2_h}p_batch{S2}_per_chip"] = fps2
        headline[f"fps_{out2_h}p_per_chip"] = round(fps2, 2)
        emit()
        leg_done("out2")

    g1, c1 = streams_on(gray1, 1, dev), streams_on(color1, 1, dev)

    # ---- Leg 3: single-stream throughput (also feeds the slope leg) --------
    if "single_stream" not in done and fits("single_stream", 70):
        fps_s1 = measure(engine.stabilize_clip, g1, c1, repeats, leg_mark("s1"))
        stats[f"fps_{out_h}p_single_stream"] = fps_s1
        headline["value"] = round(max(v for v in (fps_s1, fps_batch) if v is not None), 2)
        emit()
        leg_done("single_stream")
    fps_s1 = stats.get(f"fps_{out_h}p_single_stream")

    # ---- Leg 4: per-frame device latency by the slope method ----------------
    # The single-stream clip at two lengths: fixed costs (dispatch, the
    # fence's read-back) cancel in the difference, which is divided by the
    # extra frames.
    if fps_s1 is not None and "latency_slope" not in done and fits("latency_slope", 50):
        T_short = max(2, min(21, T // 3 + 2, T - 1))
        fps_short = measure(engine.stabilize_clip, g1[:, :T_short], c1[:, :T_short],
                            repeats, leg_mark("s1short"))
        t_long = (T - 1) * repeats / fps_s1
        t_short = (T_short - 1) * repeats / fps_short
        device_ms = (t_long - t_short) / ((T - T_short) * repeats) * 1e3
        stats["online_frame_latency_device_ms_slope"] = round(device_ms, 3)
        headline["online_latency_device_ms"] = round(device_ms, 3)
        emit()
        leg_done("latency_slope")

    # ---- Leg 5: frame-at-a-time online latency and its parts ----------------
    if "online_latency" not in done and fits("online_latency", 60):
        state1 = engine.init(gray1[:, 0])
        lat = []
        for i in range(1, 9):
            s = time.perf_counter()
            state1, out = engine.step(state1, gray1[:, i], color1[:, i])
            float(out.black[:, ::97, ::119].sum())
            lat.append(time.perf_counter() - s)
        lat_ms = np.asarray(lat[2:]) * 1e3

        up_ms, disp_ms, read_ms = [], [], []
        for i in range(1, 9):
            s = time.perf_counter()
            g = torch.from_numpy(gray1[:, i]).to(dev)
            c = torch.from_numpy(color1[:, i]).to(dev)
            sync()
            t1 = time.perf_counter()
            state1, out = engine.step(state1, g, c)
            t2 = time.perf_counter()
            out.warped_color[0].cpu().numpy()
            t3 = time.perf_counter()
            up_ms.append((t1 - s) * 1e3)
            disp_ms.append((t2 - t1) * 1e3)
            read_ms.append((t3 - t2) * 1e3)

        # Device-resident steps, each fenced by a scalar read-back, each
        # paired with a fence-floor call (a trivial device op and its
        # read-back) timed right before it.
        g_res = [torch.from_numpy(gray1[:, i]).to(dev) for i in range(1, 9)]
        c_res = [torch.from_numpy(color1[:, i]).to(dev) for i in range(1, 9)]
        z = torch.zeros((), device=dev)
        float(z + 1.0)
        floor, fenced = [], []
        for i in range(8):
            s = time.perf_counter()
            float(z + 1.0)
            floor.append(time.perf_counter() - s)
            s = time.perf_counter()
            state1, out = engine.step(state1, g_res[i], c_res[i])
            float(out.black[:, ::97, ::119].sum())
            fenced.append(time.perf_counter() - s)
        dev_p50, dev_p90 = paired_percentiles(fenced[1:], floor[1:])
        stats["online_step_device_resident_fenced_p50_ms"] = round(
            float(np.percentile(np.asarray(fenced[1:]) * 1e3, 50)), 2)
        stats["online_step_fence_floor_p50_ms"] = round(
            float(np.percentile(np.asarray(floor[1:]) * 1e3, 50)), 2)
        stats["online_latency_device_p50_ms"] = round(dev_p50, 2)
        stats["online_latency_device_p90_ms"] = round(dev_p90, 2)

        stats["online_step_latency_wall_p50_ms"] = float(np.percentile(lat_ms, 50))
        stats["online_step_upload_p50_ms"] = round(float(np.percentile(up_ms, 50)), 2)
        stats["online_step_dispatch_p50_ms"] = round(float(np.percentile(disp_ms, 50)), 2)
        stats["online_step_compute_readback_p50_ms"] = round(
            float(np.percentile(read_ms, 50)), 2)
        headline["online_latency_wall_p50_ms"] = round(float(np.percentile(lat_ms, 50)), 1)
        headline["online_latency_device_p50_ms"] = round(dev_p50, 2)
        emit()
        leg_done("online_latency")

    # ---- Leg 6: pipelined single-stream serving -----------------------------
    # StreamDriver's production default: frame t-1 is read back only after
    # step t was dispatched, from a pinned buffer behind an event.
    if "pipelined" not in done and fits("pipelined", 40):
        bufs = [torch.empty((out_h, out_w, 3), dtype=torch.uint8, pin_memory=True)
                if on_card else None for _ in range(2)]
        state1 = engine.init(gray1[:, 0])
        pend = None
        t0 = time.perf_counter()
        for i in range(1, T):
            state1, out = engine.step(state1, gray1[:, i], color1[:, i])
            current = _Readback(out.warped_color[0], bufs[i % 2])
            if pend is not None:
                pend.read()
            pend = current
        pend.read()
        fps_pipelined = (T - 1) / (time.perf_counter() - t0)
        stats["online_pipelined_wall_fps"] = round(fps_pipelined, 1)
        headline["online_pipelined_wall_fps"] = round(fps_pipelined, 1)
        emit()
        leg_done("pipelined")

    if not state["emitted"]:
        print("bench: no leg fit the remaining budget", file=sys.stderr, flush=True)
        sys.exit(NO_MEASUREMENT_EXIT_CODE)


def _main_with_retries(device: Optional[str] = None) -> None:
    """Bounded re-attempts after a wedge or a transient, inside ONE deadline.

    Each attempt is a fresh process (`python -m stabnet_tpu_torch.bench`
    with STABNET_BENCH_CHILD=1; a process stuck in CUDA's initialization
    cannot recover in place), given the shared absolute deadline in
    STABNET_BENCH_DEADLINE_TS.  An exit of 113, 112 or 114 is retried while
    the budget still covers STABNET_BENCH_MIN_RETRY_S (init and the headline
    leg); any other exit passes straight through.  STABNET_BENCH_ATTEMPTS=1
    runs in this process.  `device` overrides STABNET_BENCH_DEVICE.
    """
    attempts = max(1, int(os.environ.get("STABNET_BENCH_ATTEMPTS", "3")))
    if os.environ.get("STABNET_BENCH_CHILD") or attempts == 1:
        main(device)
        return
    deadline = _deadline_ts()
    min_retry_budget = float(os.environ.get("STABNET_BENCH_MIN_RETRY_S", "150"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, STABNET_BENCH_CHILD="1", PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    if device:
        env["STABNET_BENCH_DEVICE"] = device
    if deadline != float("inf"):
        env["STABNET_BENCH_DEADLINE_TS"] = repr(deadline)
    rc = 0
    try:
        for i in range(attempts):
            env["STABNET_BENCH_ATTEMPT"] = str(i)
            rc = subprocess.call([sys.executable, "-m", "stabnet_tpu_torch.bench"], env=env)
            if rc not in (WATCHDOG_EXIT_CODE, NO_MEASUREMENT_EXIT_CODE,
                          TRANSIENT_INIT_EXIT_CODE):
                break
            left = deadline - time.time()
            if i + 1 >= attempts or left < min_retry_budget:
                break
            # A transient clears in seconds; a wedge needs the long pause.
            default_pause = "5" if rc == TRANSIENT_INIT_EXIT_CODE else "60"
            pause = min(float(os.environ.get("STABNET_BENCH_RETRY_PAUSE_S", default_pause)),
                        max(0.0, left - min_retry_budget))
            why = ("hit a transient CUDA failure at the first read-back"
                   if rc == TRANSIENT_INIT_EXIT_CODE else "hit the init watchdog")
            print(f"bench: attempt {i + 1}/{attempts} {why}; retrying in {pause:.0f}s "
                  f"({left:.0f}s of budget left)", file=sys.stderr, flush=True)
            time.sleep(pause)
    finally:
        # The carried legs serve this run's attempts only.
        path = _persist_path(deadline)
        if path and os.path.exists(path):
            os.remove(path)
    sys.exit(rc)


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device (default STABNET_BENCH_DEVICE, else cuda; "
                             "cpu runs a smoke run of the plain versions)")


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="python -m stabnet_tpu_torch.bench",
                                description="the port's headline benchmark")
    add_arguments(p)
    _main_with_retries(p.parse_args().device)
