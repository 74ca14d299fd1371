#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure stops the run with a
nonzero exit):
  1. device: the card (nvidia-smi name and power limit) and the kernels'
     build from stabnet_tpu_torch/csrc (one nvcc per source, in parallel),
     then the native crop's (g++);
  2. K2 (f32 sampler at given maps) against its plain PyTorch version on
     the card, bit for bit, at S=1 and S=4 and at the training shapes
     (10, 288, 512, 2) and (20, 288, 512, 1), and at 5 channels (read at
     run time), on realistic and adversarial maps, both strict_edge modes;
     K2m (the serving warp: dense maps, black mask and sampler in one
     launch) against its plain version, bit for bit, at S=1, 4 and 6 (the
     bench's batch) with the frame read in place from the 13-channel stack,
     in the stack layout of a refine pass (also at S=10, the debug forward's
     batch), at 289x515 (S=1 and 6), on a zoomed-out mesh with black
     borders, on a mesh with Z < 0 in some cells and on 8x8 meshes: each
     layout the wrapper picks (one or four pixels per thread) at a full and
     a ragged right edge and on both mesh sizes;
  3. K1 (uint8 color warp, fused map up-sample) and K3 (the same warp at
     full-resolution maps) against their plain versions, bit for bit, at
     720p S=1, 4 and 6, 1080p S=1 and 6 (the bench's batches), 719x1283
     and zoomed maps, and at 360x640
     from maps too wide for K1 to stage their row pass;
  4. the serving path at v2_93 (bf16, seeded random weights, theta head
     scaled by 0.05) on a 40-frame synthetic 720p clip: StreamDriver at S=1
     and StreamEngine.stabilize_clip at S=4, with the kernels' launch counts
     (per graph replay) read around each run; then the serving graphs held
     torch.equal to the eager stream_step / scan_frames (warped frames,
     ring, all_black, crop): the S=1 driver and step loop with the device
     gray, S=4 with a prefix valid, S=6 and refine 2, with each graph's
     capture seconds and pool bytes;
  5. card against CPU in f32 (TF32 off), 8 frames;
  6. serving times: CUDA events, 5 warm-ups, median of 50 runs; K2m at
     S=1, 4, 6 and 10 (channels last) beside an empty kernel at its grid
     (the launch floor) and, at S=1 and S=4, the unfused chain it replaces
     (dense maps, black mask, frame copy, K2), K2 at S=1 and S=4, K1 and K3
     at 720p S=1 and S=4 and at 1080p (K3 is on no path, as in the JAX
     package), K1 at the bench's S=6 at 720p and 1080p; the S=1 path as
     graph replays and as eager steps, in turns: wall mean and p50, kernel
     time, device idle share, device operations and host launches per
     frame, K2m and K1 once per frame in the trace;
  7. K4 (splat) and K6b (map gradient) against their plain versions on the
     card, realistic and adversarial maps, K4 also on flow-like maps (every
     pass-2 tile sums in shared memory) and half of each; K5/K6 through
     autograd;
  8. the training path: `make-synthetic` 20 v2_93 examples, then `train`
     through the port's CLI at v2_93 bf16 batch 10 for 4 steps with every
     loss term live, then `--restore` to step 6 (the loop's steps replay
     captured CUDA graphs), launch counts read around each segment (K2 2,
     K4 1, K6b 1 per step, counted per replay, backwards included) and the
     wall per iteration between the loop's log lines;
  9. one v2_93 training step, card against CPU, f32 (TF32 off), batch 2;
     then the compiled step against the eager one, v2_93 f32 batch 2, six
     steps across every loss gate and a learning-rate step: torch.equal if
     two eager runs are, else both under deterministic algorithms (or 3x
     the eager spread where those refuse an operation), exactly one
     training graph, K2 2, K4 1, K6b 1 per replayed step;
 10. training times: K4 (with each pass's time under torch.profiler) and
     K6b at their training shapes; the v2_93 bf16 batch-10 step with the
     input pipeline, graph, eager, graph (ms per step, per iteration, the
     "data" and "step" stage means, peak memory), then back to back on one
     batch under torch.profiler (wall, kernels, idle share, device
     operations and host launches per step); the eval graph against
     eval_step and the augmentation graph against augment_batch (torch.equal),
     each graph's capture seconds and pool bytes;
 11. TV-L1 flow: K2 in its edge-inclusive mode against its plain version,
     bit for bit, at the pyramid of the training shape, (10, 288, 512, 3)
     down to (10, 32, 64, 3), and at the metrics' pyramid, (32, 144, 256,
     3) down to (32, 16, 32, 3), on clipped flow maps, and its times;
     tvl1_flow at (10, 288, 512), fine_iters 40 (the metrics' flow runs
     inside the metrics chunk's graphs, phase 12): the captured graph
     torch.equal the eager flow, its launches per replay (20 of K2), ms
     per call both ways,
     capture seconds and pool bytes, device operations and host launches
     per call both ways; card against CPU at (2, 96, 128), bit for bit; a
     translation recovered on the card;
 12. quality metrics: the S=1 driver keeping its input grays on the
     40-frame 720p clip, then score_stabilized_clip at 144x256 (launches,
     seconds per clip with the metrics chunk's three graphs captured,
     every score in (0, 1]); the clip scored again through the graphs
     (its wall split into the grays, the chunk replays and the rest) and
     with the eager chunks, every score equal; each chunk key's graph
     (output stability: prealign and a rect; input stability: prealign;
     cross-video: a rect) torch.equal the eager chunk on the scoring's own
     first chunk of that key, 20 K2 launches per replay, device operations,
     host launches and ms per chunk both ways, capture seconds and pool
     bytes; evaluate_clip card against
     CPU on the driver's first 12 frames at 144x256, and where the devices
     part: the flow of those frames and the phase correlation bit for bit,
     the fit, the spectrum and the singular values on equal inputs;
 13. flow-fed training: phase 8's shards with the flow field stripped,
     `train` refused on them, then `train --compute-flow` through the CLI
     at v2_93 bf16 batch 10 for 12 steps with the temporal loss live, its
     launches, training seconds and wall per iteration beside phase 10's;
 14. serving modes at v2_93 bf16 720p on phase 4's clips: the S=1 driver
     pipelined against synchronous (bit for bit, per-frame p50 and p90 of
     each, and each equal to phase 4's eager frames); stabilize_batch of clips of 40, 23 and 9 frames at 4 streams,
     chunked by 16 against unchunked and each clip against itself alone
     (bit for bit; K1 and K2m once per scanned step); the 4-clip batch's
     frames/s beside its host preparation; stabilize_stream over arrays at
     chunk 16 against the chunked batch (bit for bit); every ablation mode
     and --deploy-vis for 8 frames with a stable clip; one ablation mode card
     against CPU in f32; the native crop against the plain one on every
     clip's black map, and their times;
 15. weights in: `stabilize --model-dir`'s engine (cli.main.build_engine)
     on phase 8's step-6 checkpoint against an engine loaded from that
     state.pt by hand (bit for bit); the TF-slim mapping of a full-width
     seeded slim dict, loaded strictly and served for 8 frames; an ImageNet
     trunk grafted by transfer_from_imagenet, then one training step (finite
     losses; K2 2, K4 1, K6b 1 launches);
 16. export: the v2_93 bf16 720p serving step traced by torch.export at S=1,
     and at S=4 with a 2-frame segment, saved, loaded from bytes and served
     by ExportedEngine (a captured CUDA graph of the step and of the
     segment): the S=1 step's graph torch.equal the program called eagerly
     over 8 frames, the S=4 segment's over 3 segments with a stream frozen;
     phase 4's clip through StreamDriver on the exported engine, graphs and
     eager, against the live one (bit for bit, K1 and K2m once per frame),
     pipelined against synchronous (bit for bit), the 4-clip batch on
     the segment against the live batch chunked by 2 (bit for bit), export
     and load seconds, artifact bytes, "net" p50/p90 in turns live,
     exported graph, exported eager, live, and the device operations and
     host launches per frame of each; then `export
     --platforms` through the CLI with --selftest, traced on the card for
     cuda and cpu and traced on the CPU for cpu and cuda: the header lists
     both programs, neither CUDA program's graph holds a cuDNN-, MKLDNN- or
     CUDA-specific operation, and each program serves on its own device bit
     for bit as the live engine there (each CUDA program the 40-frame clip
     with K1 and K2m once per frame, its graph torch.equal the program
     called eagerly over 4 frames; each CPU program 2 frames with no
     kernel launched);
 17. data parallel: `train --data-parallel` through the CLI on phase 8's
     shards for 2 steps in rank processes of this script, the runs at
     once: (a) one NCCL rank
     under torch.distributed.run against the plain run, v2_93 bf16 batch
     10, bit for bit (cuDNN's deterministic algorithms in both), both
     replaying graphs (each train step through the compiled path); (a')
     one NCCL rank in a process of its own (`chip_smoke.py _dp_graph GO`),
     on BatchNorm's own branch and with its across-ranks branch forced
     (`resnet._ranks` patched to 2 in that process, so its all-reduces run
     and are captured): phase 9's check there (f32, TF32 off, batch 2, six
     gate-crossing steps, the graph torch.equal the eager step under the
     deterministic algorithms) and the eval graph against eval_step; then,
     once the other runs have ended, v2_93 bf16 batch 10 synchronized
     ms/step p50 over 10 steps in turns graph, eager, graph, and per step
     device operations, NCCL kernels (equal in the graph and eager) and
     host launches, capture seconds and pool bytes; (b) two gloo ranks on
     the one card, eager, global batch 10, against one process on the
     merged batch in f32 (TF32 off), within the CPU test's rtol 3.4e-3;
     (c) with two or more cards, two NCCL ranks on two cards replaying
     graphs, bit for bit the same ranks kept eager (`_compiled` patched in
     their processes), and within that bound of the merged batch, else
     "(c) not run: 1 card"; K2 2, K4 1 and K6b 1 launches per rank per
     step, ms per step of each;
 18. sharded serving: stabilize_clips_sharded over two replicas on the card
     at S=4 against each shard's own run at S=2 and the eager scan_frames
     there (frames, ring, all_black, crop), and the driver's sharded
     batch over the card's one replica against the unsharded batch, bit for
     bit;
 19. doctor: `python -m stabnet_tpu_torch.cli.main doctor --compact` in a
     process of its own: every check passes, the backend is this card at
     compute capability 9.0, each kernel (K1, K2 in both edge modes, K2m,
     K3, K4, K6b) launched once per call and bit for bit its plain version;
     then `doctor --only backend --timeout 5` with the backend faked as
     wedged returns within 15 s with exit 1 and "did not respond";
 20. debug-vis: `train --debug-vis --set test_freq=2` through the CLI on
     phase 8's shards, v2_93 bf16 batch 10, 4 steps, against the run
     without it (cuDNN deterministic in both): K2m once per dump (steps 0,
     2 and 3), K2 2, K4 1 and K6b 1 per step, losses and the step-4
     checkpoint bit for bit; without OpenCV the dump warns and writes
     nothing; then the debug forward once more in this process on a
     training batch with the step-4 weights: one K2m launch, bit for bit
     its plain version on the output, mask and maps;
 21. bench: `python -m stabnet_tpu_torch.cli.main bench` at its defaults
     (v2_93 bf16, 720p S=6, T=61, 2 repeats; 1080p S2=6) in a process of
     its own with STABNET_BENCH_DEADLINE_S=300: exit 0, all six legs, the
     headline above 0, the paired device latency's p90 >= p50, the MFU
     share in (0, 1.05] on the counted 22.780889088 GFLOP/frame, the card's
     name and power limit on the stats line; the launches each leg adds to
     the stats line's counts: K1 and K2m once per step of each run (warm-up
     and repeats), no other kernel;
 22. quality gate: scripts/torch_quality_gate.py at --steps 100 --clips 2
     --frames 40 in a process of its own (`chip_smoke.py _gate ARGS`, which
     counts the launches around its training, each served batch and each
     scored clip): exit 0 or 1 as its report says (a pass is not required
     at that schedule), every check of the JAX gate present, and the
     launches: per training step K2 2, K4 1, K6b 1; per served frame K1 and
     K2m once; per scored clip 20 K2 per tvl1_flow call and nothing else;
     its seconds of training;
 23. endurance: scripts/torch_endurance.py at v2_93 (target 4, segments of
     2 in fresh processes, the second through --restore, 10 examples, one
     20-frame clip scored at the end), started beside phase 22: its verdict
     record, scores.jsonl and each training segment's seconds;
and in phase 12 the card-against-CPU gap of fit_homographies split by
cause (its normal equations summed in float64 on both devices).  Each
phase prints its seconds ("[N seconds]"), and a line before the kernels
line sums them.
`python3 chip_smoke.py _dp_rank MODE ARGS...` is phase 17's rank process,
`python3 chip_smoke.py _dp_graph GO` its (a'), `python3 chip_smoke.py
_gate ARGS...` phase 22's; `python3 chip_smoke.py _dp_only` runs phase 17
alone after phase 1 and phase 8's shards (for a machine with several cards,
where (c) runs; it prints no kernels line).
The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}.  Needs CUDA and the repository
beside it; imports nothing of JAX.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

T_CLIP = 40
CLIP_HW = (720, 1280)
# Published peaks (NVIDIA's data sheet, dense, 700 W): HBM bytes/s and f32
# FLOP/s outside the tensor cores, by the name torch reports for the card.
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}


def peaks(name: str):
    """(bytes/s, f32 operations/s) of the card named `name`."""
    if name not in PEAKS:
        raise RuntimeError(f"no published peak rates for {name!r}; add them to PEAKS")
    return PEAKS[name]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def launch_counts():
    from stabnet_tpu_torch.ops import cuda_warp

    return {k.__name__: k.launches for k in cuda_warp.KERNELS}


def exact_ndc(px: np.ndarray, size: int):
    """float32 NDC values whose pixel coordinate (ndc + 1) * (size / 2),
    rounded as float32, is exactly `px` (searched over nearby ulps), and
    where such a value was found."""
    px = np.asarray(px, np.float32)
    base = (px.astype(np.float64) * 2.0 / size - 1.0).astype(np.float32)
    out, ok = base.copy(), np.zeros(px.shape, bool)
    half = np.float32(size / 2.0)
    for steps in (0, 1, -1, 2, -2, 3, -3, 4, -4):
        cand = base
        for _ in range(abs(steps)):
            cand = np.nextafter(cand, np.float32(np.inf if steps > 0 else -np.inf))
        hit = ~ok & ((cand + np.float32(1.0)) * half == px)
        out[hit], ok = cand[hit], ok | hit
    return out, ok


def realistic_homographies(S: int, gen: torch.Generator, device,
                           spread: float = 0.05, zoom: float = 1.0, grid: int = 4):
    """(S, grid, grid, 3, 3) cell homographies of random meshes (vertex
    offsets ~ N(0, spread * 4 / grid), clamped as theta_to_mesh clamps)."""
    from stabnet_tpu_torch.ops import base_mesh, mesh_to_homographies

    mesh = torch.from_numpy(base_mesh(grid, grid)) * zoom
    noise = spread * 4 / grid * torch.randn((S, grid + 1, grid + 1, 2), generator=gen)
    mesh = (mesh + noise).clamp(-1.25, 1.25)
    return mesh_to_homographies(mesh.to(device), grid, grid)


def realistic_maps(S: int, H: int, W: int, gen: torch.Generator, device,
                   spread: float = 0.05, zoom: float = 1.0):
    """Dense NDC maps of random meshes (vertex offsets ~ N(0, spread))."""
    from stabnet_tpu_torch.ops import dense_maps

    return dense_maps(realistic_homographies(S, gen, device, spread, zoom), H, W)


def stack_frame(S: int, H: int, W: int, gen: torch.Generator, device,
                channels_last: bool = False):
    """The current frame as the serving path hands it to K2m: the last
    channel of a 13-channel input stack, a view.  `assemble_input` stacks
    planes (pixel stride 1, image stride 13 H W); a refine pass rebuilds
    the stack channels last (pixel stride 13)."""
    planes = (torch.rand((S, 13, H, W), generator=gen) - 0.5).to(device)
    stack = planes.permute(0, 2, 3, 1)
    return (stack.contiguous() if channels_last else stack)[..., 12:13]


def adversarial_maps(S: int, H: int, W: int, gen: torch.Generator):
    """Samples exactly at W-1 / H-1 / 0, integer coordinates, negative ones,
    beyond +/-1 NDC and random ones, mixed per pixel."""
    rng = np.random.RandomState(int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))
    shape = (S, H, W)
    px = rng.uniform(-2.0, W + 2.0, shape).astype(np.float32)
    py = rng.uniform(-2.0, H + 2.0, shape).astype(np.float32)
    kind = rng.randint(0, 8, shape)
    # Integer coordinates that some float32 NDC value hits exactly (near
    # NDC -1 not every integer row of a 288-row frame is reachable).
    reach = [np.flatnonzero(exact_ndc(np.arange(n), n)[1]) for n in (W, H)]
    ix = rng.choice(reach[0], shape).astype(np.float32)
    iy = rng.choice(reach[1], shape).astype(np.float32)
    px = np.where(kind == 0, W - 1, px)
    py = np.where(kind == 1, H - 1, py)
    px = np.where(kind == 2, W - 1, px)
    py = np.where(kind == 2, H - 1, py)
    px = np.where(kind == 3, rng.uniform(-3.0, 0.0, shape), px)
    px = np.where(kind == 4, ix, px)
    py = np.where(kind == 4, iy, py)
    px = np.where(kind == 5, 0.0, px)
    py = np.where(kind == 5, iy, py)
    xn, xok = exact_ndc(px, W)
    yn, yok = exact_ndc(py, H)
    check(bool(xok[np.isin(kind, (0, 2, 4, 5))].all()
               and yok[np.isin(kind, (1, 2, 4, 5))].all()),
          "adversarial maps: inexact edge targets")
    beyond = kind == 6  # beyond +/-1 NDC
    xn = np.where(beyond, rng.uniform(1.0, 1.5, shape) * rng.choice([-1, 1], shape), xn)
    return (torch.from_numpy(xn.astype(np.float32)),
            torch.from_numpy(yn.astype(np.float32)), kind, px)


def call_ms(fn, warmup: int = 5, reps: int = 50) -> float:
    """Median time of one call of `fn` as a caller sees it: CUDA events
    around each call, so the host's launch work is included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls: int = 20, warmup: int = 5, reps: int = 50) -> float:
    """Median device time of one call of `fn`: `calls` calls captured in one
    CUDA graph, so they run back to back without the host in between; each
    of `reps` replays is timed by CUDA events and divided by `calls`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(warmup):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


# The CUDA runtime and driver calls that queue work on the device: a host
# launch each, whatever the work (a kernel, a copy, a fill, a whole graph).
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemcpy2DAsync", "cudaMemsetAsync", "cudaMemset2DAsync")


def profile_counts(prof, calls: int):
    """Per call, from a torch.profiler run over `calls` calls: the device
    operations that ran (kernels, copies, fills: what runs inside a graph
    counts too), their summed time in ms, the host launches (runtime calls
    that queue device work; a graph replay is one) and the device events by
    name."""
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = sum(e.count for e in events if e.key in HOST_LAUNCHES)
    return (sum(e.count for e in device) / calls,
            sum(e.self_device_time_total for e in device) / calls / 1e3,
            host / calls, device)


def profile_path(engine, clip: np.ndarray, frames: int = 20, device_gray: bool = True,
                 eager: bool = False):
    """The same `frames` steps at S=1 with per-frame readback, run twice from
    a fresh state: without the profiler for the wall time, then under
    torch.profiler for the summed kernel time and the kernels that take most.
    The model-scale grays are derived on the device, or with `device_gray`
    False made on the host beforehand and uploaded each step.  The steps are
    the engine's (graph replays), or with `eager` the eager `stream_step` as
    the engine ran it before its graphs (each frame uploaded, then the step).
    Returns (wall mean, wall p50, profiled wall, kernel time) in ms/frame,
    the device operations (kernels, copies, fills) and host launches per
    frame, the launches per frame of K2m and K1 in the trace, and the top
    list."""
    from torch.profiler import ProfilerActivity, profile

    from stabnet_tpu_torch.stream import video_io
    from stabnet_tpu_torch.stream.engine import stream_step

    cfg = engine.cfg
    first = video_io.to_gray_train(clip[0], cfg.height, cfg.width)[None]
    grays = [None if device_gray else video_io.to_gray_train(f, cfg.height, cfg.width)[None]
             for f in clip[: frames + 1]]

    def step(state, gray, color):
        if not eager:
            return engine.step(state, gray, color)
        return stream_step(engine.model, state, None if gray is None else engine._put(gray),
                           engine._put_color(color), cfg, refine=engine.refine,
                           out_hw=engine.out_hw)

    def run():
        state = engine.init(first)
        torch.cuda.synchronize()
        times = []
        t0 = time.perf_counter()
        for t in range(1, frames + 1):
            ts = time.perf_counter()
            state, out = step(state, grays[t], clip[None, t])
            out.warped_color.cpu()
            times.append(time.perf_counter() - ts)
        return (time.perf_counter() - t0) / frames * 1e3, float(np.median(times)) * 1e3

    wall, wall_p50 = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof, _ = run()
    ops, busy, host, kernels = profile_counts(prof, frames)
    per_frame = {name: sum(e.count for e in kernels if name in e.key) / frames
                 for name in ("warp_mesh_kernel", "warp_uint8_kernel")}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return (wall, wall_p50, wall_prof, busy, ops, host, per_frame,
            [(e.key[:48], round(e.self_device_time_total / frames / 1e3, 4), e.count // frames)
             for e in top])


# --- phases -----------------------------------------------------------------

SOURCES = ("warp", "warp_grad")
KERNEL_NAMES = ("warp_uint8_kernel", "bilinear_sample_kernel", "warp_mesh_kernel",
                "splat_max_kernel", "splat_scatter_kernel", "splat_convert_kernel",
                "sample_map_grad_kernel")


def phase_device():
    from stabnet_tpu_torch.native import native_ops
    from stabnet_tpu_torch.ops import cuda_build

    card = card_line()
    t0 = time.perf_counter()
    cuda_build.build(SOURCES)
    for name in SOURCES:
        cuda_build.load(name)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_ops.load()
    native_s = time.perf_counter() - t0
    regs = []
    for name in SOURCES:
        with open(cuda_build.library_path(name) + ".log", errors="replace") as f:
            regs += [f"{name}: {ln.strip()}" for ln in f if "registers" in ln]
    print(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | csrc/{{{','.join(SOURCES)}}}.cu built in parallel and loaded in "
          f"{build_s:.2f} s; native/crop.cc built with g++ and loaded in {native_s:.2f} s"
          f" | {'; '.join(regs)}")
    print(f"[1 sass] instructions per kernel (cuobjdump -sass): {sass_sizes(SOURCES)}")
    return card


def sass_sizes(sources):
    """{kernel: SASS instruction count} of the built libraries, by
    `cuobjdump -sass` beside nvcc; "not available" without it."""
    from stabnet_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return "not available"
    sizes = {}
    for name in sources:
        sizes.update(sass_counts(subprocess.run(
            [tool, "-sass", cuda_build.library_path(name)],
            capture_output=True, text=True).stdout))
    return sizes


def sass_counts(sass: str) -> dict:
    """{kernel<template arguments>: instructions} of `cuobjdump -sass` text."""
    import re

    sizes = {}
    for func in sass.split("Function : ")[1:]:
        head = func.split("\n")[0]
        kernel = next((k for k in KERNEL_NAMES if k in head), head[:40])
        targs = re.search(re.escape(kernel) + r"I((?:L[ib]\d+E)+)E", head)
        if targs:   # template arguments, e.g. <3,1> for C = 3, low-res maps
            kernel += "<" + ",".join(re.findall(r"L[ib](\d+)E", targs.group(1))) + ">"
        sizes[kernel] = sum(1 for ln in func.splitlines()
                            if re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+[@A-Z]", ln))
    return sizes


def phase_k2(gen: torch.Generator, dev):
    """K2 and K2m against their plain versions, bit for bit.  Returns the
    worst max abs error of each."""
    from stabnet_tpu_torch.ops import cuda_warp, mesh_tables

    H, W = 288, 512
    worst = {"bilinear_sample": 0.0, "warp_mesh": 0.0}
    # The serving shapes, the K5 and K6 forwards' and, smaller, 5 channels.
    for S, h, w, C in ((1, H, W, 1), (4, H, W, 1), (10, H, W, 2), (20, H, W, 1),
                       (2, 72, 136, 5)):
        im = (torch.rand((S, h, w, C), generator=gen) - 0.5).to(dev)
        x_r, y_r = realistic_maps(S, h, w, gen, dev)
        x_a, y_a, kind, px = adversarial_maps(S, h, w, gen)
        for name, xm, ym in (("realistic", x_r, y_r),
                             ("adversarial", x_a.to(dev), y_a.to(dev))):
            for strict in (True, False):
                got = cuda_warp.bilinear_sample(im, xm, ym, strict_edge=strict)
                want = cuda_warp.bilinear_sample_plain(im, xm, ym, strict_edge=strict)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                worst["bilinear_sample"] = max(worst["bilinear_sample"], err)
                check(torch.equal(got, want),
                      f"K2 ({S}, {h}, {w}, {C}) {name} strict={strict}: max abs {err}")
        # The strict edge really is exercised: samples at exactly x == W-1.
        edge = torch.from_numpy((kind == 0) | (kind == 2))
        strict_out = cuda_warp.bilinear_sample(im, x_a.to(dev), y_a.to(dev))
        check(bool((strict_out[..., 0].cpu()[edge] == 0).all()),
              "K2 strict edge: a sample at x == W-1 is not 0")

    # K2m: (S, frame size, mesh zoom, stack channels last, cells negated,
    # mesh cells per side).  The wrapper runs one pixel per thread up to S=2
    # at 288 x 512 and on a channels-last stack, four beyond: each of them
    # at a ragged right edge (515 columns) and on an 8 x 8 mesh too.
    cases = [(1, (H, W), 1.0, False, False, 4), (4, (H, W), 1.0, False, False, 4),
             (6, (H, W), 1.0, False, False, 4), (2, (H, W), 1.0, True, False, 4),
             (10, (H, W), 1.0, True, False, 4), (10, (H, W), 1.2, True, False, 4),
             (1, (289, 515), 1.0, False, False, 4), (6, (289, 515), 1.0, False, False, 4),
             (2, (H, W), 1.2, False, False, 4), (2, (H, W), 1.0, False, True, 4),
             (1, (H, W), 1.0, False, False, 8), (6, (H, W), 1.0, False, False, 8),
             (6, (289, 515), 1.0, True, False, 8)]
    shares, reached = [], set()
    for S, (h, w), zoom, channels_last, negate, g in cases:
        frame = stack_frame(S, h, w, gen, dev, channels_last)
        Hs = realistic_homographies(S, gen, dev, zoom=zoom, grid=g)
        if negate:
            # -H maps as H does, through the sign guard's other branch.
            Hs[:, 1:3, 1:3] *= -1.0
        tables = mesh_tables(h, w, g, g, dev)
        got = cuda_warp.warp_mesh(frame, Hs, tables)
        want = cuda_warp.warp_mesh_plain(frame, Hs, tables)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        worst["warp_mesh"] = max(worst["warp_mesh"], err)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K2m S={S} {h}x{w} {g}x{g} zoom={zoom} negated={negate}: max abs {err}")
        pix = cuda_warp.warp_mesh_pix(S, h, w, frame.stride(2))
        reached.add((pix, w % (32 * pix) != 0, g))
        black = float(got[1].mean())
        if zoom > 1.0:
            check(0.05 < black < 0.95, f"K2m zoomed-out mesh: black share {black}")
        if negate:
            gx, gy, cc, cr = tables
            z_row = Hs[..., 2, :][:, cr.long()][:, :, cc.long()]
            Z = z_row[..., 0] * gx + z_row[..., 1] * gy[:, None] + z_row[..., 2]
            check(float((Z < 0).float().mean()) > 0.2, "K2m: no Z < 0 in the negated cells")
        shares.append(round(black, 4))
    # Every layout the wrapper picks, at a full and a ragged right edge and
    # on both mesh sizes.
    for pix in (1, 4):
        check({(pix, False, 4), (pix, True, 4)} <= reached
              and any(r[0] == pix and r[2] == 8 for r in reached),
              f"K2m at {pix} pixels per thread: layouts reached {sorted(reached)}")
    print(f"[2 K2/K2m] bilinear_sample vs plain on the card: max abs "
          f"{worst['bilinear_sample']:.3g} (tolerance 0) at (1|4, {H}, {W}, 1), "
          f"(10, {H}, {W}, 2), (20, {H}, {W}, 1) and (2, 72, 136, 5), realistic + "
          f"adversarial maps, strict_edge True/False; warp_mesh vs plain: max abs "
          f"{worst['warp_mesh']:.3g} (tolerance 0) on the output, mask and maps at "
          f"S=1/4/6 (the bench's S=6; frame read in place from the stack), S=2 and 10 "
          f"(the debug forward's batch, also zoomed out) channels-last stack, "
          f"289x515 at S=1 and 6, zoomed out, with negated cells, and on 8x8 meshes at "
          f"S=1 and 6 (black shares {shares}); (pixels per thread, ragged edge, "
          f"mesh) reached: {sorted(reached)}")
    return worst


def phase_k1(gen: torch.Generator, dev):
    """K1 and K3 against their plain versions, bit for bit: K1 on low-res
    maps, K3 on the same maps up-sampled to the frame (the coordinates K1
    computes in registers)."""
    from stabnet_tpu_torch.ops import cuda_warp, resize_bilinear_bhw

    worst = {"warp_uint8_cf_lowres": 0, "warp_uint8_cf": 0}
    # (S, frame, zoom, low-res maps): the path's 72 x 128 maps, whose row
    # pass K1 stages in shared memory, and once the model-scale 288 x 512
    # maps, too wide for that at 360 x 640.
    cases = [(1, (720, 1280), 1.0, (72, 128)), (4, (720, 1280), 1.0, (72, 128)),
             (6, (720, 1280), 1.0, (72, 128)), (1, (1080, 1920), 1.0, (72, 128)),
             (6, (1080, 1920), 1.0, (72, 128)), (1, (719, 1283), 1.0, (72, 128)),
             (2, (720, 1280), 1.15, (72, 128)), (1, (360, 640), 1.0, (288, 512))]
    for S, (Hf, Wf), zoom, lowres in cases:
        imc = torch.randint(0, 256, (S, 3, Hf, Wf), generator=gen,
                            dtype=torch.uint8).to(dev)
        xm, ym = realistic_maps(S, 288, 512, gen, dev, zoom=zoom)
        xs = resize_bilinear_bhw(xm, lowres).contiguous()
        ys = resize_bilinear_bhw(ym, lowres).contiguous()
        xf = resize_bilinear_bhw(xs, (Hf, Wf)).contiguous()
        yf = resize_bilinear_bhw(ys, (Hf, Wf)).contiguous()
        pairs = {
            "warp_uint8_cf_lowres": (cuda_warp.warp_uint8_cf_lowres(imc, xs, ys, (Hf, Wf)),
                                     cuda_warp.warp_uint8_cf_lowres_plain(imc, xs, ys, (Hf, Wf))),
            "warp_uint8_cf": (cuda_warp.warp_uint8_cf(imc, xf, yf),
                              cuda_warp.warp_uint8_cf_plain(imc, xf, yf)),
        }
        torch.cuda.synchronize()
        for name, (got, want) in pairs.items():
            err = int((got.int() - want.int()).abs().max())
            worst[name] = max(worst[name], err)
            check(got.shape == (S, Hf, Wf, 3), f"{name} shape {tuple(got.shape)}")
            check(err == 0, f"{name} S={S} {Hf}x{Wf} zoom={zoom}: max abs {err} LSB")
    print(f"[3 K1/K3] warp_uint8_cf_lowres vs plain on the card: max abs "
          f"{worst['warp_uint8_cf_lowres']} LSB, warp_uint8_cf vs plain: max abs "
          f"{worst['warp_uint8_cf']} LSB (tolerance 0 for both) at 720p S=1/4/6, 1080p S=1/6 (the bench's S=6), "
          f"719x1283, zoomed maps, and 360x640 from 288x512 maps")
    return worst


def make_clips(S: int, T: int, hw):
    from stabnet_tpu_torch.data.synthetic import make_video

    return np.stack([make_video(T, hw[0], hw[1], seed=s, jitter=4.0)
                     for s in range(S)])


def host_grays(clips: np.ndarray, cfg) -> np.ndarray:
    from stabnet_tpu_torch.stream import video_io

    return np.stack([[video_io.to_gray_train(f, cfg.height, cfg.width,
                                             cfg.crop_rate if t == 0 else 1.0)
                      for t, f in enumerate(c)] for c in clips])


def random_model(cfg, seed: int):
    from stabnet_tpu_torch.models import make_model, scale_theta_head

    return scale_theta_head(make_model(cfg, torch.Generator().manual_seed(seed)), 0.05)


def check_clip(all_black: np.ndarray, rect, what: str) -> float:
    top, left, bottom, right = rect
    check(bottom > top and right > left, f"{what}: empty crop {rect}")
    share = float((all_black > 0).mean())
    check(0.0 < share < 0.5, f"{what}: black share {share}")
    return share


def eager_steps(model, cfg, state, grays, colors, refine: int = 1):
    """`stream_step` frame by frame on the card, the eager reference of the
    graphs: grays (S, T', H, W) on the card, or None to derive them there;
    colors (S, T', Hf, Wf, 3) uint8 on the card.  Returns (warped (S, T',
    Hf, Wf, 3), state)."""
    from stabnet_tpu_torch.stream.engine import stream_step

    color_cf = colors.permute(0, 1, 4, 2, 3).contiguous()
    warped = []
    for t in range(colors.shape[1]):
        state, out = stream_step(model, state, None if grays is None else grays[:, t],
                                 color_cf[:, t], cfg, refine=refine)
        warped.append(out.warped_color)
    return torch.stack(warped, dim=1), state


def held_equal(what: str, warped, state, want_warped, want_state) -> None:
    """The graphs' frames, ring, crop accumulator and crops against the
    eager functions': torch.equal each."""
    from stabnet_tpu_torch.stream import crop_rectangle

    check(torch.equal(warped, want_warped), f"{what}: warped frames differ from eager")
    for f in ("frames", "masks", "all_black"):
        check(torch.equal(getattr(state, f), getattr(want_state, f)),
              f"{what}: {f} differs from eager")
    check(int(state.ptr) == int(want_state.ptr), f"{what}: ptr differs from eager")
    black = state.all_black.cpu().numpy()
    check([crop_rectangle(b) for b in black]
          == [crop_rectangle(b) for b in want_state.all_black.cpu().numpy()],
          f"{what}: crop differs from eager")


def phase_graphs(dev, engine, model, clips: np.ndarray, grays: np.ndarray, driver_res):
    """The serving graphs against the eager step on the card, torch.equal:
    the S=1 driver (phase 4's pipelined run) and the step loop with the
    device gray, S=4 with a prefix `valid`, S=6, and refine 2.  Returns the
    eager S=1 frames (phase 14 holds the driver's sync and pipelined runs to
    them)."""
    from stabnet_tpu_torch.stream import StreamEngine, video_io
    from stabnet_tpu_torch.stream.engine import init_state, scan_frames

    cfg, (S, T) = engine.cfg, clips.shape[:2]
    colors = torch.from_numpy(clips).to(dev)
    g = torch.from_numpy(grays).to(dev)
    first = video_io.to_gray_train(clips[0, 0], cfg.height, cfg.width, cfg.crop_rate)[None]

    # S=1, device gray: the driver's frames and a step loop's ring.
    want1, wstate1 = eager_steps(engine.model, cfg, init_state(
        torch.from_numpy(first).to(dev), cfg), None, colors[:1, 1:])
    frames1 = want1[0].cpu().numpy()
    check(np.array_equal(driver_res.frames[1:], frames1)
          and np.array_equal(driver_res.all_black, wstate1.all_black[0].cpu().numpy()),
          "S=1 driver (graphs, pipelined) differs from eager")
    state = engine.init(first)
    steps = []
    for t in range(1, T):
        state, out = engine.step(state, None, clips[None, 0, t])
        steps.append(out.warped_color)
    held_equal("S=1 step loop", torch.stack(steps, dim=1), state, want1, wstate1)

    # S=4 with a prefix validity (clips of 40, 31, 17 and 2 frames).
    valid = np.ones((S, T - 1), bool)
    for s, n in enumerate((T, 31, 17, 2)[:S]):
        valid[s, n - 1:] = False
    w4, st4 = engine.stabilize_clip(grays, clips, valid=valid)
    ww4, wst4 = scan_frames(engine.model, init_state(g[:, 0], cfg), g[:, 1:], colors[:, 1:],
                            cfg, valid=valid)
    held_equal(f"S={S} with a prefix valid", w4, st4, ww4, wst4)

    # S=6, the bench's batch, from the clips repeated.
    six = [s % S for s in range(6)]
    w6, st6 = engine.stabilize_clip(grays[six], clips[six])
    ww6, wst6 = scan_frames(engine.model, init_state(g[six, 0], cfg), g[six, 1:],
                            colors[six, 1:], cfg)
    held_equal("S=6", w6, st6, ww6, wst6)
    del w6, ww6, st6, wst6

    # Refine 2 at S=1, host gray, through the step.
    engine2 = StreamEngine(model, cfg, refine=2, device=dev)
    state = engine2.init(grays[:1, 0])
    steps = []
    for t in range(1, T):
        state, out = engine2.step(state, grays[:1, t], clips[:1, t])
        steps.append(out.warped_color)
    want2, wstate2 = eager_steps(engine2.model, cfg, init_state(g[:1, 0], cfg),
                                 g[:1, 1:], colors[:1, 1:], refine=2)
    held_equal("refine 2", torch.stack(steps, dim=1), state, want2, wstate2)
    stats = engine.graphs.stats() + engine2.graphs.stats()
    print(f"[4 graphs] v2_93 bf16 720p T={T}: the serving graphs torch.equal the eager "
          f"stream_step / scan_frames (warped frames, ring, all_black, crop) for the S=1 "
          f"driver (pipelined) and step loop with the device gray, S={S} with a prefix "
          f"valid, S=6 and refine 2 (S=1); {len(stats)} graphs, capture (and "
          f"instantiation) s / eager first call s / pool MB: "
          + "; ".join(f"{graph_label(st)} {st['capture_s']:.3f}/{st['warmup_s']:.3f}/"
                      f"{st['pool_bytes'] / 2 ** 20:.1f}" for st in stats))
    return frames1


def graph_label(st: dict) -> str:
    """A serving graph's key for a printed line: streams, gray mode, flags."""
    key = st["key"]
    if key[0] != "stream_step":
        return str(key[0])
    device_gray, override, valid = key[-3:]
    return (f"S={st['shapes'][0][0]} refine {key[2]}" + (" device-gray" if device_gray else "")
            + (" override" if override else "") + (" valid" if valid else ""))


def phase_path(clips: np.ndarray, dev):
    """The main path: v2_93 bf16 at 720p, S=1 through StreamDriver and S=4
    through StreamEngine.stabilize_clip; launch counts read around each."""
    from stabnet_tpu_torch.config import V2_93
    from stabnet_tpu_torch.ops import cuda_warp
    from stabnet_tpu_torch.stream import (DeployOptions, StreamDriver, StreamEngine,
                                          crop_rectangle)

    cfg = V2_93
    model = random_model(cfg, 0)
    refine = 1
    T = clips.shape[1]
    engine = StreamEngine(model, cfg, refine=refine, device=dev)
    driver = StreamDriver(engine, DeployOptions(refine=refine, device_gray=True))

    expected = {"bilinear_sample": 0, "warp_mesh": refine * (T - 1),
                "warp_uint8_cf_lowres": T - 1, "warp_uint8_cf": 0, "bilinear_splat": 0,
                "sample_map_grad": 0}
    cuda_warp.reset_launch_counts()
    res = driver.stabilize_clip(clips[0])
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == expected, f"S=1 launches {launches}, expected {expected}")
    check(res.frames.shape == (T,) + CLIP_HW + (3,) and res.frames.dtype == np.uint8,
          f"S=1 frames {res.frames.shape} {res.frames.dtype}")
    share1 = check_clip(res.all_black, res.crop_rect, "S=1")

    S = clips.shape[0]
    grays = host_grays(clips, cfg)
    cuda_warp.reset_launch_counts()
    warped, state = engine.stabilize_clip(grays, clips)
    torch.cuda.synchronize()
    launches4 = launch_counts()
    check(launches4 == expected, f"S={S} launches {launches4}, expected {expected}")
    check(tuple(warped.shape) == (S, T - 1) + CLIP_HW + (3,)
          and warped.dtype == torch.uint8, f"S={S} warped {tuple(warped.shape)}")
    warped_np = warped.cpu().numpy()
    all_black = state.all_black.cpu().numpy()
    check(warped_np.reshape(S, T - 1, -1).std(-1).min() > 0, "blank output frame")
    shares = [check_clip(all_black[s], crop_rectangle(all_black[s]),
                         f"S={S} stream {s}") for s in range(S)]
    print(f"[4 path] v2_93 bf16 720p T={T}: S=1 StreamDriver launches {launches}, "
          f"crop {res.crop_rect}, black share {share1:.4f}; S={S} "
          f"StreamEngine.stabilize_clip launches {launches4}, black shares "
          f"{[round(s, 4) for s in shares]} (one graph replay per frame, the first "
          f"frame of each signature eager)")
    eager1 = phase_graphs(dev, engine, model, clips, grays, res)
    return engine, driver, grays, launches, eager1


def phase_card_vs_cpu(clips: np.ndarray, dev, T: int = 8):
    """f32 end to end, card (kernels) against CPU (plain versions)."""
    from stabnet_tpu_torch.config import V2_93
    from stabnet_tpu_torch.stream import StreamEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = V2_93.replace(compute_dtype="float32")
    cpu_model = random_model(cfg, 1)
    gpu_model = copy.deepcopy(cpu_model)
    clip = clips[:1, :T]
    grays = host_grays(clip, cfg)
    outs = {}
    for name, model, device in (("card", gpu_model, dev), ("cpu", cpu_model, "cpu")):
        engine = StreamEngine(model, cfg, device=device)
        state = engine.init(grays[:, 0])
        frames, xmaps = [], []
        for t in range(1, T):
            state, out = engine.step(state, grays[:, t], clip[:, t])
            frames.append(out.warped_color[0].cpu().numpy())
            xmaps.append(out.x_map[0].cpu().numpy())
        outs[name] = (np.stack(frames), state.all_black[0].cpu().numpy(),
                      np.stack(xmaps))
    (fg, bg, xg), (fc, bc, xc) = outs["card"], outs["cpu"]
    diff = np.abs(fg.astype(np.int32) - fc.astype(np.int32))
    within1 = float((diff <= 1).mean())
    black_diff = int((bg != bc).sum())
    print(f"[5 card vs cpu] v2_93 f32, TF32 off, {T} frames 720p: warped_color "
          f"within 1 LSB on {within1 * 100:.4f}% of pixels (need >= 99.9), max "
          f"{int(diff.max())} LSB (need <= 2), pixels > 2 LSB {int((diff > 2).sum())}; "
          f"all_black differs at {black_diff} pixels (need 0); x_map max abs "
          f"diff {float(np.abs(xg - xc).max()):.3g}")
    check(within1 >= 0.999 and diff.max() <= 2 and black_diff == 0,
          "card and CPU disagree")
    torch.backends.cudnn.allow_tf32 = True


def phase_times(card: str, gen: torch.Generator, dev, engine, driver, clips,
                grays, launches, errs):
    """Kernel, plain-version and library times at the path's shapes, and the
    path's own time, frame rate and device busy time.  Returns the rows of
    K2m, K1 and K3 for the kernels line, and K2's timings at S=1 and S=4."""
    from stabnet_tpu_torch.ops import (black_mask, cuda_warp, dense_maps, mesh_tables,
                                       resize_bilinear_bhw)

    bw, f32_peak = peaks(torch.cuda.get_device_name(0))
    H, W = 288, 512
    timed = {}

    def record(name, label, kern, plain, lib, nbytes, ops, plain_reps=50, chain=None,
               floor=None):
        t = {"ms": device_ms(kern), "plain_ms": device_ms(plain, calls=5, reps=plain_reps),
             "library_ms": device_ms(lib) if lib else None, "call_ms": call_ms(kern)}
        t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_peak * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        extra = ""
        if chain is not None:
            t["chain_ms"], t["chain_call_ms"] = device_ms(chain), call_ms(chain)
            extra = (f", the unfused chain it replaces {t['chain_ms']:.5f} ms device "
                     f"({t['chain_call_ms']:.5f} ms per call from the host)")
        if floor is not None:
            t["floor_ms"] = device_ms(floor)
            extra += f", an empty kernel at its grid {t['floor_ms']:.5f} ms device"
        timed[(name, label)] = t
        lib_txt = "none" if lib is None else f"{t['library_ms']:.5f} ms"
        print(f"[6 times {name} {label}] {card} | kernel {t['ms']:.5f} ms device "
              f"({t['call_ms']:.5f} ms per call from the host), plain "
              f"{t['plain_ms']:.5f} ms, library {lib_txt}, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({nbytes} B, {t['bound_by']}){extra}")

    # Bytes: each input read once, each output written once.  f32 operations
    # per output pixel, counted in csrc/warp.cu: the coordinates take 24
    # (ndc_to_pixel 2 x 2, floor 2, corner + 1 2, clamps 8, distances 4,
    # weights 4) and each channel's taps 7 (4 mul, 3 add); K1 adds the map
    # up-sample, 2 x 9 (upsample_tap: 6 mul, 3 add), and 3 per channel
    # (round, clip).  K2 here has C = 1, K1 and K3 have C = 3.
    for S in (1, 4):
        im = (torch.rand((S, H, W, 1), generator=gen) - 0.5).to(dev)
        xm, ym = realistic_maps(S, H, W, gen, dev)
        grid = torch.stack([xm + 1.0 / W, ym + 1.0 / H], dim=-1)
        im_nchw = im.permute(0, 3, 1, 2)
        record("bilinear_sample", f"S={S}",
               lambda: cuda_warp.bilinear_sample(im, xm, ym),
               lambda: cuda_warp.bilinear_sample_plain(im, xm, ym),
               lambda: F.grid_sample(im_nchw, grid, mode="bilinear",
                                     padding_mode="zeros", align_corners=False),
               4 * (3 * xm.numel() + im.numel()), (24 + 7) * xm.numel())
    # K2m on the path's inputs: the stack's current frame, in place, and the
    # cell homographies, at S=1 (online), 4 (the serving clip), 6 (the
    # bench's batch) and 10 (the debug forward's batch, channels last);
    # beside it an empty kernel at the grid it launches, and at S=1 and 4
    # the chain it replaces, as the parent's `transformer` ran it after the
    # solve.  Bytes: the frame, the output, the mask and both maps, the
    # homographies and the four tables.  f32 operations per pixel: the map
    # 3 x 4 (2 mul, 2 add), the sign guard 2 (compare, add), 2 divides, the
    # mask's 4 compares, then K2's 24 + 7.
    for S in (1, 4, 6, 10):
        frame = stack_frame(S, H, W, gen, dev, channels_last=S == 10)
        Hs = realistic_homographies(S, gen, dev)
        tables = mesh_tables(H, W, 4, 4, dev)

        def chain():
            x_map, y_map = dense_maps(Hs, H, W)
            return (cuda_warp.bilinear_sample(frame.contiguous(), x_map.contiguous(),
                                              y_map.contiguous()),
                    black_mask(x_map, y_map))

        n = S * H * W
        pix = cuda_warp.warp_mesh_pix(S, H, W, frame.stride(2))
        record("warp_mesh", f"S={S}",
               lambda: cuda_warp.warp_mesh(frame, Hs, tables),
               lambda: cuda_warp.warp_mesh_plain(frame, Hs, tables), None,
               4 * (5 * n + Hs.numel() + 2 * (H + W)), (12 + 2 + 2 + 4 + 24 + 7) * n,
               plain_reps=50 if S == 1 else 10, chain=chain if S <= 4 else None,
               floor=lambda: cuda_warp.empty_launch(S, H, W, pix, dev))
    # The color warps at the serving shapes (the clip's frames at 720p, a
    # random frame at 1080p): K1 from the model-scale maps' 4x-down
    # resize, K3 from those maps up-sampled to the frame.
    # The plain versions repeat the kernels' arithmetic and are no yardstick
    # of speed: away from the main shape, 10 replays of 5 calls time them.
    # K1 also at the bench's batch, S=6 at 720p and 1080p (K3, on no path,
    # not there).
    for label, S, (Hf, Wf), plain_reps in (("S=1 720p", 1, CLIP_HW, 50),
                                           ("S=4 720p", 4, CLIP_HW, 10),
                                           ("S=1 1080p", 1, (1080, 1920), 10),
                                           ("S=6 720p", 6, CLIP_HW, 10),
                                           ("S=6 1080p", 6, (1080, 1920), 10)):
        if (Hf, Wf) == CLIP_HW and S <= clips.shape[0]:
            imc = torch.from_numpy(clips[:S, 1]).permute(0, 3, 1, 2).contiguous().to(dev)
        else:
            imc = torch.randint(0, 256, (S, 3, Hf, Wf), generator=gen,
                                dtype=torch.uint8).to(dev)
        xm, ym = realistic_maps(S, H, W, gen, dev)
        xs = resize_bilinear_bhw(xm, (H // 4, W // 4)).contiguous()
        ys = resize_bilinear_bhw(ym, (H // 4, W // 4)).contiguous()
        xf = resize_bilinear_bhw(xs, (Hf, Wf)).contiguous()
        yf = resize_bilinear_bhw(ys, (Hf, Wf)).contiguous()
        n_out = S * Hf * Wf
        record("warp_uint8_cf_lowres", label,
               lambda: cuda_warp.warp_uint8_cf_lowres(imc, xs, ys, (Hf, Wf)),
               lambda: cuda_warp.warp_uint8_cf_lowres_plain(imc, xs, ys, (Hf, Wf)),
               None, 8 * xs.numel() + imc.numel() + 3 * n_out,
               (18 + 24 + 10 * 3) * n_out, plain_reps)
        if S < 6:
            record("warp_uint8_cf", label,
                   lambda: cuda_warp.warp_uint8_cf(imc, xf, yf),
                   lambda: cuda_warp.warp_uint8_cf_plain(imc, xf, yf),
                   None, 8 * xf.numel() + imc.numel() + 3 * n_out, (24 + 10 * 3) * n_out,
                   plain_reps)

    T = clips.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = driver.stabilize_clip(clips[0])
    clip_ms = (time.perf_counter() - t0) / (T - 1) * 1e3
    st = res.stage_summary
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warped, _ = engine.stabilize_clip(grays, clips)
    torch.cuda.synchronize()
    S = clips.shape[0]
    s4_fps = S * (T - 1) / (time.perf_counter() - t0)
    del warped
    prof = [(mode, profile_path(engine, clips[0], eager=mode == "eager"))
            for mode in ("graph", "eager", "graph")]
    print(f"[6 times path] {card} | v2_93 bf16 720p: S=1 StreamDriver "
          f"{st['net']['p50_ms']:.3f} ms/frame p50 of dispatch + readback "
          f"(p95 {st['net']['p95_ms']:.3f}; dispatch p50 "
          f"{st['dispatch']['p50_ms']:.3f}, readback p50 "
          f"{st['readback']['p50_ms']:.3f}), {clip_ms:.3f} ms/frame over the "
          f"whole clip incl. crop; S={S} StreamEngine.stabilize_clip "
          f"{s4_fps:.2f} frames/s (upload included)")
    for mode, (wall, p50, wall_prof, busy, ops, host, per_frame, top) in prof:
        print(f"[6 profile S=1 {mode}] {card} | wall {wall:.3f} ms/frame mean, p50 "
              f"{p50:.3f} unprofiled ({wall_prof:.3f} under the profiler), kernels "
              f"{busy:.3f} ms/frame, device idle {100 * (1 - busy / wall):.1f}% of the "
              f"unprofiled wall, {ops:.2f} device operations (kernels, copies, fills, "
              f"in a graph or not) and {host:.2f} host launches (runtime calls queueing "
              f"device work) per frame, per frame in the trace {per_frame}, top kernels "
              f"(name, ms/frame, launches/frame): {top}")
    for mode, res in prof:
        check(res[6] == {"warp_mesh_kernel": 1.0, "warp_uint8_kernel": 1.0},
              f"the profiled {mode} steps show K2m and K1 {res[6]} per frame")
    rows = [kernel_row(name, replaces, launches[name], errs[name], timed, label)
            for name, label, replaces in (
                ("warp_mesh", "S=1", "stabnet_tpu/ops/pallas_warp.py:469"),
                ("warp_uint8_cf_lowres", "S=1 720p", "stabnet_tpu/ops/pallas_warp.py:575"),
                ("warp_uint8_cf", "S=1 720p", "stabnet_tpu/ops/pallas_warp.py:524"))]
    return rows, {k: v for k, v in timed.items() if k[0] == "bilinear_sample"}


def kernel_row(name, replaces, launches, err, timed, label, source="warp.cu"):
    """One kernel's entry of the kernels line: its numbers at `label`, those
    at its other timed shapes under "other_shapes"."""
    t = timed[(name, label)]
    others = [{"shape": lab, **{k: v for k, v in tt.items() if k != "call_ms"}}
              for (n, lab), tt in timed.items() if n == name and lab != label]
    return {"name": name, "route": "cuda", "source": f"stabnet_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "call_ms": t["call_ms"],
            **{k: t[k] for k in ("chain_ms", "chain_call_ms", "floor_ms", "passes",
                                 "flow_maps_ms") if k in t},
            "shape": label, "other_shapes": others}


# --- the training path ------------------------------------------------------

TRAIN_LIVE = ["--set", "do_temp_loss_iter=0", "--set", "do_black_loss_iter=0",
              "--set", "do_theta_only_iter=-1"]


def live_config(**kw):
    """v2_93 with every loss term live from step 0 (as TRAIN_LIVE sets)."""
    from stabnet_tpu_torch.config import V2_93

    return V2_93.replace(do_temp_loss_iter=0, do_black_loss_iter=0,
                         do_theta_only_iter=-1, **kw)


def flow_maps(S: int, H: int, W: int, gen: torch.Generator, device, amp: float = 3.0):
    """Near-identity NDC maps: the pixel grid displaced by a smooth random
    field of up to `amp` pixels, as the temporal loss's flow maps are."""
    from stabnet_tpu_torch.ops import resize_bilinear_bhw

    d = amp * (2 * torch.rand((2, S, 5, 9), generator=gen) - 1)
    dx, dy = (resize_bilinear_bhw(v, (H, W)) for v in d)
    px = torch.arange(W, dtype=torch.float32) + 0.5 + dx
    py = torch.arange(H, dtype=torch.float32)[:, None] + 0.5 + dy
    return ((px * (2.0 / W) - 1.0).contiguous().to(device),
            (py * (2.0 / H) - 1.0).contiguous().to(device))


# csrc/warp_grad.cu pass 2: 32 x 32 output tiles, a shared-memory window of
# at most 4096 elements (taps' bounding box times the channels).
SPLAT_TILE, SPLAT_WIN = 32, 4096


def splat_tiles_fitting(xm: torch.Tensor, ym: torch.Tensor, H: int, W: int, C: int) -> float:
    """The share of K4's pass-2 tiles whose tap window fits shared memory, by
    the kernel's rule (maps of tile-multiple size)."""
    B, Ho, Wo = xm.shape
    corners = []
    for m, n in ((xm, W), (ym, H)):
        lo = torch.floor((m + 1.0) * (n / 2.0))
        corners += [lo.clamp(0, n - 1), (lo + 1.0).clamp(0, n - 1)]

    def tiles(t, reduce):
        t = t.reshape(B, Ho // SPLAT_TILE, SPLAT_TILE, Wo // SPLAT_TILE, SPLAT_TILE)
        return reduce(reduce(t, dim=4), dim=2)

    amin = lambda t, dim: t.amin(dim=dim)
    amax = lambda t, dim: t.amax(dim=dim)
    ww = tiles(corners[1], amax) - tiles(corners[0], amin) + 1
    wh = tiles(corners[3], amax) - tiles(corners[2], amin) + 1
    return float(((ww * wh * C) <= SPLAT_WIN).float().mean())


def phase_grad_kernels(gen: torch.Generator, dev) -> dict:
    """K4 and K6b against their plain versions (bit for bit: both are
    deterministic), and K5/K6 through autograd against the kernels.  K4 runs
    on flow-like maps (every pass-2 tile sums in shared memory), adversarial
    maps (no tile does), half of each, and the mesh maps."""
    from stabnet_tpu_torch.ops import cuda_warp

    H, W = 288, 512
    worst = {"bilinear_splat": 0.0, "sample_map_grad": 0.0}
    fitting = {}
    for name, B, C in (("bilinear_splat", 1, 2), ("bilinear_splat", 10, 2),
                       ("sample_map_grad", 2, 1), ("sample_map_grad", 20, 1)):
        x_r, y_r = realistic_maps(B, H, W, gen, dev)
        x_a, y_a, kind, _ = adversarial_maps(B, H, W, gen)
        x_a, y_a = x_a.to(dev), y_a.to(dev)
        cases = [("realistic", x_r, y_r), ("adversarial", x_a, y_a)]
        if name == "bilinear_splat":
            x_f, y_f = flow_maps(B, H, W, gen, dev)
            half = torch.arange(W, device=dev) < W // 2
            cases += [("flow", x_f, y_f),
                      ("half flow, half adversarial", torch.where(half, x_f, x_a),
                       torch.where(half, y_f, y_a))]
        for maps, xm, ym in cases:
            g = (torch.rand((B, H, W, C), generator=gen) - 0.5).to(dev)
            if name == "bilinear_splat":
                fitting[maps] = splat_tiles_fitting(xm, ym, H, W, C)
                got = cuda_warp.bilinear_splat(g, xm, ym, (H, W))
                again = cuda_warp.bilinear_splat(g, xm, ym, (H, W))
                want = cuda_warp.bilinear_splat_plain(g, xm, ym, (H, W))
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"K4 B={B} {maps}: two runs differ")
                err = float((got - want).abs().max())
            else:
                im = (torch.rand((B, H, W, C), generator=gen) - 0.5).to(dev)
                got = cuda_warp.sample_map_grad(im, xm, ym, g)
                want = cuda_warp.sample_map_grad_plain(im, xm, ym, g)
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            check(math.isfinite(err) and err == 0.0,
                  f"{name} B={B} {maps}: max abs {err} against the plain version")
            worst[name] = max(worst[name], err)
    check(fitting["flow"] == 1.0 and fitting["adversarial"] == 0.0
          and fitting["half flow, half adversarial"] == 0.5,
          f"K4 maps do not drive both pass-2 branches as intended: {fitting}")

    # The autograd Functions route their backward through the kernels.
    B, C = 2, 2
    xm, ym = realistic_maps(B, H, W, gen, dev)
    g = (torch.rand((B, H, W, C), generator=gen) - 0.5).to(dev)
    im = torch.rand((B, H, W, C), generator=gen).to(dev).requires_grad_()
    (cuda_warp.bilinear_sample_const_maps(im, xm, ym) * g).sum().backward()
    check(torch.equal(im.grad, cuda_warp.bilinear_splat(g, xm, ym, (H, W))),
          "K5 backward is not K4")
    xr, yr = xm.clone().requires_grad_(), ym.clone().requires_grad_()
    im1 = im.detach()[..., :1].contiguous()
    (cuda_warp.bilinear_sample_const_image(im1, xr, yr) * g[..., :1]).sum().backward()
    gx, gy = cuda_warp.sample_map_grad(im1, xm, ym, g[..., :1].contiguous())
    check(torch.equal(xr.grad, gx) and torch.equal(yr.grad, gy),
          "K6 backward is not K6b")
    print(f"[7 K4/K6b] bilinear_splat vs plain on the card: max abs "
          f"{worst['bilinear_splat']:.3g} (tolerance 0: deterministic fixed-point "
          f"sums; two runs equal) at (1|10, {H}, {W}, 2) on realistic, adversarial, "
          f"flow and half-flow maps (share of pass-2 tiles summed in shared memory "
          f"at B=10: { {k: round(v, 4) for k, v in fitting.items()} }); "
          f"sample_map_grad vs plain: max abs {worst['sample_map_grad']:.3g} "
          f"(tolerance 0) at (2|20, {H}, {W}, 1), realistic + adversarial maps; "
          f"K5/K6 autograd backward == K4/K6b")
    return worst


def make_shards(tmp: str) -> str:
    """`make-synthetic` of 20 v2_93 examples through the port's CLI into
    `tmp`/data/train; returns `tmp`/data."""
    from stabnet_tpu_torch.cli.main import main as cli

    data = os.path.join(tmp, "data")
    cli(["make-synthetic", "--out", os.path.join(data, "train"), "--num", "20",
         "--config", "v2_93", "--seed", "0"])
    return data


def phase_train_path(tmp: str):
    """`make-synthetic` + `train` through the port's CLI at v2_93 bf16,
    batch 10: 4 steps, then --restore to step 6."""
    from stabnet_tpu_torch.cli.main import main as cli
    from stabnet_tpu_torch.models import make_model
    from stabnet_tpu_torch.ops import cuda_warp
    from stabnet_tpu_torch.train import checkpoint as ckpt

    model_dir, log_dir = os.path.join(tmp, "models"), os.path.join(tmp, "log")
    t0 = time.perf_counter()
    data = make_shards(tmp)
    make_s = time.perf_counter() - t0
    base = ["train", "--config", "v2_93", "--data", data, "--model-dir", model_dir,
            "--log-dir", log_dir, "--seed", "0", "--set", "disp_freq=1", *TRAIN_LIVE]
    done, segments = 0, []
    for steps, extra in ((4, []), (6, ["--restore"])):
        n = steps - done
        expected = {"bilinear_sample": 2 * n, "warp_mesh": 0, "warp_uint8_cf_lowres": 0,
                    "warp_uint8_cf": 0, "bilinear_splat": n, "sample_map_grad": n}
        cuda_warp.reset_launch_counts()
        t0 = time.perf_counter()
        with IterTimes() as walls:
            cli(base + ["--steps", str(steps)] + extra)
        torch.cuda.synchronize()
        launches = launch_counts()
        check(launches == expected,
              f"train to step {steps}: launches {launches}, expected {expected}")
        segments.append((steps, launches, time.perf_counter() - t0, walls.ms()))
        done = steps
    check(ckpt.latest_step(model_dir) == 6, f"latest checkpoint {ckpt.latest_step(model_dir)}")

    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if r["tag"] == "train"]
    check([r["step"] for r in train_rows] == list(range(6)),
          f"metrics steps {[r['step'] for r in train_rows]}")
    bad = [(r["step"], k) for r in train_rows for k, v in r.items()
           if k not in ("step", "tag") and not math.isfinite(v)]
    check(not bad, f"non-finite logged losses {bad}")

    init = make_model(live_config(), torch.Generator().manual_seed(0)).state_dict()
    final = torch.load(os.path.join(model_dir, "6", "state.pt"), map_location="cpu",
                       weights_only=True)
    check(final["step"] == 6, f"checkpoint step {final['step']}")
    changed = {k: bool((final["model"][k].float() != v.float()).any())
               for k, v in init.items()}
    weights = [k for k in init if k.endswith(".weight")]
    stats = [k for k in init if k.endswith(("running_mean", "running_var"))]
    check(all(changed[k] for k in weights), "a weight did not change in 6 steps: "
          f"{[k for k in weights if not changed[k]][:5]}")
    check(all(changed[k] for k in stats), "a BN running statistic did not change")
    print(f"[8 train path] v2_93 bf16 batch 10 through the CLI: make-synthetic 20 "
          f"examples in {make_s:.1f} s; " + "; ".join(
              f"train to step {st} in {sec:.1f} s, launches {ln}, ms per iteration after "
              f"the first {ms}" for st, ln, sec, ms in segments)
          + f"; checkpoint at step 6; metrics.jsonl steps 0-5, all losses finite "
          f"(step 0 total {train_rows[0]['total']:.6g}, step 5 total "
          f"{train_rows[5]['total']:.6g}); {sum(changed[k] for k in weights)}/"
          f"{len(weights)} weights and {sum(changed[k] for k in stats)}/{len(stats)} "
          f"BN statistics changed; loop stages at steps 1-5 (data_ms, step_ms): "
          f"{[(round(r['data_ms'], 3), round(r['step_ms'], 3)) for r in train_rows[1:]]}")
    return segments[0][1], data


def phase_train_card_vs_cpu(dev):
    """One v2_93 training step in f32 (TF32 off), batch 2, from the same
    weights and the same augmented batch: card (kernels) against CPU (plain
    versions under autograd).  The CPU step is also run on an input changed
    by 1e-7 relative noise, to show how far rounding alone moves the
    gradients."""
    from stabnet_tpu_torch.data import augment_batch, make_raw_batch, prepare_raw
    from stabnet_tpu_torch.models import make_model, scale_theta_head
    from stabnet_tpu_torch.train import compute_losses, loss_gates

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = live_config(compute_dtype="float32", batch_size=2)
    raw = prepare_raw(make_raw_batch(cfg, 2, seed=5))
    batch = augment_batch(torch.Generator().manual_seed(5),
                          {k: torch.from_numpy(v) for k, v in raw.items()}, cfg)
    noisy = dict(batch)
    noise = torch.randn(batch["x1"].shape, generator=torch.Generator().manual_seed(6))
    noisy["x1"] = batch["x1"] * (1.0 + 1e-7 * noise)
    model0 = scale_theta_head(make_model(cfg, torch.Generator().manual_seed(1)), 0.05)
    res, theta = {}, {}

    def keep_theta(name):
        def hook(module, inputs, out):
            out.retain_grad()
            theta[name] = out
        return hook

    for name, b, device in (("card", batch, dev), ("cpu", batch, "cpu"),
                            ("cpu noisy", noisy, "cpu")):
        model = copy.deepcopy(model0).to(device).train()
        model.head.out.register_forward_hook(keep_theta(name))
        total, aux = compute_losses(model, {k: v.to(device) for k, v in b.items()},
                                    cfg, loss_gates(0, cfg))
        total.backward()
        res[name] = ({k: float(v.detach()) for k, v in aux.items()},
                     {k: p.grad.cpu() for k, p in model.named_parameters()},
                     {k: b.cpu() for k, b in model.named_buffers()})
    torch.backends.cudnn.allow_tf32 = True
    (ac, gcard, bc), (ap, gp, bp), (_, gn, _) = res["card"], res["cpu"], res["cpu noisy"]
    tg = {k: v.grad.cpu() for k, v in theta.items()}
    tmax = float(tg["cpu"].abs().max())
    theta_rel = float((tg["card"] - tg["cpu"]).abs().max()) / tmax
    theta_spread = float((tg["cpu noisy"] - tg["cpu"]).abs().max()) / tmax
    loss_rel = {k: abs(ac[k] - ap[k]) / max(abs(ap[k]), 1e-30) for k in ap}
    bn_abs = max(float((bc[k] - bp[k]).abs().max()) for k in bp)
    # The backward is discontinuous in the activations (ReLU, max-pool), so
    # rounding alone moves the trunk's weight gradients by up to ~1 % of the
    # largest gradient, and a leaf whose exact gradient is ~0 (a conv bias
    # under a BatchNorm) by more than its own maximum: the "cpu noisy" run,
    # the same CPU step on an input changed by 1e-7, shows how far.  The
    # kernels feed d total / d theta and the head, which are continuous and
    # are held to 1e-3 of their max; the trunk's gradients are held to the
    # larger of 1e-3 of the largest gradient and 3x the CPU's own spread.
    gmax = max(float(v.abs().max()) for v in gp.values())
    diff = {k: float((gcard[k] - gp[k]).abs().max()) for k in gp}
    spread = max(float((gn[k] - gp[k]).abs().max()) for k in gp)
    head = {k: diff[k] / float(gp[k].abs().max()) for k in gp if k.startswith("head.out")}
    wl, wg, wh = (max(d, key=d.get) for d in (loss_rel, diff, head))
    print(f"[9 train card vs cpu] v2_93 f32, TF32 off, batch 2, one step from the "
          f"same weights and batch: worst loss term {wl} rel {loss_rel[wl]:.3g} "
          f"(need <= 1e-4); d total / d theta {theta_rel:.3g} of its max {tmax:.4g} "
          f"(need <= 1e-3; CPU alone, 1e-7 input noise: {theta_spread:.3g}); worst "
          f"head gradient {wh} {head[wh]:.3g} of its max (need <= 1e-3); worst "
          f"gradient {wg} off by {diff[wg] / gmax:.3g} of the largest gradient "
          f"{gmax:.4g} (need <= max(1e-3, 3x the CPU's own spread "
          f"{spread / gmax:.3g})); BN running statistics max abs {bn_abs:.3g} "
          f"(need <= 1e-5); total {ap['total']:.8g} (cpu) {ac['total']:.8g} (card)")
    check(loss_rel[wl] <= 1e-4 and theta_rel <= 1e-3 and head[wh] <= 1e-3
          and diff[wg] <= max(1e-3 * gmax, 3 * spread) and bn_abs <= 1e-5,
          "card and CPU disagree on the training step")


# Six steps that cross every loss gate (theta-only at 0-1, black from 2,
# temporal from 3) and a learning-rate step (at 4).
GATE_CROSSING = dict(do_theta_only_iter=1, do_black_loss_iter=2, do_temp_loss_iter=3,
                     step_size=4)


def train_run(cfg, batches, dev, compiled: bool):
    """Six steps from one seeded state, eager (`train_step`) or compiled
    (`make_train_step`: one captured graph replayed): per step the loss
    terms, the model's state_dict and Adam's moments, and the state."""
    from stabnet_tpu_torch.train import Adam, TrainState, make_train_step, train_step

    model = random_model(cfg, 3).to(dev).train()
    state = TrainState(step=0, model=model, opt=Adam(model.parameters()))
    step = make_train_step(cfg) if compiled else (lambda s, b: train_step(s, b, cfg))
    out = []
    for b in batches:
        state, aux = step(state, b)
        out.append(({k: v.clone() for k, v in aux.items()},
                    {k: v.clone() for k, v in state.model.state_dict().items()},
                    [t.clone() for t in state.opt.mu + state.opt.nu]))
    torch.cuda.synchronize()
    return out, state


def run_gap(a, b) -> dict:
    """The largest gap between two `train_run`s: loss terms relative,
    parameters and statistics absolute, moments absolute; 0 if equal."""
    loss = max(abs(float(x[k]) - float(y[k])) / max(abs(float(y[k])), 1e-30)
               for (x, _, _), (y, _, _) in zip(a, b) for k in x)
    params = max(float((x[k] - y[k]).abs().max()) for (_, x, _), (_, y, _) in zip(a, b)
                 for k in x)
    moments = max(float((x - y).abs().max()) for (_, _, xs), (_, _, ys) in zip(a, b)
                  for x, y in zip(xs, ys))
    return {"loss_rel": loss, "params_abs": params, "moments_abs": moments}


def train_graph_run(dev, eager_spread: bool = True):
    """The compiled training step against the eager one: v2_93 f32, batch
    2, six steps across every gate and a learning-rate step from one seeded
    state, exactly one captured training graph, K2 2, K4 1 and K6b 1 per
    replayed step.  The rule: if two eager runs are torch.equal, the graph
    must equal the eager run; else both run under cuDNN's and torch's
    deterministic algorithms and must be equal there, the default mode's
    eager spread reported beside; where deterministic mode cannot run an
    operation, the graph is held to 3x the eager spread.  Without
    `eager_spread` the two default-mode eager runs are skipped and the rule
    is the deterministic one.  Returns a summary (its "problems" empty if
    every check held), the graph run's state, the config and the
    batches."""
    from stabnet_tpu_torch.data import augment_batch, make_raw_batch, prepare_raw

    cfg = live_config(compute_dtype="float32", batch_size=2).replace(**GATE_CROSSING)
    batches = [augment_batch(torch.Generator().manual_seed(s),
                             {k: torch.from_numpy(v).to(dev) for k, v in
                              prepare_raw(make_raw_batch(cfg, 2, seed=s)).items()}, cfg)
               for s in range(6)]
    e1, spread, rule = None, None, "deterministic"
    if eager_spread:
        e1, _ = train_run(cfg, batches, dev, compiled=False)
        e2, _ = train_run(cfg, batches, dev, compiled=False)
        spread = run_gap(e1, e2)
        rule = "equal" if not any(spread.values()) else "deterministic"
    if rule == "deterministic":
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
        try:
            eager, _ = train_run(cfg, batches, dev, compiled=False)
        except RuntimeError as e:
            if e1 is None:
                raise
            print(f"[9 train graph] deterministic mode refused an operation: {e}")
            rule, eager = "3x spread", e1
        finally:
            torch.backends.cudnn.deterministic = False
            torch.use_deterministic_algorithms(False)
    else:
        eager = e1
    if rule == "deterministic":
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
    before = launch_counts()
    try:
        graph, state = train_run(cfg, batches, dev, compiled=True)
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    gap = run_gap(graph, eager)
    if rule == "3x spread":
        ok = all(gap[k] <= 3 * spread[k] for k in gap)
    else:
        ok = not any(gap.values())
    stats = [{k: v for k, v in st.items() if k not in ("key", "shapes")}
             for st in state.graphs.stats()]
    want = {"bilinear_sample": 12, "warp_mesh": 0, "warp_uint8_cf_lowres": 0,
            "warp_uint8_cf": 0, "bilinear_splat": 6, "sample_map_grad": 6}
    counters = (state.step, int(state.step_t), state.opt.count, int(state.opt.count_t))
    problems = []
    if not ok:
        problems.append(f"the training graph and the eager step differ under rule {rule!r}: "
                        f"{gap}")
    if not (len(stats) == 1 and stats[0]["replays"] == 5):
        problems.append(f"training graphs {stats}")
    if launches != want:
        problems.append(f"graph launches {launches}, expected {want}")
    if counters != (6, 6, 6, 6):
        problems.append(f"counters {counters}")
    summary = {"rule": rule, "spread": spread, "gap": gap, "graph": stats[0],
               "launches": launches, "counters": counters,
               "temps": [float(graph[0][0]["temp"]), float(graph[-1][0]["temp"])],
               "problems": problems}
    return summary, state, cfg, batches


def phase_train_graph(card: str, dev):
    """`train_graph_run` in this process (no process group)."""
    r, _, _, _ = train_graph_run(dev)
    st = r["graph"]
    print(f"[9 train graph] {card} | v2_93 f32 batch 2, 6 steps across every gate "
          f"(temp {r['temps'][0]:.3g} at step 0, {r['temps'][1]:.6g} at 5) and a "
          f"learning-rate step: rule {r['rule']!r} (default-mode eager against eager: "
          f"{r['spread']}); graph against eager {r['gap']}; 1 training graph, "
          f"{st['replays']} replays, eager first call {st['warmup_s']:.3f} s, capture "
          f"{st['capture_s']:.3f} s, pool {st['pool_bytes']} B; launches {r['launches']}; "
          f"counters step/step_t/count/count_t {r['counters']}")
    check(not r["problems"], "; ".join(r["problems"]))
    return r["rule"]


def profile_steps(step, steps: int = 3):
    """Wall time per call of `step` (synchronized) without and with the
    profiler, and under it per call: the summed kernel time, the device
    operations and the host launches (`profile_counts`), and the top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    wall = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    ops, busy, host, kernels = profile_counts(prof, steps)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return wall, wall_prof, busy, ops, host, [
        (e.key[:48], round(e.self_device_time_total / steps / 1e3, 3), e.count // steps)
        for e in top]


def kernel_passes(fn, calls: int = 20):
    """Device time per call of each kernel that `fn` launches, under
    torch.profiler: [(short name, ms per call)], in launch order."""
    import re

    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"(splat_\w+_kernel|Fill\w*<\w+>)", e.key)
        out.append((m.group(1) if m else e.key[:40], e.self_device_time_total / calls / 1e3))
    return out


def phase_train_times(card: str, gen: torch.Generator, dev, data: str):
    """K2, K4 and K6b at their training shapes against their plain versions
    and the library's grid sampler; the v2_93 bf16 batch-10 step."""
    from stabnet_tpu_torch.data.pipeline import InputPipeline
    from stabnet_tpu_torch.ops import cuda_warp
    from stabnet_tpu_torch.train import create_train_state, make_train_step, train_step
    from stabnet_tpu_torch.utils.profiling import StageTimer

    bw, f32_peak = peaks(torch.cuda.get_device_name(0))
    H, W = 288, 512
    timed = {}
    # K2 at the shapes of the K5 forward (the temporal warp) and the K6
    # forward (the training warp), then K4 and K6b at their backwards'.
    for name, B, C in (("bilinear_sample", 10, 2), ("bilinear_sample", 20, 1),
                       ("bilinear_splat", 10, 2), ("sample_map_grad", 20, 1)):
        xm, ym = realistic_maps(B, H, W, gen, dev)
        g = (torch.rand((B, H, W, C), generator=gen) - 0.5).to(dev)
        im = (torch.rand((B, H, W, C), generator=gen) - 0.5).to(dev)
        grid = torch.stack([xm + 1.0 / W, ym + 1.0 / H], dim=-1)
        g_nchw = g.permute(0, 3, 1, 2).contiguous()
        im_nchw = im.permute(0, 3, 1, 2).contiguous()
        n = xm.numel()
        lib_name = "grid_sampler_2d_backward"
        if name == "bilinear_sample":
            kern = lambda: cuda_warp.bilinear_sample(im, xm, ym)
            plain = lambda: cuda_warp.bilinear_sample_plain(im, xm, ym)
            lib = lambda: F.grid_sample(im_nchw, grid, mode="bilinear",
                                        padding_mode="zeros", align_corners=False)
            lib_name = "F.grid_sample"
            # As phase 6: the maps, the image, the output; 24 + 7 C per pixel.
            nbytes = 4 * (2 * n + im.numel() + n * C)
            ops = (24 + 7 * C) * n
            extra = ""
        elif name == "bilinear_splat":
            kern = lambda: cuda_warp.bilinear_splat(g, xm, ym, (H, W))
            plain = lambda: cuda_warp.bilinear_splat_plain(g, xm, ym, (H, W))
            mask = [True, False]
            # g, the maps, the image cotangent; f32 operations per output
            # pixel (csrc/warp_grad.cu): the coordinates and weights 24
            # (ndc_to_pixel 4, floor 2, corner + 1 2, clamps 8, distances
            # 4, weights 4) and 4 products w * g per channel.
            nbytes = 4 * (g.numel() + 2 * n + B * H * W * C)
            ops = (24 + 4 * C) * n
            extra = (f"; the int64 accumulator adds {8 * B * H * W * C} B, zero-filled, "
                     f"updated by atomics and read back")
        else:
            kern = lambda: cuda_warp.sample_map_grad(im, xm, ym, g)
            plain = lambda: cuda_warp.sample_map_grad_plain(im, xm, ym, g)
            mask = [False, True]
            # g, the maps, the image, gx and gy; per output pixel 20 for the
            # coordinates (no weights), 14 per channel (4 sub, 6 mul, 4 add)
            # and 2 final scales.
            nbytes = 4 * (g.numel() + 2 * n + im.numel() + 2 * n)
            ops = (22 + 14 * C) * n
            extra = ""
        if name != "bilinear_sample":
            lib = lambda: torch.ops.aten.grid_sampler_2d_backward(
                g_nchw, im_nchw, grid, 0, 0, False, mask)
        t = {"ms": device_ms(kern), "plain_ms": device_ms(plain),
             "library_ms": device_ms(lib), "call_ms": call_ms(kern)}
        if name == "bilinear_splat":
            t["passes"] = {k: round(v, 5) for k, v in kernel_passes(kern)}
            x_f, y_f = flow_maps(B, H, W, gen, dev)
            t["flow_maps_ms"] = device_ms(lambda: cuda_warp.bilinear_splat(g, x_f, y_f, (H, W)))
            extra += (f"; per pass (torch.profiler, ms per call) {t['passes']}; on "
                      f"flow-like maps {t['flow_maps_ms']:.5f} ms")
        t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_peak * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        timed[name, f"({B}, {H}, {W}, {C})"] = t
        print(f"[10 times {name} ({B}, {H}, {W}, {C})] {card} | kernel {t['ms']:.5f} ms "
              f"device ({t['call_ms']:.5f} ms per call from the host), plain "
              f"{t['plain_ms']:.5f} ms, library {lib_name} {t['library_ms']:.5f} ms, "
              f"bound {t['bound_ms'] * 1e3:.3f} us ({nbytes} B, {t['bound_by']}){extra}")

    cfg = live_config()
    gc.collect()                 # earlier phases' garbage out of the peak
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    pipe = InputPipeline(os.path.join(data, "train"), cfg, seed=1, device=dev)
    state = create_train_state(cfg, device=dev, seed=0)
    steps = {"graph": make_train_step(cfg), "eager": lambda s, b: train_step(s, b, cfg)}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):           # the first call captures the step, the first batch the augmentation
        state, aux = steps["graph"](state, next(pipe))
    torch.cuda.synchronize()
    warm_gib = torch.cuda.max_memory_allocated() / 2 ** 30 - base_gib
    windows = []
    for mode in ("graph", "eager", "graph"):
        timers, step_ms = StageTimer("train."), []
        torch.cuda.reset_peak_memory_stats()
        t_window = time.perf_counter()
        for _ in range(10):
            with timers.stage("data"):
                batch = next(pipe)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with timers.stage("step"):
                state, aux = steps[mode](state, batch)
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        window_ms = (time.perf_counter() - t_window) * 1e3 / 10
        st = timers.summary()
        windows.append((mode, float(np.median(step_ms)), min(step_ms), max(step_ms),
                        window_ms, st["data"]["mean_ms"], st["step"]["mean_ms"],
                        torch.cuda.max_memory_allocated() / 2 ** 30 - base_gib))
        check(math.isfinite(float(aux["total"])), f"non-finite loss in the {mode} window")
    pipe.close()
    check(len(state.graphs) == 1, f"training graphs {state.graphs.stats()}")
    train_stats, aug_stats = state.graphs.stats()[0], pipe.graphs.stats()
    check(len(aug_stats) == 1, f"augmentation graphs {aug_stats}")
    for mode, p50, lo, hi, win, data_ms, stage_ms, peak in windows:
        print(f"[10 times train step {mode}] {card} | v2_93 bf16 batch 10 (20 frames per "
              f"forward): {p50:.3f} ms/step p50 over 10 synchronized steps (min {lo:.3f}, "
              f"max {hi:.3f}), {cfg.batch_size / p50 * 1e3:.2f} samples/s at the p50; the 10 "
              f"iterations with their data waits {win:.3f} ms per iteration, "
              f"{cfg.batch_size / win * 1e3:.2f} samples/s; stages: data mean {data_ms:.3f} "
              f"ms, step mean {stage_ms:.3f} ms; peak memory {peak:.2f} GiB above the "
              f"{base_gib:.2f} GiB held before the training")
    profiled = []
    for mode in ("graph", "eager", "graph"):
        wall, wall_prof, busy, ops, host, top = profile_steps(
            lambda: steps[mode](state, batch), steps=5)
        profiled.append((mode, wall))
        print(f"[10 profile train step {mode}] {card} | back to back on one batch: wall "
              f"{wall:.3f} ms/step unprofiled ({wall_prof:.3f} under the profiler), kernels "
              f"{busy:.3f} ms/step, device idle {100 * (1 - busy / wall):.1f}% of the "
              f"unprofiled wall, {ops:.1f} device operations and {host:.1f} host launches "
              f"per step; top kernels (name, ms/step, launches/step): {top}")

    # The eval step's graph and the augmentation's, each against its eager
    # function at the training shapes.
    from stabnet_tpu_torch.data import augment, prepare_raw
    from stabnet_tpu_torch.data.pipeline import augment_compiled, batch_iterator, ensure_flow
    from stabnet_tpu_torch.train import eval_step, make_eval_step
    from stabnet_tpu_torch.utils.graphs import GraphCache

    evaluate = make_eval_step(cfg)
    want = eval_step(state, batch, cfg)
    got = [evaluate(state, batch) for _ in range(3)]
    check(all(torch.equal(g[k], want[k]) for g in got for k in want),
          "the eval graph differs from eval_step")
    eval_stats = [g for g in state.graphs.stats() if g["key"][0] == "eval_step"]
    check(len(eval_stats) == 1 and eval_stats[0]["replays"] == 2, f"eval graphs {eval_stats}")
    cache = GraphCache()
    gen_graph, gen_eager = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    raws = batch_iterator(os.path.join(data, "train"), cfg, seed=4)
    for _ in range(3):
        raw = {k: torch.from_numpy(v) for k, v in prepare_raw(ensure_flow(next(raws))).items()}
        a = augment_compiled(cache, gen_graph, raw, cfg, (0, 1), dev)
        b = augment.augment_batch(gen_eager, {k: v.to(dev) for k, v in raw.items()}, cfg)
        check(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in b),
              "the augmentation graph differs from augment_batch")
    check(len(cache) == 1, f"augmentation graphs {cache.stats()}")

    def graph_cost(st):
        return (f"eager first call {st['warmup_s']:.3f} s, capture {st['capture_s']:.3f} s, "
                f"pool {st['pool_bytes']} B")

    print(f"[10 graphs] {card} | train step (v2_93 bf16 batch 10): {graph_cost(train_stats)}; "
          f"eval step, torch.equal eval_step over 3 calls: {graph_cost(eval_stats[0])}; "
          f"augmentation in the pipeline's thread: {graph_cost(aug_stats[0])}, and a fresh "
          f"one torch.equal augment_batch over 3 batches: {graph_cost(cache.stats()[0])}; "
          f"peak memory of the warm-up (eager first call and capture) {warm_gib:.2f} GiB "
          f"above the {base_gib:.2f} GiB held before it")
    graph_iter = float(np.mean([w[4] for w in windows if w[0] == "graph"]))
    return timed, graph_iter


# --- flow and metrics -------------------------------------------------------

# The shapes K2 samples at in one tvl1_flow call on a training batch: the
# pyramid of (10, 288, 512), three channels (the image and its gradient).
FLOW_SHAPES = ((10, 288, 512), (10, 144, 256), (10, 72, 128), (10, 32, 64))
# The same in the metrics' calls: 32 pairs at the evaluation scale, 144x256.
METRICS_FLOW_SHAPES = ((32, 144, 256), (32, 72, 128), (32, 32, 64), (32, 16, 32))


def flow_sample_maps(B: int, H: int, W: int, gen: torch.Generator, device,
                     amp: float = 6.0):
    """The NDC maps `ops.flow._warp_fields` hands K2: the pixel grid
    displaced by a smooth random field of up to `amp` pixels, clipped to
    [0, size - 1 - 1e-3], then 2 x / size - 1."""
    from stabnet_tpu_torch.ops import resize_bilinear_bhw

    d = amp * (2 * torch.rand((2, B, 5, 9), generator=gen) - 1)
    dx, dy = (resize_bilinear_bhw(v, (H, W)) for v in d)
    x = (torch.arange(W, dtype=torch.float32) + dx).clamp(0.0, W - 1.0 - 1e-3)
    y = (torch.arange(H, dtype=torch.float32)[:, None] + dy).clamp(0.0, H - 1.0 - 1e-3)
    return ((2.0 * x / W - 1.0).to(device), (2.0 * y / H - 1.0).to(device))


def smooth_pair(rng: np.random.RandomState, H: int, W: int, dx: float, dy: float):
    """A smooth random image in [0, 1] and its copy translated by (dx, dy)
    (bilinear, edges replicated): i0(p) = i1(p + (dx, dy)) inside."""
    img = rng.rand(H, W).astype(np.float32)
    for _ in range(5):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img = (img - img.min()) / (img.max() - img.min())
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    sy, sx = np.clip(ys - dy, 0, H - 1), np.clip(xs - dx, 0, W - 1)
    y0 = np.minimum(np.floor(sy).astype(int), H - 2)
    x0 = np.minimum(np.floor(sx).astype(int), W - 2)
    fy, fx = sy - y0, sx - x0
    moved = (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x0 + 1] * (1 - fy) * fx
             + img[y0 + 1, x0] * fy * (1 - fx) + img[y0 + 1, x0 + 1] * fy * fx)
    return img, moved.astype(np.float32)


def device_ops(fn):
    """One call of `fn` under torch.profiler (CUDA activity alone: the CPU
    activity's per-operator events would cost seconds on an eager flow):
    the device operations (kernels, copies, fills) it ran, their summed time
    in ms, and the host launches that queued them (the runtime calls come
    with the CUDA activity).  Counted from the profiler's raw events, not
    `key_averages`, whose per-event Python objects take tens of seconds over
    an eager flow's or metrics chunk's 72,000-85,000 operations (the two
    counts agreed within 0.5 % in calls B14 and C14)."""
    device, host = device_events(fn)
    return len(device), sum(e.duration_ns() for e in device) / 1e6, host


def device_events(fn):
    """`device_ops`' profile of one call of `fn`: the raw device events and
    the number of host launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    return ([e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA],
            sum(1 for e in events if e.name() in HOST_LAUNCHES))


def phase_flow(card: str, gen: torch.Generator, dev, clips: np.ndarray):
    """K2 in its edge-inclusive mode against its plain version at the flow's
    shapes, bit for bit; one tvl1_flow call at the training shape (launches,
    time, device operations); card against CPU, bit for bit; a translation
    recovered."""
    from stabnet_tpu_torch.ops import cuda_warp
    from stabnet_tpu_torch.ops.flow import tvl1_flow
    from stabnet_tpu_torch.stream.engine import gray_from_color

    bw, f32_peak = peaks(torch.cuda.get_device_name(0))
    worst = 0.0
    for B, H, W in FLOW_SHAPES + METRICS_FLOW_SHAPES:
        fields = (torch.rand((B, H, W, 3), generator=gen) * 255).to(dev)
        xm, ym = flow_sample_maps(B, H, W, gen, dev)
        got = cuda_warp.bilinear_sample(fields, xm, ym, strict_edge=False)
        want = cuda_warp.bilinear_sample_plain(fields, xm, ym, strict_edge=False)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, want), f"K2 edge-inclusive ({B}, {H}, {W}, 3): max abs {err}")

    # K2 at the finest level's shape: the kernel, its plain version, the
    # library's grid sampler (border padding, the edge-inclusive analogue).
    B, H, W = FLOW_SHAPES[0]
    fields = (torch.rand((B, H, W, 3), generator=gen) * 255).to(dev)
    xm, ym = flow_sample_maps(B, H, W, gen, dev)
    grid = torch.stack([xm + 1.0 / W, ym + 1.0 / H], dim=-1)
    f_nchw = fields.permute(0, 3, 1, 2).contiguous()
    n = xm.numel()
    nbytes, ops = 4 * (2 * n + fields.numel() + 3 * n), (24 + 7 * 3) * n
    t = {"ms": device_ms(lambda: cuda_warp.bilinear_sample(fields, xm, ym, strict_edge=False)),
         "plain_ms": device_ms(lambda: cuda_warp.bilinear_sample_plain(
             fields, xm, ym, strict_edge=False), calls=5),
         "library_ms": device_ms(lambda: F.grid_sample(
             f_nchw, grid, mode="bilinear", padding_mode="border", align_corners=False)),
         "call_ms": call_ms(lambda: cuda_warp.bilinear_sample(fields, xm, ym,
                                                               strict_edge=False))}
    t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_peak * 1e3
    t["bound_ms"] = max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    label = f"({B}, {H}, {W}, 3) edge-inclusive"
    print(f"[11 K2 flow] {card} | bilinear_sample strict_edge=False vs plain on the "
          f"card: max abs {worst:.3g} (tolerance 0) at "
          f"{list(FLOW_SHAPES + METRICS_FLOW_SHAPES)} x 3 channels, "
          f"clipped flow maps; at {label}: kernel {t['ms']:.5f} ms device "
          f"({t['call_ms']:.5f} ms per call from the host), plain {t['plain_ms']:.5f} ms, "
          f"library F.grid_sample (border) {t['library_ms']:.5f} ms, bound "
          f"{t['bound_ms'] * 1e3:.3f} us ({nbytes} B, {t['bound_by']})")

    # tvl1_flow at the training shape on consecutive frames of the clip: the
    # graph (its first call captures it, eagerly) against the eager flow,
    # torch.equal, then timed both ways.  (The metrics' flow runs inline in
    # the metrics chunk's graphs, phase 12.)
    from stabnet_tpu_torch.ops import flow as flow_ops

    color = torch.from_numpy(clips[0, :B + 1]).to(dev).permute(0, 3, 1, 2)
    gray = gray_from_color(color, (H, W))
    a, b = gray[:-1].contiguous(), gray[1:].contiguous()
    u = tvl1_flow(a, b)
    torch.cuda.synchronize()
    cuda_warp.reset_launch_counts()
    u = tvl1_flow(a, b)
    torch.cuda.synchronize()
    per_call = launch_counts()
    expected = {k: 0 for k in per_call} | {"bilinear_sample": 20}
    check(per_call == expected, f"tvl1_flow launches per replay {per_call}, "
                                f"expected {expected}")
    check(tuple(u.shape) == tuple(a.shape) + (2,) and bool(torch.isfinite(u).all()),
          f"tvl1_flow output {tuple(u.shape)}, finite {bool(torch.isfinite(u).all())}")
    walls = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "graph"):
        fn = tvl1_flow if mode == "graph" else flow_ops.tvl1_flow_eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(a, b)
        torch.cuda.synchronize()
        walls[mode].append((time.perf_counter() - t0) * 1e3)
        if mode == "eager":
            check(torch.equal(got, u), "tvl1_flow: the graph differs from eager")
    cap = [st for st in flow_ops.GRAPHS.stats() if st["shapes"][0] == tuple(a.shape)][0]
    g_ops, e_ops = (device_ops(lambda: fn(a, b))
                    for fn in (tvl1_flow, flow_ops.tvl1_flow_eager))
    g_ms, e_ms = float(np.median(walls["graph"])), walls["eager"][0]
    print(f"[11 flow training] {card} | tvl1_flow {tuple(a.shape)} fine_iters 40: the "
          f"captured graph torch.equal the eager flow; launches per replay K2 20; graph "
          f"{[round(w, 3) for w in walls['graph']]} ms per call, eager {e_ms:.3f} ms "
          f"({e_ms / g_ms:.2f}x); capture and instantiation {cap['capture_s']:.3f} s "
          f"after an eager first call of {cap['warmup_s']:.3f} s, pool "
          f"{cap['pool_bytes'] / 2 ** 20:.1f} MB; per call graph / eager: device operations "
          f"{g_ops[0]} / {e_ops[0]}, kernels {g_ops[1]:.3f} / {e_ops[1]:.3f} ms, host "
          f"launches {g_ops[2]} / {e_ops[2]}; device idle {100 * (1 - g_ops[1] / g_ms):.1f}% "
          f"/ {100 * (1 - e_ops[1] / e_ms):.1f}% of the wall")

    # Card against CPU in f32, two translated smooth pairs at (2, 96, 128).
    rng = np.random.RandomState(3)
    pairs = [smooth_pair(rng, 96, 128, 3.6, -2.3), smooth_pair(rng, 96, 128, -1.2, 0.7)]
    a = torch.from_numpy(np.stack([p[0] for p in pairs]))
    b = torch.from_numpy(np.stack([p[1] for p in pairs]))
    card_u = tvl1_flow(a.to(dev), b.to(dev)).cpu()
    cpu_u = tvl1_flow(a, b)
    d = (card_u - cpu_u).abs()
    inner = card_u[0, 16:-16, 16:-16]
    tx, ty = float(inner[..., 0].mean()), float(inner[..., 1].mean())
    print(f"[11 flow card vs cpu] tvl1_flow (2, 96, 128), default iterations: max abs "
          f"{float(d.max()):.3g} px, mean abs {float(d.mean()):.3g} px (need 0: every "
          f"operation correctly rounded on both devices); translation (3.6, -2.3) "
          f"recovered as ({tx:.4f}, {ty:.4f}) on the card (need within 0.2 px)")
    check(torch.equal(card_u, cpu_u), "flow: card and CPU disagree")
    check(abs(tx - 3.6) < 0.2 and abs(ty + 2.3) < 0.2, "flow: translation not recovered")
    return worst, t, per_call


def phase_metrics(card: str, dev, engine, clips: np.ndarray):
    """The S=1 driver with the input grays kept, then the clip's quality
    record at the evaluation scale; evaluate_clip card against CPU on the
    driver's output, and where the two devices part."""
    from stabnet_tpu_torch.eval import evaluate_clip, score_stabilized_clip
    from stabnet_tpu_torch.eval.metrics import (
        _EVAL_CHUNK, _FINE_ITERS, _eval_downscale, _eval_grays, _global_shift,
        _grid_correspondences, cropping_score, distortion_score, fit_homographies,
        stability_score)
    from stabnet_tpu_torch.ops import cuda_warp
    from stabnet_tpu_torch.ops.flow import tvl1_flow_eager
    from stabnet_tpu_torch.stream import DeployOptions, StreamDriver

    cfg = engine.cfg
    T = clips.shape[1]
    driver = StreamDriver(engine, DeployOptions(device_gray=True, collect_input_gray=True))
    chunks = lambda n: -(-n // _EVAL_CHUNK)
    flows = 2 * chunks(T - 1) + chunks(T)   # output and input stability, cross-video
    expected = {"bilinear_sample": 20 * flows, "warp_mesh": T - 1,
                "warp_uint8_cf_lowres": T - 1, "warp_uint8_cf": 0, "bilinear_splat": 0,
                "sample_map_grad": 0}
    cuda_warp.reset_launch_counts()
    t0 = time.perf_counter()
    res = driver.stabilize_clip(clips[0])
    t1 = time.perf_counter()
    scores = score_stabilized_clip(res.frames, res.input_gray, (cfg.height, cfg.width),
                                   crop_rect=res.crop_rect, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = launch_counts()
    check(launches == expected, f"metrics launches {launches}, expected {expected}")
    check(res.input_gray.shape == (T, cfg.height, cfg.width),
          f"input grays {res.input_gray.shape}")
    check(all(math.isfinite(v) and 0.0 < v <= 1.0 + 1e-6 for v in scores.values()),
          f"scores {scores}")
    ds = _eval_downscale(cfg.height, cfg.width)
    print(f"[12 metrics] {card} | {cfg.name} {cfg.compute_dtype} {clips.shape[2]}x"
          f"{clips.shape[3]} T={T}: S=1 StreamDriver with the input grays kept "
          f"{t1 - t0:.3f} s, score_stabilized_clip at {cfg.height // ds}x{cfg.width // ds} "
          f"{t2 - t1:.3f} s with the chunks' captures ({flows} chunks of {_EVAL_CHUNK} "
          f"pairs, a tvl1_flow at fine_iters 100 each), {t2 - t0:.3f} s per clip; launches "
          f"{launches}; scores { {k: round(v, 6) for k, v in scores.items()} }")
    metrics_graphs(card, dev, cfg, res, scores)

    # evaluate_clip card against CPU in f32 on the driver's own output at the
    # evaluation scale: its first 12 frames (one 32-pair chunk per flow pass)
    # and their input grays, made once on the card.  Then where the devices
    # part: the flow of consecutive output frames and the phase correlation
    # must be equal; the fit, the spectrum and the singular values on equal
    # inputs need not be (LAPACK against cuSOLVER, pocketfft against cuFFT).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    K = 12
    out_g, in_g, _ = _eval_grays(res.frames[:K], res.input_gray[:K],
                                 (cfg.height, cfg.width), dev)
    top, left, bot, right = res.crop_rect
    rect = (top // ds, left // ds, bot // ds, right // ds)
    t0 = time.perf_counter()
    on_card = evaluate_clip(out_g, in_g, rect=rect, device=dev)
    t1 = time.perf_counter()
    on_cpu = evaluate_clip(out_g.cpu(), in_g.cpu(), rect=rect, device="cpu")
    t2 = time.perf_counter()
    gaps = {k: abs(on_card[k] - on_cpu[k]) for k in on_cpu}
    a, b = out_g[:-1], out_g[1:]
    u = tvl1_flow_eager(a, b, fine_iters=_FINE_ITERS)
    u_cpu = tvl1_flow_eager(a.cpu(), b.cpu(), fine_iters=_FINE_ITERS)
    shift, shift_cpu = _global_shift(a, b), _global_shift(a.cpu(), b.cpu())
    src, dst = _grid_correspondences(u)
    Hs = fit_homographies(src, dst)
    Hs_cpu = fit_homographies(src.cpu(), dst.cpu())
    fit_gap = float((Hs.cpu() - Hs_cpu).abs().max() / Hs_cpu.abs().max())
    # The fit's gap split by cause: the sums of its normal equations in
    # float64 (rounded once to float32) on both devices, the solve as before.
    import stabnet_tpu_torch.eval.metrics as metrics_module

    f32_matmul = metrics_module._matmul
    metrics_module._matmul = lambda a, b: f32_matmul(a.double(), b.double()).float()
    try:
        Hs64, Hs64_cpu = fit_homographies(src, dst), fit_homographies(src.cpu(), dst.cpu())
    finally:
        metrics_module._matmul = f32_matmul
    fit_gap64 = float((Hs64.cpu() - Hs64_cpu).abs().max() / Hs64_cpu.abs().max())
    op_gaps = {name: abs(float(fn(Hs)) - float(fn(Hs.cpu())))
               for name, fn in (("stability_score", stability_score),
                                ("distortion_score", distortion_score),
                                ("cropping_score", cropping_score))}
    torch.backends.cudnn.allow_tf32 = True
    flow_gap = float((u.cpu() - u_cpu).abs().max())
    print(f"[12 metrics card vs cpu] evaluate_clip on the driver's frames 0-{K - 1} at "
          f"{out_g.shape[1]}x{out_g.shape[2]}, rect {rect}: card "
          f"{ {k: round(v, 7) for k, v in on_card.items()} } in {t1 - t0:.3f} s, cpu "
          f"{ {k: round(v, 7) for k, v in on_cpu.items()} } in {t2 - t1:.3f} s, worst gap "
          f"{max(gaps.values()):.3g} (need <= 1e-6). Where the devices part: tvl1_flow_eager "
          f"{tuple(u.shape)} fine_iters {_FINE_ITERS} max abs {flow_gap:.3g} (need 0), "
          f"_global_shift equal {all(map(torch.equal, (s.cpu() for s in shift), shift_cpu))} "
          f"(need True); on equal inputs fit_homographies max rel {fit_gap:.3g}, "
          f"{ {k: float(f'{v:.3g}') for k, v in op_gaps.items()} }")
    print(f"[12 fit split] fit_homographies card vs CPU on equal correspondences "
          f"{tuple(dst.shape)}: max rel {fit_gap:.3g} with float32 sums, {fit_gap64:.3g} with "
          f"the normal equations summed in float64 and rounded once (the solve in float32 "
          f"on both): the order of the sums makes the difference, the solve the rest")
    check(flow_gap == 0.0, "metrics: the flow differs between card and CPU")
    check(all(map(torch.equal, (s.cpu() for s in shift), shift_cpu)),
          "metrics: the phase correlation differs between card and CPU")
    check(max(gaps.values()) <= 1e-6, "metrics: card and CPU disagree")


def metrics_graphs(card: str, dev, cfg, res, scores: dict) -> None:
    """The metrics chunk's graphs, one per key, captured by phase 12's first
    scoring: the clip scored again through them (its wall split into the
    grays, the chunks and the rest) and with the eager chunks, every score
    equal; each key's graph torch.equal the eager chunk on the eager
    scoring's first chunk of that key, 20 K2 launches per replay, ms,
    device operations and host launches per chunk, capture seconds and
    pool bytes."""
    import stabnet_tpu_torch.eval.metrics as metrics_module
    from stabnet_tpu_torch.eval.metrics import (GRAPHS, _eval_grays, _pairs_h_chunk,
                                                _pairs_h_chunk_eager, score_stabilized_clip)
    from stabnet_tpu_torch.ops import cuda_warp

    zero = {k: 0 for k in launch_counts()}
    spent, first = {}, {}   # first: (prealign, rect given) -> inputs, result, ms

    def timed_part(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    def eager_chunk(a, b, rect=None, prealign=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = _pairs_h_chunk_eager(a, b, None if rect is None else rect.to(a.device),
                                 prealign=prealign)
        torch.cuda.synchronize()
        first.setdefault((prealign, rect is not None),
                         (a, b, rect, h, (time.perf_counter() - t0) * 1e3))
        return h

    def score(chunk):
        saved = metrics_module._pairs_h_chunk, metrics_module._eval_grays
        metrics_module._pairs_h_chunk = timed_part("chunks", chunk)
        metrics_module._eval_grays = timed_part("grays", _eval_grays)
        spent.clear()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = score_stabilized_clip(res.frames, res.input_gray, (cfg.height, cfg.width),
                                        crop_rect=res.crop_rect, device=dev)
            wall = time.perf_counter() - t0
            return out, (wall, spent["grays"], spent["chunks"],
                         wall - spent["grays"] - spent["chunks"])
        finally:
            metrics_module._pairs_h_chunk, metrics_module._eval_grays = saved

    graph_scores, graph_split = score(_pairs_h_chunk)
    eager_scores, eager_split = score(eager_chunk)
    check(graph_scores == scores == eager_scores,
          f"metrics: scored through the graphs {graph_scores}, first {scores}, with the "
          f"eager chunks {eager_scores}")
    names = {(True, True): "output stability (prealign, rect)",
             (True, False): "input stability (prealign)", (False, True): "cross-video (rect)"}
    check(set(first) == set(names), f"metrics: chunk keys {sorted(first)}")
    notes = []
    for key, what in names.items():
        a, b, r, want, eager_ms = first[key]
        cuda_warp.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = _pairs_h_chunk(a, b, r, prealign=key[0])
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) * 1e3
        per_call = launch_counts()
        check(torch.equal(got, want), f"metrics chunk, {what}: the graph differs from eager")
        check(per_call == zero | {"bilinear_sample": 20},
              f"metrics chunk, {what}: launches per replay {per_call}")
        ops, ms, host = device_ops(lambda: _pairs_h_chunk(a, b, r, prealign=key[0]))
        note = (f"{what}: {graph_ms:.3f} ms per chunk as a graph against {eager_ms:.3f} "
                f"eager; as a graph {ops} device operations ({ms:.3f} ms of them), {host} "
                f"host launches")
        if key == (True, True):   # one key eagerly: ~85,000 operations
            ops, ms, host = device_ops(lambda: eager_chunk(a, b, r, prealign=True))
            note += f"; eager {ops} ({ms:.3f} ms), {host} host launches"
        notes.append(note)
    graphs = [f"{st['key'][1:]} {st['shapes'][0]}: capture {st['capture_s']:.3f} s after an "
              f"eager first call of {st['warmup_s']:.3f} s, pool {st['pool_bytes']} B, "
              f"{st['replays']} replays" for st in GRAPHS.stats()]
    check(len(graphs) == 3, f"metrics: {len(graphs)} chunk graphs, expected 3")
    split = lambda t: f"{t[0]:.3f} s (the grays {t[1]:.3f}, the chunks {t[2]:.3f}, the rest {t[3]:.3f})"
    print(f"[12 metrics graphs] {card} | the clip scored again through the chunks' graphs "
          f"{split(graph_split)} and with the eager chunks {split(eager_split)}, every score "
          f"equal; each key's graph torch.equal the eager chunk on the eager scoring's first "
          f"chunk of that key, 20 K2 per replay: " + "; ".join(notes)
          + ". Graphs (prealign, rect given): " + "; ".join(graphs))


class IterTimes:
    """Within: the host clock at each "iter N" log line of the training loop
    (one per logged step; with disp_freq 1 each follows the step's loss
    read-back, which waits for the device), so the gaps between them are
    wall times per iteration."""

    def __enter__(self):
        import logging

        times = self.times = []

        class Handler(logging.Handler):
            def emit(self, record):
                if record.getMessage().startswith("iter ") and "test_loss" not in \
                        record.getMessage():
                    times.append(time.perf_counter())

        self.handler = Handler()
        logging.getLogger("stabnet_tpu_torch").addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger("stabnet_tpu_torch").removeHandler(self.handler)

    def ms(self, skip: int = 1):
        """Iteration walls in ms after the first `skip` gaps (the first
        iteration captures the step's graph)."""
        return [round((b - a) * 1e3, 3) for a, b in zip(self.times, self.times[1:])][skip:]


FLOW_STEPS = 12


def phase_flow_train(card: str, tmp: str, data: str, flowless_iter_ms: float):
    """Phase 8's make-synthetic shards with the flow field stripped, then
    `train --compute-flow` through the CLI at v2_93 bf16 batch 10 for
    FLOW_STEPS steps, the temporal loss fed by the flow from step 0."""
    from stabnet_tpu_torch.cli.main import main as cli
    from stabnet_tpu_torch.data import records
    from stabnet_tpu_torch.ops import cuda_warp

    examples = []
    for shard in records.list_shards(os.path.join(data, "train")):
        arrays = records.read_shard(shard)
        examples += [{k: v[i] for k, v in arrays.items() if k != "flow"}
                     for i in range(len(arrays["stable"]))]
    flowless = os.path.join(tmp, "flowless")
    records.write_shards(os.path.join(flowless, "train"), examples)
    log_dir = os.path.join(tmp, "flow_log")
    base = ["train", "--config", "v2_93", "--data", flowless, "--model-dir",
            os.path.join(tmp, "flow_models"), "--log-dir", log_dir, "--seed", "0",
            "--set", "disp_freq=1", *TRAIN_LIVE, "--steps", str(FLOW_STEPS)]
    try:
        cli(base)
        raise AssertionError("train on flowless shards without --compute-flow ran")
    except ValueError as e:
        check("--compute-flow" in str(e), f"refusal without --compute-flow: {e}")
    cuda_warp.reset_launch_counts()
    t0 = time.perf_counter()
    with IterTimes() as walls:
        cli(base + ["--compute-flow"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    # Each step launches K2 twice (the K5 and K6 forwards), each batch the
    # pipeline made (the steps', and up to 3 more it had in hand or queued
    # when it was closed) 20 times in its flow.
    n = FLOW_STEPS
    batches = (launches["bilinear_sample"] - 2 * n) / 20
    rest = {k: v for k, v in launches.items() if k != "bilinear_sample"}
    check(batches == int(batches) and n <= batches <= n + 3
          and rest == {"warp_mesh": 0, "warp_uint8_cf_lowres": 0, "warp_uint8_cf": 0,
                       "bilinear_splat": n, "sample_map_grad": n},
          f"train --compute-flow launches {launches}")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if r["tag"] == "train"]
    check([r["step"] for r in rows] == list(range(n)), f"steps {[r['step'] for r in rows]}")
    check(all(math.isfinite(r["total"]) and r["temp"] > 0 for r in rows),
          f"losses {[(r['total'], r['temp']) for r in rows]}")
    # The pipeline's thread enqueues a batch's flow as soon as the queue
    # has room, so a step's loss read-back also waits for the flows queued
    # ahead of it and the walls come in bursts: their mean over the window
    # after the first three (which drain what was made during step 0's
    # capture) is the iteration.
    iter_ms = float(np.mean(walls.ms(skip=3)))
    print(f"[13 flow train] {card} | train --compute-flow, v2_93 bf16 batch 10, {n} steps "
          f"through the CLI, training {seconds:.1f} s (refused without --compute-flow): "
          f"launches {launches} (K2: 2 per step + 20 per tvl1_flow, {int(batches)} batches "
          f"made); temporal loss live (step 0 temp {rows[0]['temp']:.6g}, total "
          f"{rows[0]['total']:.6g}); {iter_ms:.3f} ms per iteration, the mean of the "
          f"walls between the loop's log lines after the first three ({walls.ms(skip=0)}; "
          f"loop stages data {[round(r['data_ms'], 3) for r in rows[1:]]}, step "
          f"{[round(r['step_ms'], 3) for r in rows[1:]]} ms) against {flowless_iter_ms:.3f} "
          f"ms with record flow (phase 10's graph windows)")
    return launches, iter_ms


# --- serving modes and weights in --------------------------------------------

def stage_percentiles(res) -> dict:
    """p50 and p90 of the per-frame "net" (dispatch + readback), ms."""
    st = res.stage_summary["net"]
    return {"p50": st["p50_ms"], "p90": st["p90_ms"]}


def phase_serving_modes(card: str, dev, engine, clips: np.ndarray, eager1: np.ndarray):
    """The driver's serving modes on phase 4's engine and clips (its graphs);
    the S=1 driver, sync and pipelined, against phase 4's eager frames
    `eager1`.  Returns the launch counts of the chunked batch (K1 and K2m
    once per step)."""
    from stabnet_tpu_torch.config import V2_93
    from stabnet_tpu_torch.data.synthetic import make_video
    from stabnet_tpu_torch.ops import cuda_warp, max_clear_rect, max_clear_rect_plain
    from stabnet_tpu_torch.stream import DeployOptions, StreamDriver, StreamEngine, video_io

    T = clips.shape[1]
    zero = {k: 0 for k in launch_counts()}

    def same(a, b, what):
        check(np.array_equal(a.frames, b.frames) and np.array_equal(a.all_black, b.all_black)
              and a.crop_rect == b.crop_rect, f"{what}: not bit for bit")

    # Pipelined against synchronous, in turns, on the same clip.
    runs = {}
    for name in ("sync", "pipelined", "sync", "pipelined"):
        driver = StreamDriver(engine, DeployOptions(device_gray=True,
                                                    pipelined=name == "pipelined"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = driver.stabilize_clip(clips[0])
        wall = (time.perf_counter() - t0) / (T - 1) * 1e3
        runs.setdefault(name, []).append((res, wall))
    for (a, _), (b, _) in zip(runs["sync"], runs["pipelined"]):
        same(a, b, "pipelined vs sync")
        check(np.array_equal(a.frames[1:], eager1), "sync driver (graphs) vs eager")
    lat = {name: [dict(stage_percentiles(r), wall=w) for r, w in rs]
           for name, rs in runs.items()}
    print(f"[14 pipelined] {card} | v2_93 bf16 720p S=1 T={T}, device gray, runs in "
          f"turns sync, pipelined, sync, pipelined: frames, black map and crop equal bit "
          f"for bit, and the frames the eager steps' (phase 4); per-frame net (dispatch + readback) ms p50/p90 and wall ms/frame "
          f"(whole clip incl. crop): "
          + "; ".join(f"{n} " + ", ".join(f"{d['p50']:.3f}/{d['p90']:.3f} wall {d['wall']:.3f}"
                                          for d in ds) for n, ds in lat.items()))

    # stabilize_batch: clips of 40, 23 and 9 frames as 4 streams.
    batch = [clips[0], clips[1][:23], clips[2][:9]]
    driver = StreamDriver(engine, DeployOptions())
    results, counts = {}, {}
    for chunk in (None, 16):
        cuda_warp.reset_launch_counts()
        results[chunk] = driver.stabilize_batch(batch, chunk=chunk, pad_streams=4)
        torch.cuda.synchronize()
        counts[chunk] = launch_counts()
        steps = T - 1 if chunk is None else 1 + -(-(T - 1) // chunk) * chunk - 1
        want = zero | {"warp_mesh": steps, "warp_uint8_cf_lowres": steps}
        check(counts[chunk] == want, f"batch chunk={chunk} launches {counts[chunk]}, "
                                     f"expected {want}")
    for i, clip in enumerate(batch):
        check(results[16][i].frames.shape == (len(clip),) + CLIP_HW + (3,),
              f"batch clip {i} frames {results[16][i].frames.shape}")
        same(results[16][i], results[None][i], f"batch clip {i} chunked vs unchunked")
        alone = driver.stabilize_batch([clip], pad_streams=4)[0]
        same(results[None][i], alone, f"batch clip {i} vs alone at 4 streams")
    four = driver.stabilize_batch(list(clips), chunk=16)
    st = four[0].stage_summary
    batch_fps = four[0].fps_net
    print(f"[14 batch] {card} | stabilize_batch of clips of {[len(c) for c in batch]} "
          f"frames at pad_streams=4: chunk 16 launches {counts[16]}, unchunked "
          f"{counts[None]} (K1 and K2m once per scanned step); chunked, unchunked and "
          f"each clip alone at 4 streams bit for bit; 4 clips of {T} frames at chunk 16: "
          f"{batch_fps:.2f} frames/s over the scan and readback ({st['scan']['total_s']:.3f} s), "
          f"host gray and resize preparation {st['pre']['total_s']:.3f} s apart "
          f"({4 * (T - 1) / (st['scan']['total_s'] + st['pre']['total_s']):.2f} frames/s "
          f"with it)")

    # Constant-memory streaming over arrays against the chunked batch.
    writer = video_io.ArrayVideoWriter()
    streamed = driver.stabilize_stream(video_io.ArrayVideoReader(clips[0]), writer, 16)
    want = driver.stabilize_batch([clips[0]], chunk=16)[0]
    check(streamed.frames is None and streamed.num_frames == T, "streamed result")
    check(np.array_equal(writer.stack(), want.frames)
          and np.array_equal(streamed.all_black, want.all_black)
          and streamed.crop_rect == want.crop_rect, "streaming vs chunked batch")
    print(f"[14 stream] {card} | stabilize_stream over arrays, chunk 16, {T} frames: "
          f"equal to the chunked S=1 batch bit for bit; {streamed.fps_net:.2f} frames/s "
          f"over the scans and readbacks (S=1 batch {want.fps_net:.2f})")

    # Every ablation mode and the vis mosaics for 8 frames with a stable clip.
    K = 8
    stable = make_video(K, *CLIP_HW, seed=0, jitter=0.0)
    cfg = engine.cfg
    modes = [dict(infer_with_last=True), dict(infer_with_stable=True, random_black=5),
             dict(max_span=3), dict(start_with_stable=True), dict(deploy_vis=True)]
    done = []
    for opts in modes:
        cuda_warp.reset_launch_counts()
        res = StreamDriver(engine, DeployOptions(**opts)).stabilize_clip(clips[0][:K], stable)
        torch.cuda.synchronize()
        want = zero | {"warp_mesh": K - 1, "warp_uint8_cf_lowres": K - 1}
        check(launch_counts() == want, f"{opts} launches {launch_counts()}")
        check(res.frames.shape == (K,) + CLIP_HW + (3,), f"{opts} frames {res.frames.shape}")
        if opts.get("deploy_vis"):
            check(res.vis.shape == (K - 1, 2 * cfg.height, 2 * cfg.width, 3),
                  f"vis {res.vis.shape}")
        done.append("+".join(opts))
    # One ablation mode card against CPU, f32, TF32 off (phase 5's bound).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = V2_93.replace(compute_dtype="float32")
    cpu_model = random_model(f32, 1)
    outs = {}
    for name, model, device in (("card", copy.deepcopy(cpu_model), dev),
                                ("cpu", cpu_model, "cpu")):
        outs[name] = StreamDriver(StreamEngine(model, f32, device=device), DeployOptions(
            infer_with_stable=True, max_span=3)).stabilize_clip(clips[0][:K], stable)
    torch.backends.cudnn.allow_tf32 = True
    diff = np.abs(outs["card"].frames.astype(np.int32) - outs["cpu"].frames.astype(np.int32))
    within1 = float((diff <= 1).mean())
    black_diff = int((outs["card"].all_black != outs["cpu"].all_black).sum())
    print(f"[14 ablations] {card} | {K} frames with a stable clip, each K1 and K2m "
          f"{K - 1} launches: {done}, vis mosaics {(K - 1, 2 * cfg.height, 2 * cfg.width, 3)}; "
          f"infer_with_stable + max_span=3 card vs CPU, f32, TF32 off: within 1 LSB on "
          f"{within1 * 100:.4f}% of pixels (need >= 99.9), max {int(diff.max())} LSB "
          f"(need <= 2); all_black differs at {black_diff} pixels (need 0)")
    check(within1 >= 0.999 and diff.max() <= 2 and black_diff == 0,
          "ablation mode: card and CPU disagree")

    # The native crop against the plain one on every clip's black map.
    maps = ([r.all_black for r in results[None]] + [r.all_black for r in four]
            + [runs["sync"][0][0].all_black, outs["card"].all_black])
    for m in maps:
        check(max_clear_rect(m) == max_clear_rect_plain(m), "native crop vs plain")
    times = {}
    for name, fn in (("native", max_clear_rect), ("plain", max_clear_rect_plain)):
        ts = []
        for m in maps:
            t0 = time.perf_counter()
            fn(m)
            ts.append((time.perf_counter() - t0) * 1e3)
        times[name] = float(np.median(ts))
    print(f"[14 crop] {card} | max_clear_rect native (g++ -O3, ctypes) vs plain "
          f"(Python) on {len(maps)} black maps at {cfg.height}x{cfg.width}: equal "
          f"rectangles; median ms per clip native {times['native']:.4f}, plain "
          f"{times['plain']:.3f}")
    return counts[16]


def slim_var_shapes(in_ch: int, prefix: str, head_prefix=None) -> dict:
    """The variable inventory of TF-slim's resnet_v2_50 (+ the StabNet head):
    {name: shape}, from slim's structure (s_net_bundle_nobm.py:253)."""
    v = {}

    def bn(p, c):
        for k in ("gamma", "beta", "moving_mean", "moving_variance"):
            v[f"{p}/{k}"] = (c,)

    v[f"{prefix}/conv1/weights"] = (7, 7, in_ch, 64)
    v[f"{prefix}/conv1/biases"] = (64,)
    depth_in = 64
    for b, n in enumerate((3, 4, 6, 3), 1):
        depth, depth_bn = 256 * 2 ** (b - 1), 64 * 2 ** (b - 1)
        for u in range(1, n + 1):
            s = f"{prefix}/block{b}/unit_{u}/bottleneck_v2"
            bn(f"{s}/preact", depth_in)
            if depth_in != depth:
                v[f"{s}/shortcut/weights"] = (1, 1, depth_in, depth)
                v[f"{s}/shortcut/biases"] = (depth,)
            v[f"{s}/conv1/weights"] = (1, 1, depth_in, depth_bn)
            bn(f"{s}/conv1/BatchNorm", depth_bn)
            v[f"{s}/conv2/weights"] = (3, 3, depth_bn, depth_bn)
            bn(f"{s}/conv2/BatchNorm", depth_bn)
            v[f"{s}/conv3/weights"] = (1, 1, depth_bn, depth)
            v[f"{s}/conv3/biases"] = (depth,)
            depth_in = depth
    bn(f"{prefix}/postnorm", 2048)
    if head_prefix is not None:
        for i, (din, dout) in enumerate(((2048, 2048), (2048, 1024), (1024, 512)), 1):
            v[f"{head_prefix}/fc/fc_{i}/weights"] = (din, dout)
            v[f"{head_prefix}/fc/fc_{i}/biases"] = (dout,)
        v[f"{head_prefix}/fc_weights"] = (512, 50)
        v[f"{head_prefix}/fc_bias"] = (50,)
    return v


def slim_values(shapes: dict, seed: int) -> dict:
    """Seeded values: N(0, 0.05^2), moving variances in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    return {name: ((0.5 + rng.rand(*shape)) if name.endswith("moving_variance")
                   else rng.randn(*shape) * 0.05).astype(np.float32)
            for name, shape in shapes.items()}


def phase_weights_in(card: str, dev, clips: np.ndarray, tmp: str, data: str):
    """Weights in: `--model-dir` serving, the TF-slim mapping, the ImageNet
    graft and a training step after it."""
    from stabnet_tpu_torch.cli.main import build_engine
    from stabnet_tpu_torch.compat import convert_resnet_v2_50, convert_stabnet_variables
    from stabnet_tpu_torch.config import V2_93
    from stabnet_tpu_torch.data.pipeline import InputPipeline
    from stabnet_tpu_torch.models import make_model
    from stabnet_tpu_torch.ops import cuda_warp
    from stabnet_tpu_torch.stream import DeployOptions, StreamDriver, StreamEngine
    from stabnet_tpu_torch.train import create_train_state, train_step
    from stabnet_tpu_torch.train.checkpoint import transfer_from_imagenet

    K = 8
    clip = clips[:1, :K]
    grays = host_grays(clip, V2_93)
    model_dir = os.path.join(tmp, "models")
    served = build_engine("v2_93", model_dir=model_dir, device=dev)
    by_hand = make_model(V2_93)
    by_hand.load_state_dict(torch.load(os.path.join(model_dir, "6", "state.pt"),
                                       map_location="cpu", weights_only=True)["model"])
    (wa, sa), (wb, sb) = (e.stabilize_clip(grays, clip) for e in (
        served, StreamEngine(by_hand, V2_93, device=dev)))
    check(torch.equal(wa, wb) and torch.equal(sa.all_black, sb.all_black),
          "--model-dir serving differs from the checkpoint's weights")
    black_share = float((sa.all_black > 0).float().mean())
    del served

    trunk, head = "stable_net/resnet/resnet_v2_50", "stable_net/resnet/fc"
    values = slim_values(slim_var_shapes(V2_93.in_channels, trunk, head), seed=7)
    for k in (f"{head}/fc_weights", f"{head}/fc_bias"):   # production magnitude
        values[k] *= np.float32(0.05)
    model = make_model(V2_93)
    model.load_state_dict(convert_stabnet_variables(values), strict=True)
    cuda_warp.reset_launch_counts()
    res = StreamDriver(StreamEngine(model, V2_93, device=dev),
                       DeployOptions(device_gray=True)).stabilize_clip(clips[0][:K])
    torch.cuda.synchronize()
    tf_launches = launch_counts()
    check(res.frames.shape == (K,) + CLIP_HW + (3,)
          and tf_launches["warp_mesh"] == K - 1 and tf_launches["warp_uint8_cf_lowres"] == K - 1,
          f"slim-mapped model: frames {res.frames.shape}, launches {tf_launches}")

    cfg = live_config()
    state = create_train_state(cfg, device=dev, seed=0)
    imagenet = convert_resnet_v2_50(slim_values(slim_var_shapes(3, "resnet_v2_50"), seed=8))
    state.model.load_state_dict(transfer_from_imagenet(state.model.state_dict(), imagenet))
    grafted = state.model.state_dict()
    check(all(torch.equal(grafted[k].cpu(), v) for k, v in imagenet.items()
              if not k.startswith("resnet_v2_50.conv1.")), "graft incomplete")
    pipe = InputPipeline(os.path.join(data, "train"), cfg, seed=2, device=dev)
    batch = next(pipe)
    pipe.close()
    torch.cuda.synchronize()
    cuda_warp.reset_launch_counts()
    state, aux = train_step(state, batch, cfg)
    losses = {k: float(v) for k, v in aux.items()}
    launches = launch_counts()
    want = {k: 0 for k in launches} | {"bilinear_sample": 2, "bilinear_splat": 1,
                                        "sample_map_grad": 1}
    check(launches == want, f"step after the graft: launches {launches}, expected {want}")
    check(all(math.isfinite(v) for v in losses.values()), f"losses {losses}")
    print(f"[15 weights in] {card} | stabilize --model-dir (build_engine) on phase 8's "
          f"step-6 state.pt vs an engine loaded by hand: {K} frames and black map bit for "
          f"bit (black share {black_share:.4f}); TF-slim mapping of a full-width seeded "
          f"v2_93 slim dict ({len(values)} variables) loaded strictly, served {K} frames "
          f"with launches {tf_launches}, crop {res.crop_rect}; ImageNet trunk "
          f"({len(imagenet)} tensors) grafted, one v2_93 bf16 batch-10 step: launches "
          f"{launches}, losses total {losses['total']:.6g}, img {losses['img1']:.6g}")


# --- export, data parallelism and sharded serving ----------------------------

def exported_vs_program(served, grays: np.ndarray, colors: np.ndarray, what: str) -> None:
    """`served`'s steps (graph replays) against its loaded step program
    called eagerly on the card (as `load_stream_step` calls it), frame by
    frame from the clips' first frame: every output and the state
    torch.equal."""
    from stabnet_tpu_torch.stream.export import initial_state

    dev = served.device
    state = served.init(grays[:, 0])
    ref = initial_state(torch.from_numpy(grays[:, 0]).to(dev), served.cfg)
    for t in range(1, grays.shape[1]):
        state, out = served.step(state, grays[:, t], colors[:, t])
        gray = torch.from_numpy(grays[:, t]).to(dev)
        with torch.no_grad():
            res = served._step(*ref, gray, torch.from_numpy(colors[:, t]).to(dev))
        ref = type(ref)(*res[:4])
        check(all(map(torch.equal, out, (*res[4:], gray))),
              f"{what}: step {t} differs from the eager program")
    check(all(map(torch.equal, state, ref)), f"{what}: the state differs from the eager program's")


def phase_export(card: str, dev, engine, clips: np.ndarray):
    """The serving step exported at S=1 and, with a 2-frame segment, at
    S=4; loaded from bytes and served (graph replays) against the programs
    called eagerly and the live engine; the exported engine as it served
    before its graphs timed beside both.  Returns the launches of the
    exported S=1 clip and of the exported 4-clip batch."""
    from stabnet_tpu_torch.ops import cuda_warp
    from stabnet_tpu_torch.stream import DeployOptions, StreamDriver
    from stabnet_tpu_torch.stream.engine import StepOutput, StreamState
    from stabnet_tpu_torch.stream.export import (ExportedEngine, export_scan_segment,
                                                 export_stream_step, initial_state,
                                                 load_artifact, save_artifact)

    class EagerExported(ExportedEngine):
        """The exported engine as it served before its graphs: its loaded
        step program called eagerly, as `load_stream_step` calls it, each
        frame uploaded from pageable memory."""

        def step(self, state, cur_gray, cur_color, history_override=None):
            gray = torch.as_tensor(cur_gray).to(self.device)
            with torch.no_grad():
                res = self._step(*state, gray,
                                 torch.as_tensor(self._resize(cur_color)).to(self.device))
            return StreamState(*res[:4]), StepOutput(*res[4:], input_gray=gray)

    cfg, T, S, K = engine.cfg, clips.shape[1], clips.shape[0], 2
    zero = {k: 0 for k in launch_counts()}
    t0 = time.perf_counter()
    step1 = export_stream_step(engine, CLIP_HW, streams=1)
    t1 = time.perf_counter()
    step4 = export_stream_step(engine, CLIP_HW, streams=S)
    seg4 = export_scan_segment(engine, CLIP_HW, streams=S, segment=K)
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "v2_93.stbx")
        save_artifact(path, {"cuda": (step1, None)}, cfg, CLIP_HW, 1, engine.refine)
        blob, meta = load_artifact(path)
    check(blob == step1 and meta["format"] == "torch.export" and meta["platforms"] == ["cuda"]
          and meta["programs"] == {"cuda": {"step": [0, len(step1)]}},
          f"artifact header {meta}")
    t3 = time.perf_counter()
    served = ExportedEngine(blob, cfg, CLIP_HW, streams=1, device=dev)
    t4 = time.perf_counter()
    served4 = ExportedEngine(step4, cfg, CLIP_HW, streams=S, scan_data=seg4, segment=K,
                             device=dev)
    t5 = time.perf_counter()
    eager = EagerExported(blob, cfg, CLIP_HW, streams=1, device=dev)
    marks = [("load the eager engine", time.perf_counter())]

    def same(a, b, what):
        for x, y in zip(a, b):
            check(np.array_equal(x.frames, y.frames) and np.array_equal(x.all_black, y.all_black)
                  and x.crop_rect == y.crop_rect, f"{what}: not bit for bit")

    # The S=1 step's graph against the program called eagerly on the card.
    grays1 = host_grays(clips[:1, :9], cfg)
    exported_vs_program(served, grays1, clips[:1, :9], "exported S=1 step graph")
    marks.append(("the step against the program", time.perf_counter()))
    drivers = {"live": StreamDriver(engine, DeployOptions()),
               "exported": StreamDriver(served, DeployOptions()),
               "eager": StreamDriver(eager, DeployOptions())}
    runs = {}
    for name in ("live", "exported", "eager", "live"):
        cuda_warp.reset_launch_counts()
        res = drivers[name].stabilize_clip(clips[0])
        torch.cuda.synchronize()
        runs.setdefault(name, []).append((res, launch_counts()))
    want = zero | {"warp_mesh": T - 1, "warp_uint8_cf_lowres": T - 1}
    for name, rs in runs.items():
        for _, launches in rs:
            check(launches == want, f"{name} S=1 launches {launches}, expected {want}")
    for name in ("exported", "eager"):
        same([r for r, _ in runs[name]], [r for r, _ in runs["live"]],
             f"{name} vs live S=1 clip")
    sync = StreamDriver(served, DeployOptions(pipelined=False)).stabilize_clip(clips[0])
    same([sync], [runs["exported"][0][0]], "exported S=1 clip, synchronous vs pipelined")

    marks.append(("the clips in turns and synchronous", time.perf_counter()))
    # The S=4 segment's graph against the program called eagerly, with a
    # stream frozen after 5 steps, then the batch against the live one.
    g4 = host_grays(clips[:, :7], cfg)
    valid = np.arange(6)[None] < np.array([[6], [6], [6], [5]])
    state = served4.init(g4[:, 0])
    ref = initial_state(torch.from_numpy(g4[:, 0]).to(dev), cfg)
    for t in range(1, 7, K):
        w, state = served4.continue_clip(state, g4[:, t:t + K], clips[:, t:t + K],
                                         valid[:, t - 1:t - 1 + K])
        with torch.no_grad():
            res = served4._scan(*ref, *(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
                                  (g4[:, t:t + K], clips[:, t:t + K], valid[:, t - 1:t - 1 + K])))
        ref = type(ref)(*res[1:])
        check(torch.equal(w, res[0]), f"exported S={S} segment graph: frames {t}-{t + K - 1} "
              f"differ from the eager program")
    check(all(torch.equal(getattr(state, f), getattr(ref, f)) for f in state._fields),
          f"exported S={S} segment graph: the state differs from the eager program's")
    cuda_warp.reset_launch_counts()
    got = StreamDriver(served4, DeployOptions()).stabilize_batch(list(clips))
    torch.cuda.synchronize()
    batch_launches = launch_counts()
    steps = -(-(T - 1) // K) * K
    want4 = zero | {"warp_mesh": steps, "warp_uint8_cf_lowres": steps}
    check(batch_launches == want4, f"segment batch launches {batch_launches}, expected {want4}")
    same(got, drivers["live"].stabilize_batch(list(clips), chunk=K),
         "exported segment vs live chunked batch")
    marks.append(("the segment and the batch", time.perf_counter()))
    ops = {}
    for name, e in (("live", engine), ("exported", served), ("eager", eager)):
        wall, _, _, busy, per_frame, host, _, _ = profile_path(e, clips[0], frames=20,
                                                               device_gray=False)
        ops[name] = (wall, busy, per_frame, host)
    marks.append(("the profiles", time.perf_counter()))
    lat = {n: ", ".join(f"{d['p50']:.3f}/{d['p90']:.3f}"
                        for d in (stage_percentiles(r) for r, _ in rs))
           for n, rs in runs.items()}
    graphs = [f"{st['key']} {st['shapes'][0]}: capture {st['capture_s']:.3f} s, pool "
              f"{st['pool_bytes']} B" for e in (served, served4) for st in e.graphs.stats()]
    print(f"[16 export] {card} | {cfg.name} {cfg.compute_dtype} {CLIP_HW[0]}p: export S=1 step "
          f"{t1 - t0:.2f} s ({len(step1)} B), S={S} step + {K}-frame segment {t2 - t1:.2f} s "
          f"({len(step4)} + {len(seg4)} B); load from bytes S=1 {t4 - t3:.2f} s, S={S} with "
          f"segment {t5 - t4:.2f} s; the S=1 step's graph torch.equal the program called "
          f"eagerly over 8 frames, the S={S} segment's over 3 segments with a stream frozen; "
          f"the {T}-frame clip through StreamDriver on the exported engine (graphs, and "
          f"eager) equal to the live one bit for bit (crop {runs['exported'][0][0].crop_rect}), "
          f"pipelined equal to synchronous, launches {runs['exported'][0][1]}; the {S}-clip "
          f"batch on the segment equal to the live batch chunked by {K}, launches "
          f"{batch_launches}; net ms p50/p90 in turns live, exported graph, exported eager, "
          f"live: live {lat['live']}, exported graph {lat['exported']}, exported eager "
          f"{lat['eager']}; host grays, 20 frames: " + "; ".join(
              f"{n} wall {w:.3f} ms/frame, kernels {b:.3f} ms/frame, device operations "
              f"{o:.1f}/frame, host launches {h:.1f}/frame" for n, (w, b, o, h) in ops.items())
          + "; graphs: " + "; ".join(graphs) + "; seconds: " + ", ".join(
              f"{n} {b - a:.1f}" for (_, a), (n, b) in zip([("", t5)] + marks, marks)))
    del served, served4, eager
    return runs["exported"][0][1], batch_launches


def serve_clip(engine, clip: np.ndarray):
    """One clip through StreamDriver on `engine`, with the launches it made."""
    from stabnet_tpu_torch.ops import cuda_warp
    from stabnet_tpu_torch.stream import DeployOptions, StreamDriver

    cuda_warp.reset_launch_counts()
    res = StreamDriver(engine, DeployOptions()).stabilize_clip(clip)
    torch.cuda.synchronize()
    return res, launch_counts()


def phase_export_platforms(card: str, dev, engine, clips: np.ndarray, tmp: str):
    """`export --platforms` through the CLI with the weights phase 4's
    engine holds (the CLI's seeded random weights): traced on the card for
    cuda and cpu, and traced on the CPU for cpu and cuda (the counterpart of
    a JAX CPU host exporting for the accelerator).  Each program serves on
    its own device bit for bit as the live engine there: each CUDA program
    phase 4's clip with K1 and K2m once per frame, each CPU program the
    clip's first frames with no kernel launched.  Returns the launches of
    the CPU-traced CUDA program's clip."""
    from stabnet_tpu_torch.cli.main import main as cli
    from stabnet_tpu_torch.stream import StreamEngine
    from stabnet_tpu_torch.stream.export import (ExportedEngine, _load_program,
                                                 load_artifact, select_program)

    cfg, T, T_CPU = engine.cfg, clips.shape[1], 2
    zero = {k: 0 for k in launch_counts()}
    want = zero | {"warp_mesh": T - 1, "warp_uint8_cf_lowres": T - 1}
    live, live_launches = serve_clip(engine, clips[0])
    check(live_launches == want, f"live launches {live_launches}")
    cpu_engine = StreamEngine(random_model(cfg, 0), cfg, refine=engine.refine, device="cpu")
    cpu_live, _ = serve_clip(cpu_engine, clips[0, :T_CPU])

    def same(a, b, what):
        check(np.array_equal(a.frames, b.frames) and np.array_equal(a.all_black, b.all_black)
              and a.crop_rect == b.crop_rect, f"{what}: not bit for bit")

    notes, moved_launches = [], None
    for traced, platforms in (("cuda", ["cuda", "cpu"]), ("cpu", ["cpu", "cuda"])):
        path = os.path.join(tmp, f"traced_{traced}.stbx")
        t0 = time.perf_counter()
        cli(["export", "--config", cfg.name, "--out", path, "--output-size",
             *map(str, CLIP_HW), "--device", traced, "--platforms", *platforms,
             "--selftest"])
        wall = time.perf_counter() - t0
        blob, meta = load_artifact(path)
        spans = [tuple(meta["programs"][p]["step"]) for p in platforms]
        check(meta["platforms"] == platforms and list(meta["programs"]) == platforms
              and spans[0][0] == 0 and spans[1][0] == spans[0][1]
              and sum(n for _, n in spans) == len(blob), f"traced on {traced}: header {meta}")
        targets = [str(n.target) for n in _load_program(select_program(blob, meta, "cuda")[0])
                   .graph.nodes if n.op == "call_function"]
        check(targets.count("stabnet.warp_mesh.default") == 1
              and targets.count("stabnet.warp_uint8_cf_lowres.default") == 1,
              f"traced on {traced}: the CUDA program's kernels {targets}")
        specific = sorted({t for t in targets
                           if any(k in t for k in ("cudnn", "miopen", "mkldnn", "_cuda"))})
        check(not specific, f"traced on {traced}: device-specific operations {specific}")
        runs = {}
        for device, clip, ref in (("cuda", clips[0], live), ("cpu", clips[0, :T_CPU], cpu_live)):
            served = ExportedEngine.from_artifact(blob, meta, device=device)
            res, launches = serve_clip(served, clip)
            same(res, ref, f"traced on {traced}, the {device} program")
            if device == "cuda":
                exported_vs_program(served, host_grays(clips[:1, :5], cfg), clips[:1, :5],
                                    f"traced on {traced}, the cuda program's graph")
            check(launches == (want if device == "cuda" else zero),
                  f"traced on {traced}, the {device} program: launches {launches}")
            runs[device] = launches
            del served
        if traced == "cpu":
            moved_launches = runs["cuda"]
        notes.append(f"traced on {traced} for {' '.join(platforms)}: {wall:.2f} s through the "
                     f"CLI with --selftest, {os.path.getsize(path)} B, programs "
                     f"{dict(zip(platforms, [n for _, n in spans]))} B; the cuda program's "
                     f"graph torch.equal the program called eagerly over 4 frames, its "
                     f"{T}-frame clip bit for bit the live card engine, launches "
                     f"{runs['cuda']}; the cpu program's {T_CPU}-frame clip bit for bit the "
                     f"live CPU engine, launches {runs['cpu']}")
    print(f"[16 platforms] {card} | {cfg.name} {cfg.compute_dtype} {CLIP_HW[0]}p, "
          f"`export --platforms`, no cuDNN-, MKLDNN- or CUDA-specific operation in either "
          f"CUDA program's graph: " + "; ".join(notes))
    return moved_launches


DP_RANK = "_dp_rank"     # argv[1] of a rank process that phase 17 starts
DP_GRAPH = "_dp_graph"   # argv[1] of phase 17 (a')'s rank process
DP_ONLY = "_dp_only"     # argv[1] for phase 17 alone (after phase 1 and the shards)


def dp_rank(mode: str, argv) -> int:
    """One process of phase 17: the port's CLI with `argv`, then its kernel
    launches as a JSON line and the train steps that went through the
    compiled path (`_replay`).  `mode` is words joined by "+": "det" asks
    cuDNN for its deterministic algorithms (two processes then compare bit
    for bit); "f32" turns TF32 off (the comparison in float32 that the CPU
    test makes); "eager" keeps the steps eager in this process (the eager
    NCCL ranks that (c) holds the graph ranks to)."""
    from stabnet_tpu_torch.cli.main import main as cli
    from stabnet_tpu_torch.train import train as train_mod

    words = mode.split("+")
    torch.backends.cudnn.deterministic = "det" in words
    torch.backends.cudnn.allow_tf32 = "f32" not in words
    torch.backends.cuda.matmul.allow_tf32 = False
    if "eager" in words:
        train_mod._compiled = lambda state: False
    keys, replay = [], train_mod._replay

    def counted(state, key, *args):
        keys.append(key[0])
        return replay(state, key, *args)

    train_mod._replay = counted
    cli(argv)
    torch.cuda.synchronize()
    rank = int(os.environ.get("RANK", 0))
    print("LAUNCHES " + json.dumps({"rank": rank, **launch_counts()}), flush=True)
    print("COMPILED " + json.dumps({"rank": rank, "train_steps": keys.count("train_step")}),
          flush=True)
    return 0


def free_ports(n: int):
    """`n` distinct free TCP ports on localhost (held open together while
    they are chosen)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def start_ranks(nproc, entry, port=None, env=None):
    """Start this script with the arguments `entry` (`[DP_RANK, mode,
    *argv]` or `[DP_GRAPH, ...]`) in `nproc` ranks under
    torch.distributed.run at `port` (nproc None: one process without a
    launcher), with `env` added to the environment; `finish_ranks` waits
    for it."""
    here = os.path.abspath(__file__)
    cmd = [sys.executable, here, *entry]
    if nproc is not None:
        port = port or free_ports(1)[0]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
               "--master-addr", "localhost", "--master-port", str(port), here, *entry]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(here), env={**os.environ, **(env or {})})
    return cmd, proc, time.perf_counter()


def finish_ranks(started, timeout: int = 300):
    """Wait for `start_ranks`' processes; returns each rank's launches, the
    wall seconds, and the processes' standard output and error."""
    cmd, proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{' '.join(cmd[:8])}: exit {proc.returncode}\n"
          f"{out[-3000:]}\n{err[-3000:]}")
    return tagged(out, "LAUNCHES"), wall, out, err


def tagged(out: str, tag: str):
    """The JSON objects of `out`'s lines that start with `tag`, by their
    "rank" (removed)."""
    rows = [json.loads(ln[len(tag) + 1:]) for ln in out.splitlines() if ln.startswith(tag + " ")]
    return sorted(rows, key=lambda r: r.pop("rank", 0))


def run_ranks(nproc, mode: str, argv, timeout: int = 300):
    """`start_ranks` then `finish_ranks`."""
    return finish_ranks(start_ranks(nproc, [DP_RANK, mode, *argv]), timeout)


def logged(log_dir: str):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["tag"] == "train"]


def dp_graph(go: str) -> int:
    """Phase 17 (a'): one NCCL rank (a world of one, under
    torch.distributed.run), on BatchNorm's own branch and with its
    across-ranks branch forced (this process's `resnet._ranks` patched to
    2, so its all-reduces run and are captured).  Per branch, beside the
    other runs of phase 17: phase 9's `train_graph_run` (f32, TF32 off,
    batch 2, six gate-crossing steps, the graph torch.equal the eager step,
    both under the deterministic algorithms: with TF32 off two default-mode
    eager runs differ on the H100) and the eval graph against `eval_step`.
    Then, once the file `go` exists (the other runs have ended, so the card
    is this process's), per branch v2_93 bf16 batch 10 on one batch:
    synchronized ms/step over 10 steps in turns graph, eager, graph, and
    per step the device operations, the NCCL kernels among them and the
    host launches; the graph's capture seconds and pool bytes.  Prints one
    "DPGRAPH {...}" line."""
    import torch.distributed as dist

    from stabnet_tpu_torch.data import augment_batch, make_raw_batch, prepare_raw
    from stabnet_tpu_torch.models import resnet
    from stabnet_tpu_torch.parallel import initialize_distributed
    from stabnet_tpu_torch.train import (create_train_state, eval_step, make_eval_step,
                                         make_train_step, train_step)

    t0 = time.perf_counter()
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    initialize_distributed(backend="nccl")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "not one NCCL rank")
    own, out, seconds = resnet._ranks, {}, {"setup": time.perf_counter() - t0}
    branches = {"own": own, "across": lambda: 2}
    try:
        torch.backends.cudnn.allow_tf32 = False
        for name, ranks in branches.items():
            resnet._ranks = ranks
            t0 = time.perf_counter()
            summary, state, cfg, batches = train_graph_run(dev, eager_spread=False)
            want = eval_step(state, batches[0], cfg)
            evaluate = make_eval_step(cfg)
            got = [evaluate(state, batches[0]) for _ in range(2)]
            summary["eval_equal"] = all(torch.equal(g[k], want[k]) for g in got for k in want)
            out[name] = {"equality": summary}
            del state
            gc.collect()
            torch.cuda.empty_cache()
            seconds[f"equality {name}"] = time.perf_counter() - t0
        torch.backends.cudnn.allow_tf32 = True
        t0 = time.perf_counter()
        while not os.path.exists(go):
            check(time.perf_counter() - t0 < 300, "phase 17's other runs did not end")
            time.sleep(0.1)
        seconds["wait"] = time.perf_counter() - t0
        cfg = live_config()
        batch = augment_batch(torch.Generator().manual_seed(0),
                              {k: torch.from_numpy(v).to(dev) for k, v in
                               prepare_raw(make_raw_batch(cfg, cfg.batch_size, seed=0)).items()},
                              cfg)
        for name, ranks in branches.items():
            resnet._ranks = ranks
            t0 = time.perf_counter()
            state = create_train_state(cfg, device=dev, seed=0)
            steps = {"graph": make_train_step(cfg), "eager": lambda s, b: train_step(s, b, cfg)}
            for _ in range(3):             # the first call captures
                state, aux = steps["graph"](state, batch)
            timing = {}
            for mode in ("graph", "eager", "graph"):
                ms = []
                for _ in range(10):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    state, aux = steps[mode](state, batch)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t1) * 1e3)
                check(math.isfinite(float(aux["total"])), f"non-finite loss ({name}, {mode})")
                timing.setdefault(mode, {"p50_ms": [], "min_ms": [], "max_ms": []})
                timing[mode]["p50_ms"].append(float(np.median(ms)))
                timing[mode]["min_ms"].append(min(ms))
                timing[mode]["max_ms"].append(max(ms))
            for mode in ("graph", "eager"):
                device, host = device_events(lambda: steps[mode](state, batch))
                timing[mode].update(
                    device_ops=len(device), host_launches=host,
                    kernels_ms=sum(e.duration_ns() for e in device) / 1e6,
                    nccl=sum(1 for e in device if "nccl" in e.name().lower()))
            st = state.graphs.stats()[0]
            timing["capture_s"], timing["warmup_s"] = st["capture_s"], st["warmup_s"]
            timing["pool_bytes"] = st["pool_bytes"]
            out[name]["timing"] = timing
            del state, steps
            gc.collect()
            torch.cuda.empty_cache()
            seconds[f"timing {name}"] = time.perf_counter() - t0
    finally:
        resnet._ranks = own
        dist.destroy_process_group()
    out["seconds"] = {k: round(v, 1) for k, v in seconds.items()}
    print("DPGRAPH " + json.dumps(out), flush=True)
    return 0


def phase_data_parallel(card: str, dev, tmp: str, data: str):
    """`train --data-parallel` through the CLI on phase 8's shards, 2 steps:
    (a) one NCCL rank against the plain run, v2_93 bf16 batch 10, bit for
    bit, both replaying graphs; (a') one NCCL rank in a process of its own
    (`dp_graph`): graph against eager on both BatchNorm branches, and their
    times; (b) two gloo ranks on the one card, global batch 10, eager,
    against one process on the merged batch, in f32 (TF32 off), within the
    CPU test's bound; (c) on a machine with two or more cards, two NCCL
    ranks on two cards replaying graphs, bit for bit the same ranks kept
    eager, and both within that bound.  The runs start at once; (a')
    times its steps once the others have ended.  Returns the launches of
    one rank of (b)."""
    from stabnet_tpu_torch.data import augment
    from stabnet_tpu_torch.data.pipeline import batch_iterator, ensure_flow
    from stabnet_tpu_torch.parallel import form_global_batch
    from stabnet_tpu_torch.train.state import create_train_state
    from stabnet_tpu_torch.train.train import train_step

    steps = 2
    base = ["train", "--config", "v2_93", "--data", data, "--seed", "0", "--steps",
            str(steps), "--set", "disp_freq=1", *TRAIN_LIVE]
    per_rank = {k: 0 for k in launch_counts()} | {
        "bilinear_sample": 2 * steps, "bilinear_splat": steps, "sample_map_grad": steps}

    def args(name, *extra):
        return base + ["--model-dir", os.path.join(tmp, name, "models"),
                       "--log-dir", os.path.join(tmp, name, "log"), *extra]

    # The runs share nothing but the card, so they run at once; each
    # compares by values (cuDNN's deterministic algorithms, or a bound).
    # (b) sees one card, so its two ranks share it under gloo on any machine.
    f32 = ("--data-parallel", "--set", "compute_dtype=float32")
    runs = [("plain", None, "det", (), {}, steps),
            ("nccl1", 1, "det", ("--data-parallel",), {}, steps),
            ("gloo2", 2, "f32", f32, {"CUDA_VISIBLE_DEVICES": "0"}, 0)]
    cards = torch.cuda.device_count()
    if cards >= 2:
        runs += [("nccl2", 2, "det+f32", f32, {}, steps),
                 ("nccl2eager", 2, "det+f32+eager", f32, {}, 0)]
    ports = free_ports(len(runs) + 1)
    go = os.path.join(tmp, "dp_graph_go")
    started = {"graph1": start_ranks(1, [DP_GRAPH, go], ports[-1])}
    try:
        for (name, nproc, mode, extra, env, _), port in zip(runs, ports):
            started[name] = start_ranks(nproc, [DP_RANK, mode, *args(name, *extra)], port, env)
        out = {}
        for name, nproc, _, _, _, compiled in runs:
            ranks, wall, stdout, _ = finish_ranks(started.pop(name))
            check(ranks == [per_rank] * (nproc or 1),
                  f"{name}: launches per rank {ranks}, expected {per_rank}")
            got = [r["train_steps"] for r in tagged(stdout, "COMPILED")]
            check(got == [compiled] * (nproc or 1),
                  f"{name}: train steps through the graphs per rank {got}, expected {compiled}")
            out[name] = (logged(os.path.join(tmp, name, "log")), wall)
        open(go, "w").close()
        _, wall_g, stdout, _ = finish_ranks(started.pop("graph1"))
    finally:
        for _, proc, _ in started.values():
            proc.kill()
            proc.communicate()
    (graph1,) = tagged(stdout, "DPGRAPH")
    graph1_seconds = graph1.pop("seconds")
    keys = [k for k in out["plain"][0][0] if not k.endswith("_ms")]
    vals = {n: [[r[k] for k in keys] for r in rows] for n, (rows, _) in out.items()}
    check(vals["nccl1"] == vals["plain"], "one NCCL rank differs from the plain run: "
          f"{vals['nccl1']} against {vals['plain']}")

    # One process on the merged batch of the two ranks' local batches.
    torch.backends.cudnn.allow_tf32 = False
    cfg = live_config(compute_dtype="float32")
    state = create_train_state(cfg, device=dev, seed=0)
    its = [batch_iterator(os.path.join(data, "train"), cfg, seed=0, batch_size=5,
                          shard=(r, 2)) for r in range(2)]
    gen = torch.Generator().manual_seed(0)
    want, step_ms = [], []
    for _ in range(steps):
        raw = augment.prepare_raw(ensure_flow(form_global_batch([next(it) for it in its])))
        batch = augment.augment_batch(
            gen, {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = train_step(state, batch, cfg)
        want.append(float(aux["total"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.backends.cudnn.allow_tf32 = True
    del state

    def rel(name):
        return max(abs(r["total"] - w) / abs(w) for r, w in zip(out[name][0], want))

    ms = {n: [round(r["step_ms"], 3) for r in rows] for n, (rows, _) in out.items()}
    parts = []
    for name, g in graph1.items():
        eq, t = g["equality"], g["timing"]
        parts.append(
            f"{name} branch: graph against eager {eq['gap']} (rule {eq['rule']!r}, "
            f"launches {eq['launches']}, eval graph equal {eq['eval_equal']}, capture "
            f"{eq['graph']['capture_s']:.3f} s, pool {eq['graph']['pool_bytes']} B); bf16 "
            f"batch 10 ms/step p50 graph {[round(v, 3) for v in t['graph']['p50_ms']]} "
            f"(min {min(t['graph']['min_ms']):.3f}), eager "
            f"{[round(v, 3) for v in t['eager']['p50_ms']]}; per step graph/eager: device "
            f"operations {t['graph']['device_ops']}/{t['eager']['device_ops']}, kernels "
            f"{t['graph']['kernels_ms']:.3f}/{t['eager']['kernels_ms']:.3f} ms, NCCL kernels "
            f"{t['graph']['nccl']}/{t['eager']['nccl']}, host launches "
            f"{t['graph']['host_launches']}/{t['eager']['host_launches']}; capture "
            f"{t['capture_s']:.3f} s after an eager first call of {t['warmup_s']:.3f} s, "
            f"pool {t['pool_bytes']} B")
    if cards >= 2:
        two = (f"(c) two NCCL ranks on two cards (global batch 10, f32, TF32 off, cuDNN "
               f"deterministic), graphs {[r['total'] for r in out['nccl2'][0]]} against the "
               f"same ranks eager {[r['total'] for r in out['nccl2eager'][0]]}, max rel to "
               f"one process {rel('nccl2'):.3g}; step ms rank 0 graph {ms['nccl2']}, eager "
               f"{ms['nccl2eager']}")
    else:
        two = f"(c) not run: {cards} card"
    print(f"[17 data parallel] {card} | train --data-parallel through the CLI on phase 8's "
          f"shards, {steps} steps, launches per rank {per_rank}: (a) v2_93 bf16 batch 10, "
          f"one NCCL rank under torch.distributed.run replaying graphs, equal to the plain "
          f"run bit for bit (losses {[r['total'] for r in out['plain'][0]]}), the loop's "
          f"unsynchronized step stage ms plain {ms['plain']}, NCCL rank {ms['nccl1']}, "
          f"command wall {out['plain'][1]:.1f} and {out['nccl1'][1]:.1f} s, the runs at "
          f"once; (a') one NCCL rank in a process of its own ({wall_g:.1f} s; by part "
          f"{graph1_seconds}): "
          + "; ".join(parts)
          + f"; (b) f32 TF32 off, two gloo ranks on the one card, eager (global batch 10, 5 "
          f"each): losses {[r['total'] for r in out['gloo2'][0]]} against one process on the "
          f"merged batch {want}, max rel {rel('gloo2'):.3g} (need <= 3.4e-3), step ms rank 0 "
          f"{ms['gloo2']}, one process {[round(v, 3) for v in step_ms]}, command wall "
          f"{out['gloo2'][1]:.1f} s; " + two)
    for name, g in graph1.items():
        check(not g["equality"]["problems"], f"(a') {name} branch: "
              + "; ".join(g["equality"]["problems"]))
        check(g["equality"]["eval_equal"], f"(a') {name} branch: the eval graph differs "
              "from eval_step")
        t = g["timing"]
        check(t["graph"]["nccl"] == t["eager"]["nccl"],
              f"(a') {name} branch: NCCL kernels per step graph {t['graph']['nccl']}, "
              f"eager {t['eager']['nccl']}")
    check(rel("gloo2") <= 3.4e-3, "two gloo ranks and one process on the merged batch "
          "disagree")
    if cards >= 2:
        check(vals["nccl2"] == vals["nccl2eager"], "two NCCL ranks: the graphs differ from "
              f"the eager steps: {vals['nccl2']} against {vals['nccl2eager']}")
        check(rel("nccl2") <= 3.4e-3, "two NCCL ranks and one process on the merged batch "
              "disagree")
    return per_rank


def phase_sharded(card: str, dev, engine, clips: np.ndarray):
    """Batch serving split over two replicas on the one card against each
    shard alone, and over the card's one replica (the driver's default
    devices) against the unsharded batch.  Returns the sharded run's
    launches."""
    from stabnet_tpu_torch.ops import cuda_warp
    from stabnet_tpu_torch.stream import DeployOptions, StreamDriver
    from stabnet_tpu_torch.stream.engine import init_state, scan_frames

    cfg, (S, T) = engine.cfg, clips.shape[:2]
    grays = host_grays(clips, cfg)
    cuda_warp.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warped, state = engine.stabilize_clips_sharded(grays, clips, devices=[dev, dev])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = launch_counts()
    want = {k: 0 for k in launches} | {"warp_mesh": 2 * (T - 1),
                                       "warp_uint8_cf_lowres": 2 * (T - 1)}
    check(launches == want, f"sharded launches {launches}, expected {want}")
    half = S // 2
    g, c = torch.from_numpy(grays).to(dev), torch.from_numpy(clips).to(dev)
    for lo in (0, half):
        alone, st = engine.stabilize_clip(grays[lo: lo + half], clips[lo: lo + half])
        check(torch.equal(warped[lo: lo + half], alone)
              and torch.equal(state.all_black[lo: lo + half], st.all_black),
              f"shard {lo // half} differs from its own run at S={half}")
        part = slice(lo, lo + half)
        ww, wst = scan_frames(engine.model, init_state(g[part, 0], cfg), g[part, 1:],
                              c[part, 1:], cfg)
        held_equal(f"shard {lo // half}", warped[part],
                   state._replace(frames=state.frames[part], masks=state.masks[part],
                                  all_black=state.all_black[part]), ww, wst)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    driver = StreamDriver(engine, DeployOptions())
    a = driver.stabilize_batch(list(clips), sharded=True)
    b = driver.stabilize_batch(list(clips))
    for x, y in zip(a, b):
        check(np.array_equal(x.frames, y.frames) and np.array_equal(x.all_black, y.all_black)
              and x.crop_rect == y.crop_rect, "sharded over the card's one replica differs")
    print(f"[18 sharded] {card} | {cfg.name} {cfg.compute_dtype} {CLIP_HW[0]}p, {S} clips "
          f"of {T} frames: "
          f"stabilize_clips_sharded over two replicas on cuda:0 (interleaved steps) in "
          f"{t1 - t0:.3f} s (a graph per replica), launches {launches}, each shard bit "
          f"for bit its own run at S={half} ({t2 - t1:.3f} s for both) and the eager "
          f"scan_frames there (frames, ring, all_black, crop); stabilize_batch(sharded=True) over the "
          f"card's one replica equal to the unsharded batch bit for bit, "
          f"{a[0].fps_net:.2f} and {b[0].fps_net:.2f} frames/s")
    return launches


# The doctor's names of the kernels, by their wrappers' names.
DOCTOR_NAMES = {"warp_uint8_cf_lowres": "K1", "bilinear_sample": "K2", "warp_mesh": "K2m",
                "warp_uint8_cf": "K3", "bilinear_splat": "K4", "sample_map_grad": "K6b"}


def run_doctor_cli(*argv, env=None, timeout: float = 300):
    """`doctor` through the port's CLI in a process of its own: (exit code,
    report, wall seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "stabnet_tpu_torch.cli.main", "doctor",
                           "--compact", *argv], capture_output=True, text=True, cwd=here,
                          timeout=timeout, env=dict(os.environ, **(env or {})))
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(bool(lines), f"doctor {argv}: no report (exit {proc.returncode})\n{proc.stderr[-3000:]}")
    return proc.returncode, json.loads(lines[-1]), wall


def phase_doctor(card: str):
    """`doctor` on the card: every check passes, the backend is this card at
    compute capability 9.0, every kernel launched once per call and equal to
    its plain version; then a wedged backend (the test hook) reported within
    15 s with exit 1.  Returns each kernel's launches in the doctor's probe."""
    rc, report, wall = run_doctor_cli()
    checks = report["checks"]
    check(rc == 0 and report["ok"], f"doctor failed (exit {rc}): {json.dumps(report)}")
    backend, kernels = checks["backend"], checks["kernels"]
    check(backend["name"] == torch.cuda.get_device_name(0) and backend["capability"] == [9, 0],
          f"doctor's backend {backend}")
    check(checks["host"]["ok"] and checks["mesh"]["ok"]
          and checks["mesh"]["all_reduce_sum"] == 496.0, f"doctor's host and mesh {checks}")
    check(kernels["device"] == "cuda" and set(kernels["kernels"]) == set(DOCTOR_NAMES.values()),
          f"doctor's kernels {kernels}")
    for name, k in kernels["kernels"].items():
        check(k["ok"] and k["launches"] == k["calls"] and k["max_abs_err"] == 0.0,
              f"doctor's kernel {name}: {k}")
    rc_hang, hung, hang_wall = run_doctor_cli(
        "--only", "backend", "--timeout", "5", env={"STABNET_DOCTOR_FAKE_HANG": "backend"},
        timeout=60)
    check(rc_hang == 1 and hang_wall < 15.0 and not hung["ok"]
          and "did not respond" in hung["checks"]["backend"]["error"],
          f"the wedged backend: exit {rc_hang} after {hang_wall:.1f} s, {json.dumps(hung)}")
    print(f"[19 doctor] {card} | doctor through the CLI in {wall:.1f} s, all checks ok: "
          f"backend {backend['name']} capability {backend['capability']}, "
          f"{backend['memory_gb']} GB ({backend['memory_in_use_gb']} in use), first "
          f"computation read back {backend['first_compute_seconds']} s after the probe's "
          f"start, probe {backend['seconds']} s; kernels built in {kernels['build_seconds']} s "
          f"(cached by phase 1), probe {kernels['seconds']} s, each bit for bit its plain "
          f"version: " + ", ".join(f"{n} {k['launches']} launches ({k['calls']} calls)"
                                   for n, k in kernels["kernels"].items())
          + f"; host {checks['host']['cpus']} CPUs, mesh probe {checks['mesh']['seconds']} s;"
          f" a wedged backend reported in {hang_wall:.1f} s (deadline 5 s) with exit 1")
    return {fn: kernels["kernels"][k]["launches"] for fn, k in DOCTOR_NAMES.items()}


def debug_forward_k2m(data: str, ckpt_dir: str) -> float:
    """The debug dump's forward as `train --debug-vis` runs it (the model
    in eval mode on an augmented v2_93 training batch of 10, the current
    frame read in place from the channels-last 13-channel x1 stack), with
    the weights of `ckpt_dir`: one K2m launch, its output, mask and maps
    bit for bit `warp_mesh_plain` on the same frame and homographies.
    Returns the max abs error."""
    from stabnet_tpu_torch.data.pipeline import InputPipeline
    from stabnet_tpu_torch.models.stabnet import current_frame, forward
    from stabnet_tpu_torch.ops import cuda_warp, mesh_tables
    from stabnet_tpu_torch.train.state import create_train_state

    cfg = live_config()
    dev = torch.device("cuda")
    pipe = InputPipeline(os.path.join(data, "train"), cfg, seed=0, device=dev)
    try:
        x1 = next(pipe)["x1"]
    finally:
        pipe.close()
    check(tuple(x1.shape) == (10, cfg.height, cfg.width, 13) and x1.stride(2) == 13,
          f"debug forward: x1 {tuple(x1.shape)} at strides {x1.stride()}")
    model = create_train_state(cfg, device=dev, seed=0).model
    model.load_state_dict(torch.load(os.path.join(ckpt_dir, "state.pt"), map_location=dev,
                                     weights_only=True)["model"])
    model.eval()
    before = cuda_warp.warp_mesh.launches
    out = forward(model, x1, cfg).warp
    check(cuda_warp.warp_mesh.launches - before == 1,
          f"debug forward: {cuda_warp.warp_mesh.launches - before} K2m launches")
    got = (out.output, out.black_pix, out.x_map, out.y_map)
    want = cuda_warp.warp_mesh_plain(current_frame(x1, cfg), out.Hs,
                                     mesh_tables(cfg.height, cfg.width, cfg.grid_h,
                                                 cfg.grid_w, dev))
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"debug forward at (10, {cfg.height}, {cfg.width}): K2m max abs {err} to its "
          f"plain version")
    return err


def phase_debug_vis(card: str, tmp: str, data: str):
    """`train --debug-vis --set test_freq=2` through the CLI on phase 8's
    shards, v2_93 bf16 batch 10, 4 steps, against the same run without it,
    both with cuDNN's deterministic algorithms: K2m once per dump (steps 0,
    2 and 3) and the training kernels' per-step launches; the losses and
    the step-4 checkpoint bit for bit.  Returns the debug run's launches."""
    steps, dumps = 4, 3
    base = ["train", "--config", "v2_93", "--data", data, "--seed", "0", "--steps",
            str(steps), "--set", "disp_freq=1", "--set", "test_freq=2", *TRAIN_LIVE]
    runs = {}
    for name, extra in (("vis", ["--debug-vis"]), ("plain", [])):
        out = os.path.join(tmp, f"debug_{name}")
        (launches,), wall, _, err = run_ranks(None, "det", base + [
            "--model-dir", os.path.join(out, "models"), "--log-dir", os.path.join(out, "log"),
            *extra])
        runs[name] = (launches, wall, err, out)
    per_step = {k: 0 for k in DOCTOR_NAMES} | {
        "bilinear_sample": 2 * steps, "bilinear_splat": steps, "sample_map_grad": steps}
    check(runs["plain"][0] == per_step, f"train without --debug-vis: {runs['plain'][0]}")
    want = per_step | {"warp_mesh": dumps}
    check(runs["vis"][0] == want, f"train --debug-vis: launches {runs['vis'][0]}, "
          f"expected {want}")
    rows = {n: logged(os.path.join(r[3], "log")) for n, r in runs.items()}
    keys = [k for k in rows["plain"][0] if not k.endswith("_ms")]
    check([[r[k] for k in keys] for r in rows["vis"]]
          == [[r[k] for k in keys] for r in rows["plain"]],
          "the losses with --debug-vis differ from the run without it")
    a, b = (torch.load(os.path.join(r[3], "models", str(steps), "state.pt"),
                       map_location="cpu", weights_only=True)["model"] for r in runs.values())
    check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
          "the step-4 checkpoint with --debug-vis differs from the run without it")
    k2m_err = debug_forward_k2m(data, os.path.join(runs["vis"][3], "models", str(steps)))
    debug_dir = os.path.join(runs["vis"][3], "log", "debug")
    try:
        import cv2
        dumped = sorted({n[:10] for n in os.listdir(debug_dir)})
        check(dumped == ["step000000", "step000002", "step000003"], f"dumps {dumped}")
        written = f"OpenCV {cv2.__version__} here: mosaics written for steps {dumped}"
    except ImportError:
        # No OpenCV on this machine: save_debug_batch warns and returns [].
        warned = runs["vis"][2].count("cv2 unavailable; skipping debug dump")
        check(warned == dumps and not os.path.exists(debug_dir),
              f"{warned} warnings of the missing OpenCV, debug dir {os.path.exists(debug_dir)}")
        written = f"no OpenCV here: {warned} warnings logged, nothing written"
    ms = {n: [round(r["step_ms"], 3) for r in rr] for n, rr in rows.items()}
    import importlib.util

    written += ("; TensorFlow installed" if importlib.util.find_spec("tensorflow")
                else "; no TensorFlow here")
    print(f"[20 debug-vis] {card} | train --debug-vis --set test_freq=2 through the CLI on "
          f"phase 8's shards, v2_93 bf16 batch 10, {steps} steps, cuDNN deterministic: "
          f"launches {runs['vis'][0]} (K2m once per dump, at steps 0, 2 and 3); the debug "
          f"forward rerun here on a (10, 288, 512, 13) training batch with the step-{steps} "
          f"weights: K2m once, max abs {k2m_err:.3g} to its plain version (tolerance 0) on the "
          f"output, mask and maps; losses and the "
          f"step-{steps} checkpoint (weights and BN running statistics) bit for bit the run "
          f"without it (launches {runs['plain'][0]}); {written}; step ms with "
          f"{ms['vis']}, without {ms['plain']}; command wall {runs['vis'][1]:.1f} and "
          f"{runs['plain'][1]:.1f} s")
    return runs["vis"][0]


# --- the bench -----------------------------------------------------------

# Each of the bench's six legs, in its order, at its defaults (T=61, 2
# repeats after one warm-up run): a stats key it reports and the serving
# steps it runs, each step one K1 and one K2m launch.  The slope leg's short
# clip has 21 frames; the online leg steps 3 x 8 frames.
BENCH_LEGS = (("batch", "fps_720p_batch6_per_chip", 3 * 60),
              ("out2", "fps_1080p_batch6_per_chip", 3 * 60),
              ("single_stream", "fps_720p_single_stream", 3 * 60),
              ("latency_slope", "online_frame_latency_device_ms_slope", 3 * 20),
              ("online_latency", "online_latency_device_p50_ms", 3 * 8),
              ("pipelined", "online_pipelined_wall_fps", 60))


def phase_bench(card: str):
    """`bench` through the port's CLI at its defaults in a process of its
    own, under a 300 s deadline: exit 0, all six legs, the headline above 0,
    p90 >= p50, the MFU share in (0, 1.05], the card's name and power limit
    on the stats line.  The stats line after each leg carries the bench
    process's launch counts: each leg must add K1 and K2m once per serving
    step it ran (warm-ups included) and no other kernel.  Returns the whole
    run's launches."""
    from stabnet_tpu_torch import bench

    gc.collect()
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if not k.startswith("STABNET_BENCH_")}
    env["STABNET_BENCH_DEADLINE_S"] = "300"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "stabnet_tpu_torch.cli.main", "bench"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=420)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    check("restored completed legs" not in proc.stderr,
          f"bench retried an attempt, its launches are split:\n{proc.stderr[-4000:]}")
    heads = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    stats = [json.loads(ln) for ln in proc.stderr.splitlines() if ln.startswith("{")]
    check(len(heads) == len(stats) == len(BENCH_LEGS),
          f"bench printed {len(heads)} headline and {len(stats)} stats lines, one per "
          f"leg expected:\n{proc.stderr[-4000:]}")
    head, st = heads[-1], stats[-1]
    missing = [leg for leg, key, _ in BENCH_LEGS if st.get(key) is None]
    check(not missing, f"bench legs missing {missing}:\n{proc.stderr[-4000:]}")
    check(head["metric"] == "stabilized_720p_throughput" and head["value"] > 0
          and head["vs_baseline"] is None, f"bench headline {head}")
    check(st["online_latency_device_p90_ms"] >= st["online_latency_device_p50_ms"],
          f"bench device latency p90 {st['online_latency_device_p90_ms']} < p50 "
          f"{st['online_latency_device_p50_ms']}")
    check(st["flops_per_frame_g"] == 22.780889088 and 0 < st["mfu_vs_bf16_peak"] <= 1.05,
          f"bench MFU {st['mfu_vs_bf16_peak']} at {st['flops_per_frame_g']} GFLOP/frame")
    check(st["device"] == torch.cuda.get_device_name(0) and st["power_limit_w"] is not None,
          f"bench device {st['device']}, power limit {st['power_limit_w']}")
    before = {k: 0 for k in DOCTOR_NAMES}
    for (leg, key, steps), line in zip(BENCH_LEGS, stats):
        # The batch leg runs S streams on every card, one launch per card.
        per_leg = steps * (st["n_devices"] if leg == "batch" else 1)
        got = {k: line["kernel_launches"][k] - before[k] for k in before}
        want = {k: 0 for k in before} | {"warp_mesh": per_leg, "warp_uint8_cf_lowres": per_leg}
        check(key in line and got == want,
              f"bench leg {leg}: launches {got}, expected {want}")
        before = line["kernel_launches"]
    marks = [ln[len("bench: "):] for ln in proc.stderr.splitlines() if ln.startswith("bench: +")]
    print(f"[21 bench] {card} | cli.main bench at its defaults in {wall:.1f} s, exit 0, six "
          f"legs: {head['value']} frames/s per card at 720p S=6, 1080p "
          f"{head['fps_1080p_per_chip']}, MFU {st['mfu_vs_bf16_peak']} of "
          f"{bench.peak_tflops(st['device'])} TFLOP/s bf16 at {st['flops_per_frame_g']} "
          f"GFLOP/frame, device latency p50 {st['online_latency_device_p50_ms']} p90 "
          f"{st['online_latency_device_p90_ms']} ms; launches per leg "
          f"{[steps for _, _, steps in BENCH_LEGS]} each of K1 and K2m, no other kernel | "
          f"{'; '.join(marks)}")
    print(f"[21 bench] stats {json.dumps(st)}")
    print(f"[21 bench] headline {json.dumps(head)}")
    return before


# --- the quality gate and the endurance run --------------------------------

GATE = "_gate"   # argv[1] of the quality gate's process that phase 22 starts
GATE_ARGS = ["--steps", "100", "--clips", "2", "--frames", "40"]


def gate_process(argv) -> int:
    """Phase 22's process: scripts/torch_quality_gate.py's `main` with
    `argv`, the launches of its training, of each batch it serves and of
    each clip it scores counted around those calls, printed as a JSON line
    on stderr after the report."""
    import importlib.util

    import stabnet_tpu_torch.eval as evaluation
    from stabnet_tpu_torch.stream import StreamDriver

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "torch_quality_gate", os.path.join(here, "scripts", "torch_quality_gate.py"))
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    record = {}

    def counted(name, fn):
        def call(*args, **kwargs):
            before = launch_counts()
            out = fn(*args, **kwargs)
            after = launch_counts()
            record.setdefault(name, []).append({k: after[k] - before[k] for k in after})
            return out
        return call

    gate.train_model = counted("train", gate.train_model)
    StreamDriver.stabilize_batch = counted("serve", StreamDriver.stabilize_batch)
    evaluation.score_stabilized_clip = counted("score", evaluation.score_stabilized_clip)
    rc = gate.main(argv)
    print("GATE_LAUNCHES " + json.dumps(record), file=sys.stderr, flush=True)
    return rc


def phase_quality_gate(card: str, tmp: str):
    """scripts/torch_quality_gate.py at a short schedule in a process of its
    own: exit 0 or 1 as its report says (a pass is not required at 100
    steps), every check of the JAX gate present, and the launches: per
    training step K2 2, K4 1 and K6b 1; per served frame K2m and K1 once
    (each of the two batches: trained and random weights); per scored clip
    20 K2 in each tvl1_flow call, nothing else.  Returns the whole run's
    launches."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, os.path.abspath(__file__), GATE, *GATE_ARGS,
           "--workdir", os.path.join(tmp, "gate")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=here)
    wall = time.perf_counter() - t0
    check(proc.returncode in (0, 1), f"quality gate exit {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    checks = ("stabilizes_vs_input", "beats_random_majority", "beats_random_margin",
              "cropping_sane", "distortion_sane", "per_clip_distortion_floor")
    check(list(report["checks"]) == list(checks)
          and proc.returncode == (0 if report["pass"] else 1)
          and report["pass"] == all(report["checks"].values()),
          f"quality gate report {report}")
    record = json.loads([ln for ln in proc.stderr.splitlines()
                         if ln.startswith("GATE_LAUNCHES ")][-1][len("GATE_LAUNCHES "):])
    steps, clips, T = (int(GATE_ARGS[i]) for i in (1, 3, 5))
    zero = {k: 0 for k in launch_counts()}
    want = {"train": [zero | {"bilinear_sample": 2 * steps, "bilinear_splat": steps,
                              "sample_map_grad": steps}],
            "serve": [zero | {"warp_mesh": T - 1, "warp_uint8_cf_lowres": T - 1}] * 2,
            # tvl1_flow calls per clip: the output's and the input's
            # inter-frame pairs and the input-to-output pairs, 32 per call.
            "score": [zero | {"bilinear_sample": 20 * (2 * -(-(T - 1) // 32) + -(-T // 32))}]
            * (2 * clips)}
    check(record == want, f"quality gate launches {record}, expected {want}")
    seconds = [ln for ln in proc.stderr.splitlines() if ln.startswith("quality gate on")]
    train_s = json.loads(seconds[-1].split("seconds ", 1)[1])["train"] if seconds else math.nan
    with open(os.path.join(tmp, "gate", "log", "metrics.jsonl")) as f:
        last = [r for r in map(json.loads, f) if r["tag"] == "train"][-1]
    total = {k: sum(r[k] for part in record.values() for r in part) for k in zero}
    print(f"[22 quality gate] {card} | scripts/torch_quality_gate.py {' '.join(GATE_ARGS)} in "
          f"its own process, {wall:.1f} s, exit {proc.returncode}: pass {report['pass']}, "
          f"checks {report['checks']}, mean stability trained "
          f"{report['mean_stability_trained']:.4f} / input "
          f"{report['mean_stability_input']:.4f} / random "
          f"{report['mean_stability_random']:.4f}, wins {report['wins_vs_random']} of "
          f"{clips}, min distortion {report['min_distortion_trained']:.4f}, final loss "
          f"{report['final_train_loss']:.5f}; launches: training {record['train'][0]}, each "
          f"served batch of {clips} x {T} frames {record['serve'][0]}, each scored clip "
          f"{record['score'][0]}; training {train_s:.1f} s, {train_s / steps * 1e3:.1f} "
          f"ms per step, the loop's stage means over steps 1-{last['step']}: data "
          f"{last['data_ms']:.3f} ms, step {last['step_ms']:.3f} ms | "
          f"{seconds[-1] if seconds else ''}")
    return total


ENDURANCE_ARGS = ["--config", "v2_93", "--target", "4", "--segment", "2", "--score-every",
                  "4", "--clips", "1", "--frames", "20", "--examples", "10"]


def start_endurance(tmp: str):
    """Start scripts/torch_endurance.py at v2_93 over the port's CLI (its
    own processes; phase 23), to run beside phase 22's gate."""
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(tmp, "endurance")
    cmd = [sys.executable, os.path.join(here, "scripts", "torch_endurance.py"),
           *ENDURANCE_ARGS, "--workdir", work]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=here)
    return work, proc, time.perf_counter()


def phase_endurance(card: str, started):
    """Phase 23, started by `start_endurance`: two training segments of 2
    steps (the second through --restore) on 10 examples, scored at the end
    on one 20-frame clip; its verdict record and scores.jsonl."""
    work, proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t0
    log = os.path.join(work, "endurance.log")
    tail = open(log).read()[-4000:] if os.path.exists(log) else ""
    check(proc.returncode in (0, 1), f"endurance exit {proc.returncode}:\n"
          f"{stdout[-2000:]}\n{stderr[-2000:]}\n{tail}")
    verdict = json.loads(stdout.strip().splitlines()[-1])
    check(list(verdict["checks"]) == ["trend_up", "beats_input_at_end",
                                      "no_post_decay_regression", "distortion_floor"]
          and [r["iter"] for r in verdict["scores"]] == [4]
          and proc.returncode == (0 if verdict["pass"] else 1),
          f"endurance verdict {verdict}")
    with open(os.path.join(work, "scores.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    check([r["iter"] for r in records] == [4]
          and all(0 < r["mean_stability"] <= 1 + 1e-6 for r in records),
          f"endurance scores {records}")
    segments = [ln for ln in stdout.splitlines() if " steps in " in ln]
    print(f"[23 endurance] {card} | scripts/torch_endurance.py {' '.join(ENDURANCE_ARGS)}, "
          f"{wall:.1f} s from its start, beside phase 22: verdict {json.dumps(verdict)}; "
          f"training segments (each a `train` process of its own, its start included): "
          f"{'; '.join(segments)}")


def timed(number: int, fn, *args):
    """`fn(*args)`, its seconds printed as phase `number`'s."""
    t0 = time.perf_counter()
    out = fn(*args)
    seconds = time.perf_counter() - t0
    SECONDS[number] = SECONDS.get(number, 0.0) + seconds
    print(f"[{number} seconds] {seconds:.1f}", flush=True)
    return out


SECONDS = {}


def dp_only() -> int:
    """Phase 17 alone, after phase 1 (the kernels' build) and phase 8's
    shards: the check of a machine with several cards, where (c) runs."""
    card = timed(1, phase_device)
    with tempfile.TemporaryDirectory() as tmp:
        timed(17, phase_data_parallel, card, torch.device("cuda"), tmp, make_shards(tmp))
    print(f"[17 only] {torch.cuda.device_count()} card(s): phase 17 passed")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) > 1 and sys.argv[1] == DP_RANK:
        return dp_rank(sys.argv[2], sys.argv[3:])
    if len(sys.argv) > 1 and sys.argv[1] == GATE:
        return gate_process(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == DP_GRAPH:
        return dp_graph(sys.argv[2])
    if len(sys.argv) > 1 and sys.argv[1] == DP_ONLY:
        return dp_only()
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    card = timed(1, phase_device)
    errs = {**timed(2, phase_k2, gen, dev), **timed(3, phase_k1, gen, dev)}
    clips = make_clips(4, T_CLIP, CLIP_HW)
    engine, driver, grays, launches, eager1 = timed(4, phase_path, clips, dev)
    timed(5, phase_card_vs_cpu, clips, dev)
    kernels, timed_ms = timed(6, phase_times, card, gen, dev, engine, driver, clips, grays,
                              launches, errs)
    flow_err, flow_timed, flow_launches = timed(11, phase_flow, card, gen, dev, clips)
    errs["bilinear_sample"] = max(errs["bilinear_sample"], flow_err)
    timed_ms[("bilinear_sample", "(10, 288, 512, 3) edge-inclusive")] = flow_timed
    timed(12, phase_metrics, card, dev, engine, clips)
    batch_launches = timed(14, phase_serving_modes, card, dev, engine, clips, eager1)
    export_launches, export_batch_launches = timed(16, phase_export, card, dev, engine, clips)
    with tempfile.TemporaryDirectory() as tmp:
        moved_launches = timed(16, phase_export_platforms, card, dev, engine, clips, tmp)
    sharded_launches = timed(18, phase_sharded, card, dev, engine, clips)
    del engine, driver
    errs.update(timed(7, phase_grad_kernels, gen, dev))
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, data = timed(8, phase_train_path, tmp)
        timed(9, phase_train_card_vs_cpu, dev)
        timed(9, phase_train_graph, card, dev)
        train_timed, flowless_iter_ms = timed(10, phase_train_times, card, gen, dev, data)
        timed_ms.update(train_timed)
        timed(13, phase_flow_train, card, tmp, data, flowless_iter_ms)
        timed(15, phase_weights_in, card, dev, clips, tmp, data)
        dp_launches = timed(17, phase_data_parallel, card, dev, tmp, data)
        doctor_launches = timed(19, phase_doctor, card)
        vis_launches = timed(20, phase_debug_vis, card, tmp, data)
    bench_launches = timed(21, phase_bench, card)
    with tempfile.TemporaryDirectory() as tmp:
        # Phase 23's processes run beside phase 22's (both only report their
        # seconds); phase 23's own seconds are what is left after 22.
        endurance = start_endurance(tmp)
        try:
            gate_launches = timed(22, phase_quality_gate, card, tmp)
        except BaseException:
            endurance[1].kill()
            endurance[1].communicate()
            raise
        timed(23, phase_endurance, card, endurance)
    # K2, K4 and K6b run on the training path: their launches are a
    # segment's, at the shapes of the K6 forward and of the backwards.
    kernels.insert(0, kernel_row("bilinear_sample", "stabnet_tpu/ops/pallas_warp.py:469",
                                 train_launches["bilinear_sample"], errs["bilinear_sample"],
                                 timed_ms, "(20, 288, 512, 1)"))
    for name, label, replaces in (
            ("bilinear_splat", "(10, 288, 512, 2)", "stabnet_tpu/ops/pallas_warp.py:738"),
            ("sample_map_grad", "(20, 288, 512, 1)", "stabnet_tpu/ops/pallas_warp.py:946")):
        kernels.append(kernel_row(name, replaces, train_launches[name], errs[name], timed_ms,
                                  label, source="warp_grad.cu"))
    for row in kernels:
        row["launches_serving"] = launches[row["name"]]
        row["launches_train"] = train_launches[row["name"]]
        row["launches_flow"] = flow_launches[row["name"]]
        row["launches_batch"] = batch_launches[row["name"]]
        row["launches_export"] = export_launches[row["name"]]
        row["launches_export_batch"] = export_batch_launches[row["name"]]
        row["launches_sharded"] = sharded_launches[row["name"]]
        row["launches_data_parallel_rank"] = dp_launches[row["name"]]
        row["launches_doctor"] = doctor_launches[row["name"]]
        row["launches_debug_vis"] = vis_launches[row["name"]]
        row["launches_bench"] = bench_launches[row["name"]]
        row["launches_export_moved"] = moved_launches[row["name"]]
        row["launches_quality_gate"] = gate_launches[row["name"]]
    print(f"[seconds] all phases {time.perf_counter() - t_start:.1f}, by phase "
          + json.dumps({k: round(v, 1) for k, v in sorted(SECONDS.items())}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
