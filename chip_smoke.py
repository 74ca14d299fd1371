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
     launch) against its plain version, bit for bit, at S=1 and S=4 with
     the frame read in place from the 13-channel stack, in the stack layout
     of a refine pass, at 289x515, on a zoomed-out mesh with black borders
     and on a mesh with Z < 0 in some cells;
  3. K1 (uint8 color warp, fused map up-sample) and K3 (the same warp at
     full-resolution maps) against their plain versions, bit for bit, at
     720p S=1 and S=4, 1080p, 719x1283 and zoomed maps, and at 360x640
     from maps too wide for K1 to stage their row pass;
  4. the serving path at v2_93 (bf16, seeded random weights, theta head
     scaled by 0.05) on a 40-frame synthetic 720p clip: StreamDriver at S=1
     and StreamEngine.stabilize_clip at S=4, with the kernels' launch counts
     read around each run;
  5. card against CPU in f32 (TF32 off), 8 frames;
  6. serving times: CUDA events, 5 warm-ups, median of 50 runs; K2m at
     S=1 and S=4 beside the unfused chain it replaces (dense maps, black
     mask, frame copy, K2), K2 at S=1 and S=4, K1 and K3 at 720p S=1 and
     S=4 and at 1080p (K3 is on no path, as in the JAX package); the S=1
     path's device operations per frame;
  7. K4 (splat) and K6b (map gradient) against their plain versions on the
     card, realistic and adversarial maps, K4 also on flow-like maps (every
     pass-2 tile sums in shared memory) and half of each; K5/K6 through
     autograd;
  8. the training path: `make-synthetic` 20 v2_93 examples, then `train`
     through the port's CLI at v2_93 bf16 batch 10 for 4 steps with every
     loss term live, then `--restore` to step 6, launch counts read around
     each segment;
  9. one v2_93 training step, card against CPU, f32 (TF32 off), batch 2;
 10. training times: K4 (with each pass's time under torch.profiler) and
     K6b at their training shapes, and the step;
 11. TV-L1 flow: K2 in its edge-inclusive mode against its plain version,
     bit for bit, at the pyramid of the training shape, (10, 288, 512, 3)
     down to (10, 32, 64, 3), and at the metrics' pyramid, (32, 144, 256,
     3) down to (32, 16, 32, 3), on clipped flow maps, and its times; one
     tvl1_flow call at (10, 288, 512), fine_iters 40, with its launches
     (20 of K2), time and device operations; card against CPU at
     (2, 96, 128), bit for bit; a translation recovered on the card;
 12. quality metrics: the S=1 driver keeping its input grays on the
     40-frame 720p clip, then score_stabilized_clip at 144x256 (launches,
     seconds per clip, every score in (0, 1]); evaluate_clip card against
     CPU on the driver's first 12 frames at 144x256, and where the devices
     part: the flow of those frames and the phase correlation bit for bit,
     the fit, the spectrum and the singular values on equal inputs;
 13. flow-fed training: phase 8's shards with the flow field stripped,
     `train` refused on them, then `train --compute-flow` through the CLI
     at v2_93 bf16 batch 10 for 4 steps with the temporal loss live, its
     launches and time per iteration beside phase 10's;
 14. serving modes at v2_93 bf16 720p on phase 4's clips: the S=1 driver
     pipelined against synchronous (bit for bit, per-frame p50 and p90 of
     each); stabilize_batch of clips of 40, 23 and 9 frames at 4 streams,
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
     losses; K2 2, K4 1, K6b 1 launches).
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
                           spread: float = 0.05, zoom: float = 1.0):
    """(S, 4, 4, 3, 3) cell homographies of random meshes (vertex offsets
    ~ N(0, spread), clamped as theta_to_mesh clamps)."""
    from stabnet_tpu_torch.ops import base_mesh, mesh_to_homographies

    mesh = torch.from_numpy(base_mesh(4, 4)) * zoom
    mesh = (mesh + spread * torch.randn((S, 5, 5, 2), generator=gen)).clamp(-1.25, 1.25)
    return mesh_to_homographies(mesh.to(device), 4, 4)


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


def profile_path(engine, clip: np.ndarray, frames: int = 20):
    """The same `frames` steps at S=1 with per-frame readback, run twice from
    a fresh state: without the profiler for the wall time, then under
    torch.profiler for the summed kernel time and the kernels that take most.
    Returns (wall, profiled wall, kernel time) in ms/frame, the device
    operations (kernels, copies, fills) per frame and the top list."""
    from torch.profiler import ProfilerActivity, profile

    from stabnet_tpu_torch.stream import video_io

    cfg = engine.cfg
    first = video_io.to_gray_train(clip[0], cfg.height, cfg.width)[None]

    def run():
        state = engine.init(first)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(1, frames + 1):
            state, out = engine.step(state, None, clip[None, t])
            out.warped_color.cpu()
        return (time.perf_counter() - t0) / frames * 1e3

    wall = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    ops = sum(e.count for e in kernels) / frames
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return (wall, wall_prof, busy_us / frames / 1e3, ops,
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

    # K2m: (S, frame size, mesh zoom, stack channels last, cells negated).
    cases = [(1, (H, W), 1.0, False, False), (4, (H, W), 1.0, False, False),
             (2, (H, W), 1.0, True, False), (1, (289, 515), 1.0, False, False),
             (2, (H, W), 1.2, False, False), (2, (H, W), 1.0, False, True)]
    shares = []
    for S, (h, w), zoom, channels_last, negate in cases:
        frame = stack_frame(S, h, w, gen, dev, channels_last)
        Hs = realistic_homographies(S, gen, dev, zoom=zoom)
        if negate:
            # -H maps as H does, through the sign guard's other branch.
            Hs[:, 1:3, 1:3] *= -1.0
        tables = mesh_tables(h, w, 4, 4, dev)
        got = cuda_warp.warp_mesh(frame, Hs, tables)
        want = cuda_warp.warp_mesh_plain(frame, Hs, tables)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        worst["warp_mesh"] = max(worst["warp_mesh"], err)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K2m S={S} {h}x{w} zoom={zoom} negated={negate}: max abs {err}")
        black = float(got[1].mean())
        if zoom > 1.0:
            check(0.05 < black < 0.95, f"K2m zoomed-out mesh: black share {black}")
        if negate:
            gx, gy, cc, cr = tables
            z_row = Hs[..., 2, :][:, cr.long()][:, :, cc.long()]
            Z = z_row[..., 0] * gx + z_row[..., 1] * gy[:, None] + z_row[..., 2]
            check(float((Z < 0).float().mean()) > 0.2, "K2m: no Z < 0 in the negated cells")
        shares.append(round(black, 4))
    print(f"[2 K2/K2m] bilinear_sample vs plain on the card: max abs "
          f"{worst['bilinear_sample']:.3g} (tolerance 0) at (1|4, {H}, {W}, 1), "
          f"(10, {H}, {W}, 2), (20, {H}, {W}, 1) and (2, 72, 136, 5), realistic + "
          f"adversarial maps, strict_edge True/False; warp_mesh vs plain: max abs "
          f"{worst['warp_mesh']:.3g} (tolerance 0) on the output, mask and maps at "
          f"S=1/4 (frame read in place from the stack), S=2 channels-last stack, "
          f"289x515, zoomed out and with negated cells (black shares {shares})")
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
             (1, (1080, 1920), 1.0, (72, 128)), (1, (719, 1283), 1.0, (72, 128)),
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
          f"{worst['warp_uint8_cf']} LSB (tolerance 0 for both) at 720p S=1/4, 1080p, "
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
          f"{[round(s, 4) for s in shares]}")
    return engine, driver, grays, launches


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

    def record(name, label, kern, plain, lib, nbytes, ops, plain_reps=50, chain=None):
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
    # cell homographies; beside it the chain it replaces, as the parent's
    # `transformer` ran it after the solve.  Bytes: the frame, the output,
    # the mask and both maps, the homographies and the four tables.  f32
    # operations per pixel: the map 3 x 4 (2 mul, 2 add), the sign guard 2
    # (compare, add), 2 divides, the mask's 4 compares, then K2's 24 + 7.
    for S in (1, 4):
        frame = stack_frame(S, H, W, gen, dev)
        Hs = realistic_homographies(S, gen, dev)
        tables = mesh_tables(H, W, 4, 4, dev)

        def chain():
            x_map, y_map = dense_maps(Hs, H, W)
            return (cuda_warp.bilinear_sample(frame.contiguous(), x_map.contiguous(),
                                              y_map.contiguous()),
                    black_mask(x_map, y_map))

        n = S * H * W
        record("warp_mesh", f"S={S}",
               lambda: cuda_warp.warp_mesh(frame, Hs, tables),
               lambda: cuda_warp.warp_mesh_plain(frame, Hs, tables), None,
               4 * (5 * n + Hs.numel() + 2 * (H + W)), (12 + 2 + 2 + 4 + 24 + 7) * n,
               chain=chain)
    # The color warps at the serving shapes (the clip's frames at 720p, a
    # random frame at 1080p): K1 from the model-scale maps' 4x-down
    # resize, K3 from those maps up-sampled to the frame.
    # The plain versions repeat the kernels' arithmetic and are no yardstick
    # of speed: away from the main shape, 10 replays of 5 calls time them.
    for label, S, (Hf, Wf), plain_reps in (("S=1 720p", 1, CLIP_HW, 50),
                                           ("S=4 720p", 4, CLIP_HW, 10),
                                           ("S=1 1080p", 1, (1080, 1920), 10)):
        if (Hf, Wf) == CLIP_HW:
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
    wall, wall_prof, busy, ops, top = profile_path(engine, clips[0])
    print(f"[6 times path] {card} | v2_93 bf16 720p: S=1 StreamDriver "
          f"{st['net']['p50_ms']:.3f} ms/frame p50 of dispatch + readback "
          f"(p95 {st['net']['p95_ms']:.3f}; dispatch p50 "
          f"{st['dispatch']['p50_ms']:.3f}, readback p50 "
          f"{st['readback']['p50_ms']:.3f}), {clip_ms:.3f} ms/frame over the "
          f"whole clip incl. crop; S={S} StreamEngine.stabilize_clip "
          f"{s4_fps:.2f} frames/s (upload included)")
    print(f"[6 profile S=1] {card} | wall {wall:.3f} ms/frame unprofiled "
          f"({wall_prof:.3f} under the profiler), kernels {busy:.3f} ms/frame, "
          f"device idle {100 * (1 - busy / wall):.1f}% of the unprofiled wall, "
          f"{ops:.2f} device operations (kernels, copies, fills) per frame, "
          f"top kernels (name, ms/frame, launches/frame): {top}")
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
            **{k: t[k] for k in ("chain_ms", "chain_call_ms", "passes", "flow_maps_ms")
               if k in t},
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


def phase_train_path(tmp: str):
    """`make-synthetic` + `train` through the port's CLI at v2_93 bf16,
    batch 10: 4 steps, then --restore to step 6."""
    from stabnet_tpu_torch.cli.main import main as cli
    from stabnet_tpu_torch.models import make_model
    from stabnet_tpu_torch.ops import cuda_warp
    from stabnet_tpu_torch.train import checkpoint as ckpt

    data = os.path.join(tmp, "data")
    model_dir, log_dir = os.path.join(tmp, "models"), os.path.join(tmp, "log")
    t0 = time.perf_counter()
    cli(["make-synthetic", "--out", os.path.join(data, "train"), "--num", "20",
         "--config", "v2_93", "--seed", "0"])
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
        cli(base + ["--steps", str(steps)] + extra)
        torch.cuda.synchronize()
        launches = launch_counts()
        check(launches == expected,
              f"train to step {steps}: launches {launches}, expected {expected}")
        segments.append((steps, launches, time.perf_counter() - t0))
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
              f"train to step {st} in {sec:.1f} s, launches {ln}" for st, ln, sec in segments)
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


def profile_steps(step, steps: int = 3):
    """Wall time per call of `step` (synchronized) without and with the
    profiler, and the summed kernel time per call under it."""
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return wall, wall_prof, busy, [(e.key[:48], round(e.self_device_time_total / steps / 1e3, 3),
                                    e.count // steps) for e in top]


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
    from stabnet_tpu_torch.train import create_train_state, train_step
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
    timers = StageTimer()
    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(13):
        if i == 3:
            timers.reset()
            t_window = time.perf_counter()
        with timers.stage("data"):
            batch = next(pipe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timers.stage("step"):
            state, aux = train_step(state, batch, cfg)
            torch.cuda.synchronize()
        if i >= 3:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    window_s = time.perf_counter() - t_window
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 - base_gib
    p50 = float(np.median(step_ms))
    st = timers.summary()
    check(math.isfinite(float(aux["total"])), "non-finite loss in the timed steps")
    pipe.close()
    wall, wall_prof, busy, top = profile_steps(lambda: train_step(state, batch, cfg))
    print(f"[10 times train step] {card} | v2_93 bf16 batch 10 (20 frames per "
          f"forward): {p50:.3f} ms/step p50 over 10 synchronized steps after 3 "
          f"warm-ups (min {min(step_ms):.3f}, max {max(step_ms):.3f}), "
          f"{cfg.batch_size / p50 * 1e3:.2f} samples/s at the p50; the 10 "
          f"iterations with their data waits {window_s * 1e3:.1f} ms, "
          f"{10 * cfg.batch_size / window_s:.2f} samples/s; stages: data mean "
          f"{st['data']['mean_ms']:.3f} ms (p50 {st['data']['p50_ms']:.3f}), step "
          f"mean {st['step']['mean_ms']:.3f} ms; peak memory of the training "
          f"{peak_gib:.2f} GiB above the {base_gib:.2f} GiB held before it")
    print(f"[10 profile train step] {card} | wall {wall:.3f} ms/step unprofiled "
          f"({wall_prof:.3f} under the profiler), kernels {busy:.3f} ms/step, device "
          f"idle {100 * (1 - busy / wall):.1f}% of the unprofiled wall, top kernels "
          f"(name, ms/step, launches/step): {top}")
    return timed, window_s * 1e3 / 10


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
    """One call of `fn` under torch.profiler (CUDA activity): the device
    operations (kernels, copies, fills) it ran and their summed time, ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3)


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

    # tvl1_flow at the training shape on consecutive frames of the clip.
    color = torch.from_numpy(clips[0, :B + 1]).to(dev).permute(0, 3, 1, 2)
    gray = gray_from_color(color, (H, W))
    i0, i1 = gray[:-1].contiguous(), gray[1:].contiguous()
    u = tvl1_flow(i0, i1)
    torch.cuda.synchronize()
    cuda_warp.reset_launch_counts()
    u = tvl1_flow(i0, i1)
    torch.cuda.synchronize()
    per_call = launch_counts()
    expected = {k: 0 for k in per_call} | {"bilinear_sample": 20}
    check(per_call == expected, f"tvl1_flow launches {per_call}, expected {expected}")
    check(tuple(u.shape) == (B, H, W, 2) and bool(torch.isfinite(u).all()),
          f"tvl1_flow output {tuple(u.shape)}, finite {bool(torch.isfinite(u).all())}")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tvl1_flow(i0, i1)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    n_ops, busy = device_ops(lambda: tvl1_flow(i0, i1))
    flow_ms = float(np.median(walls))
    print(f"[11 flow] {card} | tvl1_flow ({B}, {H}, {W}), fine_iters 40 (1,700 "
          f"primal-dual iterations): launches per call {per_call}; {flow_ms:.3f} ms per "
          f"call (median of 3, synchronized; {[round(w, 3) for w in walls]}); "
          f"{n_ops} device operations per call, kernels {busy:.3f} ms, device idle "
          f"{100 * (1 - busy / flow_ms):.1f}% of the wall")

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
    from stabnet_tpu_torch.ops.flow import tvl1_flow
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
          f"{t2 - t1:.3f} s ({flows} tvl1_flow calls of {_EVAL_CHUNK} pairs, fine_iters "
          f"100), {t2 - t0:.3f} s per clip; launches {launches}; scores "
          f"{ {k: round(v, 6) for k, v in scores.items()} }")

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
    u = tvl1_flow(a, b, fine_iters=_FINE_ITERS)
    u_cpu = tvl1_flow(a.cpu(), b.cpu(), fine_iters=_FINE_ITERS)
    shift, shift_cpu = _global_shift(a, b), _global_shift(a.cpu(), b.cpu())
    src, dst = _grid_correspondences(u)
    Hs = fit_homographies(src, dst)
    Hs_cpu = fit_homographies(src.cpu(), dst.cpu())
    fit_gap = float((Hs.cpu() - Hs_cpu).abs().max() / Hs_cpu.abs().max())
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
          f"{max(gaps.values()):.3g} (need <= 1e-6). Where the devices part: tvl1_flow "
          f"{tuple(u.shape)} fine_iters {_FINE_ITERS} max abs {flow_gap:.3g} (need 0), "
          f"_global_shift equal {all(map(torch.equal, (s.cpu() for s in shift), shift_cpu))} "
          f"(need True); on equal inputs fit_homographies max rel {fit_gap:.3g}, "
          f"{ {k: float(f'{v:.3g}') for k, v in op_gaps.items()} }")
    check(flow_gap == 0.0, "metrics: the flow differs between card and CPU")
    check(all(map(torch.equal, (s.cpu() for s in shift), shift_cpu)),
          "metrics: the phase correlation differs between card and CPU")
    check(max(gaps.values()) <= 1e-6, "metrics: card and CPU disagree")


def phase_flow_train(card: str, tmp: str, data: str, flowless_iter_ms: float):
    """Phase 8's make-synthetic shards with the flow field stripped, then
    `train --compute-flow` through the CLI at v2_93 bf16 batch 10 for 4
    steps, the temporal loss fed by the flow from step 0."""
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
            "--set", "disp_freq=1", *TRAIN_LIVE, "--steps", "4"]
    try:
        cli(base)
        raise AssertionError("train on flowless shards without --compute-flow ran")
    except ValueError as e:
        check("--compute-flow" in str(e), f"refusal without --compute-flow: {e}")
    cuda_warp.reset_launch_counts()
    t0 = time.perf_counter()
    cli(base + ["--compute-flow"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    # Each step launches K2 twice (the K5 and K6 forwards), each batch the
    # pipeline made (the 4 steps', and up to 3 more it had in hand or queued
    # when it was closed) 20 times in its flow.
    batches = (launches["bilinear_sample"] - 2 * 4) / 20
    rest = {k: v for k, v in launches.items() if k != "bilinear_sample"}
    check(batches == int(batches) and 4 <= batches <= 7
          and rest == {"warp_mesh": 0, "warp_uint8_cf_lowres": 0, "warp_uint8_cf": 0,
                       "bilinear_splat": 4, "sample_map_grad": 4},
          f"train --compute-flow launches {launches}")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if r["tag"] == "train"]
    check([r["step"] for r in rows] == [0, 1, 2, 3], f"steps {[r['step'] for r in rows]}")
    check(all(math.isfinite(r["total"]) and r["temp"] > 0 for r in rows),
          f"losses {[(r['total'], r['temp']) for r in rows]}")
    iter_ms = float(np.mean([r["data_ms"] + r["step_ms"] for r in rows[1:]]))
    print(f"[13 flow train] {card} | train --compute-flow, v2_93 bf16 batch 10, 4 steps "
          f"through the CLI in {seconds:.1f} s (refused without --compute-flow): launches "
          f"{launches} (K2: 2 per step + 20 per tvl1_flow, {int(batches)} batches made); "
          f"temporal loss live (step 0 temp {rows[0]['temp']:.6g}, total "
          f"{rows[0]['total']:.6g}); {iter_ms:.3f} ms per synchronized iteration (data wait "
          f"+ step, steps 1-3; data {[round(r['data_ms'], 3) for r in rows[1:]]}) against "
          f"{flowless_iter_ms:.3f} ms with record flow (phase 10)")
    return launches, iter_ms


# --- serving modes and weights in --------------------------------------------

def stage_percentiles(res) -> dict:
    """p50 and p90 of the per-frame "net" (dispatch + readback), ms."""
    st = res.stage_summary["net"]
    return {"p50": st["p50_ms"], "p90": st["p90_ms"]}


def phase_serving_modes(card: str, dev, engine, clips: np.ndarray):
    """The driver's serving modes on phase 4's engine and clips.  Returns
    the launch counts of the chunked batch (K1 and K2m once per step)."""
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
    lat = {name: [dict(stage_percentiles(r), wall=w) for r, w in rs]
           for name, rs in runs.items()}
    print(f"[14 pipelined] {card} | v2_93 bf16 720p S=1 T={T}, device gray, runs in "
          f"turns sync, pipelined, sync, pipelined: frames, black map and crop equal bit "
          f"for bit; per-frame net (dispatch + readback) ms p50/p90 and wall ms/frame "
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    card = phase_device()
    errs = {**phase_k2(gen, dev), **phase_k1(gen, dev)}
    clips = make_clips(4, T_CLIP, CLIP_HW)
    engine, driver, grays, launches = phase_path(clips, dev)
    phase_card_vs_cpu(clips, dev)
    kernels, timed = phase_times(card, gen, dev, engine, driver, clips, grays,
                                 launches, errs)
    flow_err, flow_timed, flow_launches = phase_flow(card, gen, dev, clips)
    errs["bilinear_sample"] = max(errs["bilinear_sample"], flow_err)
    timed[("bilinear_sample", "(10, 288, 512, 3) edge-inclusive")] = flow_timed
    phase_metrics(card, dev, engine, clips)
    batch_launches = phase_serving_modes(card, dev, engine, clips)
    del engine, driver
    errs.update(phase_grad_kernels(gen, dev))
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, data = phase_train_path(tmp)
        phase_train_card_vs_cpu(dev)
        train_timed, flowless_iter_ms = phase_train_times(card, gen, dev, data)
        timed.update(train_timed)
        phase_flow_train(card, tmp, data, flowless_iter_ms)
        phase_weights_in(card, dev, clips, tmp, data)
    # K2, K4 and K6b run on the training path: their launches are a
    # segment's, at the shapes of the K6 forward and of the backwards.
    kernels.insert(0, kernel_row("bilinear_sample", "stabnet_tpu/ops/pallas_warp.py:469",
                                 train_launches["bilinear_sample"], errs["bilinear_sample"],
                                 timed, "(20, 288, 512, 1)"))
    for name, label, replaces in (
            ("bilinear_splat", "(10, 288, 512, 2)", "stabnet_tpu/ops/pallas_warp.py:738"),
            ("sample_map_grad", "(20, 288, 512, 1)", "stabnet_tpu/ops/pallas_warp.py:946")):
        kernels.append(kernel_row(name, replaces, train_launches[name], errs[name], timed,
                                  label, source="warp_grad.cu"))
    for row in kernels:
        row["launches_serving"] = launches[row["name"]]
        row["launches_train"] = train_launches[row["name"]]
        row["launches_flow"] = flow_launches[row["name"]]
        row["launches_batch"] = batch_launches[row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
