#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure stops the run with a
nonzero exit):
  1. device: the card (nvidia-smi name and power limit) and the kernels'
     build from stabnet_tpu_torch/csrc (one nvcc per source, in parallel);
  2. K2 (f32 sampler) against its plain PyTorch version on the card, on
     realistic and adversarial maps, both strict_edge modes;
  3. K1 (uint8 color warp, fused map up-sample) against its plain version at
     720p, 1080p and a ragged size;
  4. the serving path at v2_93 (bf16, seeded random weights, theta head
     scaled by 0.05) on a 40-frame synthetic 720p clip: StreamDriver at S=1
     and StreamEngine.stabilize_clip at S=4, with the kernels' launch counts
     read around each run;
  5. card against CPU in f32 (TF32 off), 8 frames;
  6. serving times: CUDA events, 5 warm-ups, median of 50 runs;
  7. K4 (splat) and K6b (map gradient) against their plain versions on the
     card, realistic and adversarial maps, and K5/K6 through autograd;
  8. the training path: `make-synthetic` 20 v2_93 examples, then `train`
     through the port's CLI at v2_93 bf16 batch 10 for 4 steps with every
     loss term live, then `--restore` to step 6, launch counts read around
     each segment;
  9. one v2_93 training step, card against CPU, f32 (TF32 off), batch 2;
 10. training times: K4 and K6b at their training shapes, and the step.
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


def realistic_maps(S: int, H: int, W: int, gen: torch.Generator, device,
                   spread: float = 0.05, zoom: float = 1.0):
    """Dense NDC maps of random meshes (vertex offsets ~ N(0, spread))."""
    from stabnet_tpu_torch.ops import base_mesh, dense_maps, mesh_to_homographies

    mesh = torch.from_numpy(base_mesh(4, 4)) * zoom
    mesh = (mesh + spread * torch.randn((S, 5, 5, 2), generator=gen)).clamp(-1.25, 1.25)
    Hs = mesh_to_homographies(mesh.to(device), 4, 4)
    return dense_maps(Hs, H, W)


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
    Returns (wall, profiled wall, kernel time) in ms/frame and the top list."""
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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return (wall, wall_prof, busy_us / frames / 1e3,
            [(e.key[:48], round(e.self_device_time_total / frames / 1e3, 4), e.count // frames)
             for e in top])


# --- phases -----------------------------------------------------------------

SOURCES = ("warp", "warp_grad")


def phase_device():
    from stabnet_tpu_torch.ops import cuda_build

    card = card_line()
    t0 = time.perf_counter()
    cuda_build.build(SOURCES)
    for name in SOURCES:
        cuda_build.load(name)
    build_s = time.perf_counter() - t0
    regs = []
    for name in SOURCES:
        with open(cuda_build.library_path(name) + ".log", errors="replace") as f:
            regs += [f"{name}: {ln.strip()}" for ln in f if "registers" in ln]
    print(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | csrc/{{{','.join(SOURCES)}}}.cu built in parallel and loaded in "
          f"{build_s:.2f} s | {'; '.join(regs)}")
    return card


def phase_k2(gen: torch.Generator, dev) -> float:
    from stabnet_tpu_torch.ops import cuda_warp

    H, W = 288, 512
    worst = 0.0
    for S in (1, 4):
        im = (torch.rand((S, H, W, 1), generator=gen) - 0.5).to(dev)
        x_r, y_r = realistic_maps(S, H, W, gen, dev)
        x_a, y_a, kind, px = adversarial_maps(S, H, W, gen)
        for name, xm, ym in (("realistic", x_r, y_r),
                             ("adversarial", x_a.to(dev), y_a.to(dev))):
            for strict in (True, False):
                got = cuda_warp.bilinear_sample(im, xm, ym, strict_edge=strict)
                want = cuda_warp.bilinear_sample_plain(im, xm, ym, strict_edge=strict)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                worst = max(worst, err)
                check(err <= 1e-5, f"K2 S={S} {name} strict={strict}: max abs {err}")
        # The strict edge really is exercised: samples at exactly x == W-1.
        edge = torch.from_numpy((kind == 0) | (kind == 2))
        strict_out = cuda_warp.bilinear_sample(im, x_a.to(dev), y_a.to(dev))
        check(bool((strict_out[..., 0].cpu()[edge] == 0).all()),
              "K2 strict edge: a sample at x == W-1 is not 0")
    print(f"[2 K2] bilinear_sample vs plain on the card: max abs {worst:.3g} "
          f"(tolerance 1e-5) at (1|4, {H}, {W}, 1), realistic + adversarial "
          f"maps, strict_edge True/False")
    return worst


def phase_k1(gen: torch.Generator, dev) -> int:
    from stabnet_tpu_torch.ops import cuda_warp, resize_bilinear_bhw

    worst = 0
    cases = [(1, (720, 1280), 1.0), (4, (720, 1280), 1.0), (1, (1080, 1920), 1.0),
             (1, (719, 1283), 1.0), (2, (720, 1280), 1.15)]
    for S, (Hf, Wf), zoom in cases:
        imc = torch.randint(0, 256, (S, 3, Hf, Wf), generator=gen,
                            dtype=torch.uint8).to(dev)
        xm, ym = realistic_maps(S, 288, 512, gen, dev, zoom=zoom)
        xs = resize_bilinear_bhw(xm, (72, 128)).contiguous()
        ys = resize_bilinear_bhw(ym, (72, 128)).contiguous()
        got = cuda_warp.warp_uint8_cf_lowres(imc, xs, ys, (Hf, Wf))
        want = cuda_warp.warp_uint8_cf_lowres_plain(imc, xs, ys, (Hf, Wf))
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        worst = max(worst, err)
        check(got.shape == (S, Hf, Wf, 3), f"K1 shape {tuple(got.shape)}")
        check(err <= 1, f"K1 S={S} {Hf}x{Wf} zoom={zoom}: max abs {err} LSB")
    print(f"[3 K1] warp_uint8_cf_lowres vs plain on the card: max abs {worst} "
          f"LSB (tolerance 1) at 720p S=1/4, 1080p, 719x1283, zoomed maps")
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

    expected = {"bilinear_sample": refine * (T - 1), "warp_uint8_cf_lowres": T - 1,
                "bilinear_splat": 0, "sample_map_grad": 0}
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
    path's own time, frame rate and device busy time."""
    from stabnet_tpu_torch.ops import cuda_warp, resize_bilinear_bhw

    bw, f32_peak = peaks(torch.cuda.get_device_name(0))
    H, W = 288, 512
    Hf, Wf = CLIP_HW
    timed = {}
    for S in (1, 4):
        im = (torch.rand((S, H, W, 1), generator=gen) - 0.5).to(dev)
        xm, ym = realistic_maps(S, H, W, gen, dev)
        grid = torch.stack([xm + 1.0 / W, ym + 1.0 / H], dim=-1)
        im_nchw = im.permute(0, 3, 1, 2)
        imc = torch.from_numpy(clips[:S, 1]).permute(0, 3, 1, 2).contiguous().to(dev)
        xs = resize_bilinear_bhw(xm, (H // 4, W // 4)).contiguous()
        ys = resize_bilinear_bhw(ym, (H // 4, W // 4)).contiguous()
        fns = {
            "bilinear_sample": (
                lambda: cuda_warp.bilinear_sample(im, xm, ym),
                lambda: cuda_warp.bilinear_sample_plain(im, xm, ym),
                lambda: F.grid_sample(im_nchw, grid, mode="bilinear",
                                      padding_mode="zeros", align_corners=False)),
            "warp_uint8_cf_lowres": (
                lambda: cuda_warp.warp_uint8_cf_lowres(imc, xs, ys, CLIP_HW),
                lambda: cuda_warp.warp_uint8_cf_lowres_plain(imc, xs, ys, CLIP_HW),
                None),
        }
        # Bytes: each input read once, each output written once (K1: the
        # low-res maps, the frame read and the frame write).  f32 operations
        # per output pixel, counted in csrc/warp.cu: the coordinates take 24
        # (ndc_to_pixel 2 x 2, floor 2, corner + 1 2, clamps 8, distances 4,
        # weights 4) and each channel's taps 7 (4 mul, 3 add); K1 adds the
        # map up-sample, 2 x 9 (upsample_tap: 6 mul, 3 add), and 3 per
        # channel (round, clip).  K2 here has C = 1, K1 has C = 3.
        work = {"bilinear_sample": (4 * (3 * xm.numel() + im.numel()),
                                    (24 + 7) * xm.numel()),
                "warp_uint8_cf_lowres": (8 * xs.numel() + 2 * imc.numel(),
                                         (18 + 24 + 10 * 3) * S * Hf * Wf)}
        for name, (kern, plain, lib) in fns.items():
            t = {"ms": device_ms(kern), "plain_ms": device_ms(plain),
                 "library_ms": device_ms(lib) if lib else None,
                 "call_ms": call_ms(kern)}
            nbytes, ops = work[name]
            t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_peak * 1e3
            t["bound_ms"] = max(t_bytes, t_ops)
            t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            timed[(name, S)] = t
            lib_txt = "none" if lib is None else f"{t['library_ms']:.5f} ms"
            print(f"[6 times {name} S={S}] {card} | kernel {t['ms']:.5f} ms device "
                  f"({t['call_ms']:.5f} ms per call from the host), plain "
                  f"{t['plain_ms']:.5f} ms, library {lib_txt}, bound "
                  f"{t['bound_ms'] * 1e3:.3f} us ({nbytes} B, {t['bound_by']})")

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
    wall, wall_prof, busy, top = profile_path(engine, clips[0])
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
          f"top kernels (name, ms/frame, launches/frame): {top}")
    rows = []
    for name, replaces in (("bilinear_sample", "stabnet_tpu/ops/pallas_warp.py:469"),
                           ("warp_uint8_cf_lowres", "stabnet_tpu/ops/pallas_warp.py:575")):
        t = timed[(name, 1)]
        rows.append({"name": name, "route": "cuda",
                     "source": "stabnet_tpu_torch/csrc/warp.cu", "replaces": replaces,
                     "launches": launches[name],
                     "max_abs_err": errs[0] if name == "bilinear_sample" else errs[1],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "call_ms": t["call_ms"]})
    return rows


# --- the training path ------------------------------------------------------

TRAIN_LIVE = ["--set", "do_temp_loss_iter=0", "--set", "do_black_loss_iter=0",
              "--set", "do_theta_only_iter=-1"]


def live_config(**kw):
    """v2_93 with every loss term live from step 0 (as TRAIN_LIVE sets)."""
    from stabnet_tpu_torch.config import V2_93

    return V2_93.replace(do_temp_loss_iter=0, do_black_loss_iter=0,
                         do_theta_only_iter=-1, **kw)


def phase_grad_kernels(gen: torch.Generator, dev) -> dict:
    """K4 and K6b against their plain versions (bit for bit: both are
    deterministic), and K5/K6 through autograd against the kernels."""
    from stabnet_tpu_torch.ops import cuda_warp

    H, W = 288, 512
    worst = {"bilinear_splat": 0.0, "sample_map_grad": 0.0}
    for name, B, C in (("bilinear_splat", 1, 2), ("bilinear_splat", 10, 2),
                       ("sample_map_grad", 2, 1), ("sample_map_grad", 20, 1)):
        x_r, y_r = realistic_maps(B, H, W, gen, dev)
        x_a, y_a, kind, _ = adversarial_maps(B, H, W, gen)
        for maps, xm, ym in (("realistic", x_r, y_r),
                             ("adversarial", x_a.to(dev), y_a.to(dev))):
            g = (torch.rand((B, H, W, C), generator=gen) - 0.5).to(dev)
            if name == "bilinear_splat":
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
          f"sums; two runs equal) at (1|10, {H}, {W}, 2); sample_map_grad vs plain: "
          f"max abs {worst['sample_map_grad']:.3g} (tolerance 0) at (2|20, {H}, {W}, 1); "
          f"realistic + adversarial maps; K5/K6 autograd backward == K4/K6b")
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
        expected = {"bilinear_sample": 2 * n, "warp_uint8_cf_lowres": 0,
                    "bilinear_splat": n, "sample_map_grad": n}
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
            extra = f"; the int64 zero-fill adds {8 * B * H * W * C} B"
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
        t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_peak * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        timed[name, B] = t
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
    return timed


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    card = phase_device()
    errs = (phase_k2(gen, dev), phase_k1(gen, dev))
    clips = make_clips(4, T_CLIP, CLIP_HW)
    engine, driver, grays, launches = phase_path(clips, dev)
    phase_card_vs_cpu(clips, dev)
    kernels = phase_times(card, gen, dev, engine, driver, clips, grays,
                          launches, errs)
    del engine, driver
    grad_errs = phase_grad_kernels(gen, dev)
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, data = phase_train_path(tmp)
        phase_train_card_vs_cpu(dev)
        timed = phase_train_times(card, gen, dev, data)
    for row in kernels:
        row["launches_train"] = train_launches[row["name"]]
    for name, B, replaces in (("bilinear_splat", 10, "stabnet_tpu/ops/pallas_warp.py:738"),
                              ("sample_map_grad", 20, "stabnet_tpu/ops/pallas_warp.py:946")):
        t = timed[name, B]
        kernels.append({"name": name, "route": "cuda",
                        "source": "stabnet_tpu_torch/csrc/warp_grad.cu",
                        "replaces": replaces, "launches": train_launches[name],
                        "launches_train": train_launches[name],
                        "max_abs_err": grad_errs[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "call_ms": t["call_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
