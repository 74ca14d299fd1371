#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure stops the run with a nonzero exit):
  1. device: the card (nvidia-smi name and power limit) and the kernels'
     build from stabnet_tpu_torch/csrc;
  2. K2 (f32 sampler) against its plain PyTorch version on the card, on
     realistic and adversarial maps, both strict_edge modes;
  3. K1 (uint8 color warp, fused map up-sample) against its plain version at
     720p, 1080p and a ragged size;
  4. the serving path at v2_93 (bf16, seeded random weights, theta head
     scaled by 0.05) on a 40-frame synthetic 720p clip: StreamDriver at S=1
     and StreamEngine.stabilize_clip at S=4, with the kernels' launch counts
     read around each run;
  5. card against CPU in f32 (TF32 off), 8 frames;
  6. times: CUDA events, 5 warm-ups, median of 50 runs.
The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}.  Needs CUDA and the repository
beside it; imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
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

def phase_device():
    from stabnet_tpu_torch.ops import cuda_build

    card = card_line()
    t0 = time.perf_counter()
    cuda_build.load("warp")
    build_s = time.perf_counter() - t0
    with open(cuda_build.library_path("warp") + ".log", errors="replace") as f:
        regs = [ln.strip() for ln in f if "registers" in ln]
    print(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | csrc/warp.cu built and loaded in {build_s:.2f} s | {'; '.join(regs)}")
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

    cuda_warp.reset_launch_counts()
    res = driver.stabilize_clip(clips[0])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in cuda_warp.KERNELS}
    check(launches == {"bilinear_sample": refine * (T - 1),
                       "warp_uint8_cf_lowres": T - 1},
          f"S=1 launches {launches}, expected {refine * (T - 1)} / {T - 1}")
    check(res.frames.shape == (T,) + CLIP_HW + (3,) and res.frames.dtype == np.uint8,
          f"S=1 frames {res.frames.shape} {res.frames.dtype}")
    share1 = check_clip(res.all_black, res.crop_rect, "S=1")

    S = clips.shape[0]
    grays = host_grays(clips, cfg)
    cuda_warp.reset_launch_counts()
    warped, state = engine.stabilize_clip(grays, clips)
    torch.cuda.synchronize()
    launches4 = {k.__name__: k.launches for k in cuda_warp.KERNELS}
    check(launches4 == {"bilinear_sample": refine * (T - 1),
                        "warp_uint8_cf_lowres": T - 1},
          f"S={S} launches {launches4}")
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
