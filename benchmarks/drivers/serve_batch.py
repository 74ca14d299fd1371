"""Offline batch serving: `StreamDriver.stabilize_batch`, closed loop.

The cell's clips (host uint8 arrays, as a caller holds decoded video) go in
back to back, and each call returns the stabilized frames and the crop
rectangle of every clip in host memory.  The window holds the driver's host
preparation (the grays, the color copies), the upload, the replays of the
engine's graph and the read-back.

Correct: after the window, the results of two calls (the last, and one drawn
from the seed among the rest) are held against the plain reference run over
the same clips: the worst frame's mean gap in uint8 levels, and the worst
clip's mean gap of the black counts the crop is cut from (frames per
model-scale pixel).  The largest gap of a crop rectangle's side, in model
pixels, is read beside them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks.drivers import serving
from benchmarks.harness import checks
from benchmarks.traffic.video import make_clips, sub_seed


class Cell:
    def __init__(self, ctx):
        from stabnet_tpu_torch.stream.driver import DeployOptions, StreamDriver
        from stabnet_tpu_torch.stream.engine import StreamEngine

        self.ctx = ctx
        wl, cfg = ctx.wl, ctx.cfg
        prog = serving.program_config(cfg)
        model, self.W = serving.make_model(ctx, prog, ctx.seed)
        engine = StreamEngine(model, prog, refine=cfg["refine"], device=ctx.device)
        self.driver = StreamDriver(engine, DeployOptions(refine=cfg["refine"]))
        self.clips = self.make_clips(ctx.seed)
        for _ in range(wl.get("warmup_calls", 2)):
            self.driver.stabilize_batch(self.clips)
        self.counters = {"frames": 0, "calls": 0, "pre_s": 0.0, "scan_s": 0.0,
                         "flops_per_frame": serving.flops_per_frame(cfg),
                         "k2m_shape": [wl["clips"], cfg["height"], cfg["width"]],
                         "k1_shape": [wl["clips"], 3, *wl["out_hw"], *wl["out_hw"],
                                      cfg["height"] // 4, cfg["width"] // 4]}
        self.attempted = self.failed = 0
        self.kept = []
        self.pick = np.random.RandomState(sub_seed(ctx.seed, 2))

    def make_clips(self, seed: int):
        wl = self.ctx.wl
        clips = make_clips(seed, wl["clips"], wl["frames"], wl["out_hw"], wl["jitter"],
                           self.ctx.device)
        return [c.cpu().numpy() for c in clips]

    def reading(self, seed: int, control=None) -> dict:
        """The compared numbers of one call on `seed`'s weights and clips,
        without a window (`benchmarks/limits.py`); with `control`, of the
        reference at that precision in the program's place."""
        self.W = serving.load_weights(self.driver.engine.model, self.ctx, seed)
        self.clips = self.make_clips(seed)
        if control is not None:
            return self.gaps(None, quant=control)
        return self.gaps([self.driver.stabilize_batch(self.clips)])

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        calls, kept = 0, None
        while time.perf_counter() - t0 < seconds:
            with self.ctx.span("stabilize_batch"):
                results = self.driver.stabilize_batch(self.clips)
            calls += 1
            # A reservoir of one earlier call, drawn from the seed.
            if kept is not None and self.pick.randint(calls - 1) == 0:
                self.kept = [kept]
            kept = results
            s = results[0].stage_summary
            self.counters["pre_s"] += s["pre"]["total_s"]
            self.counters["scan_s"] += s["scan"]["total_s"]
            self.counters["frames"] += sum(r.num_frames - 1 for r in results)
        self.elapsed = time.perf_counter() - t0
        self.kept.append(kept)
        self.counters["calls"] = calls
        self.attempted = calls * len(self.clips)
        self.failed = 0

    def end_to_end(self) -> dict:
        return {"frames_per_s": self.counters["frames"] / self.elapsed}

    def check(self):
        """The kept calls against the reference, the program's state freed
        first."""
        self.driver = None
        serving.free_cuda()
        values = self.gaps([r for r in self.kept if r is not None])
        self.kept = []
        return checks.compare(values, self.ctx.wl["limits"])

    def gaps(self, calls, quant=None) -> dict:
        """The compared numbers of the served `calls` (each a list of
        `ClipResult`), or, where `calls` is None, of the reference computed
        at `quant` in the program's place (the control)."""
        ctx, cfg, wl = self.ctx, self.ctx.cfg, self.ctx.wl
        dev = ctx.device
        T, out_hw = wl["frames"], tuple(wl["out_hw"])
        clips = self.clips

        def colors_at(t):
            return torch.from_numpy(np.stack([c[t] for c in clips])).to(dev)

        if calls is None:
            store = []
            black = serving.ref_serve.stabilize(
                self.W, colors_at, T, cfg, out_hw, quant=quant,
                on_frame=lambda t, w: store.append(w))
            rects = [[serving.ref_geo.max_clear_rect(b) for b in black]]
            blacks = [black]
            first_gap = 0.0

            def served_at(t):
                return [store[t - 1]]
        else:
            rects = [[x.crop_rect for x in r] for r in calls]
            blacks = [np.stack([x.all_black for x in r]) for r in calls]
            first_gap = max(float(np.abs(x.frames[0].astype(np.int16) - c[0]).mean())
                            for r in calls for x, c in zip(r, clips))

            def served_at(t):
                return [torch.from_numpy(np.stack([x.frames[t] for x in r])).to(dev)
                        for r in calls]
        gaps, black = serving.reference_gaps(self.W, cfg, colors_at, T, out_hw,
                                             served_at)
        return {"frame_gap": max(first_gap, gaps.worst),
                "black_gap": max(float(np.abs(b.astype(np.int64) - black).mean(axis=(1, 2)).max())
                                 for b in blacks),
                "crop_gap": serving.crop_gap(rects, black)}
