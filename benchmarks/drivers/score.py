"""Clip scoring: `eval/metrics.score_stabilized_clip`, closed loop.

The scorer of `stabilize --metrics`: each call takes a stabilized clip (host
uint8 frames at the output size), the clip's model-scale input grays and its
crop rectangle, and returns its stability, cropping and distortion scores,
the input's stability and the retained crop area.  The cell's clips go in
back to back, in turn; the window ends when the clip in hand is scored, so
no clip is counted in part or dropped.  The frames are made from the seed:
a slowly drifting clip stands for the stabilized output, the same texture
under the cell's jitter for the input.

Correct: after the window, one clip's scores, drawn from the seed among
those scored, against the plain reference's (`reference/score.py`) on the
same inputs: the largest gap over the five scores.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks.drivers import serving
from benchmarks.harness import checks
from benchmarks.reference import geometry as ref_geo
from benchmarks.reference import score as ref_score
from benchmarks.traffic.video import make_clip, sub_seed


class Cell:
    def __init__(self, ctx):
        from stabnet_tpu_torch.eval.metrics import score_stabilized_clip

        self.ctx = ctx
        self.score = score_stabilized_clip
        serving.program_config(ctx.cfg)
        self.hw = (ctx.cfg["height"], ctx.cfg["width"])
        self.clips = [self.make(ctx.seed, k) for k in range(ctx.wl["clips"])]
        for clip in self.clips:       # every shape and graph the window replays
            self.run(clip)
        self.counters = {"frames": 0, "clips": 0}
        self.attempted = self.failed = 0

    def make(self, seed: int, k: int) -> tuple:
        """Clip k: (frames (T, Ho, Wo, 3) uint8 host, input grays (T, H, W)
        float32 host, crop rectangle at model scale)."""
        wl, dev = self.ctx.wl, self.ctx.device
        s = sub_seed(seed, 6, k)
        T, out_hw = wl["frames"], wl["out_hw"]
        out = make_clip(s, T, out_hw[0], out_hw[1], wl["output_jitter"], dev)
        inp = make_clip(s, T, out_hw[0], out_hw[1], wl["jitter"], dev)
        gray = ref_geo.gray_host(inp, self.hw).float()
        rng = np.random.RandomState(s)
        m = wl["crop_margin"]
        h, w = self.hw
        rect = (int(rng.randint(1, m[0])), int(rng.randint(1, m[1])),
                h - 1 - int(rng.randint(1, m[0])), w - 1 - int(rng.randint(1, m[1])))
        return out.cpu().numpy(), gray.cpu().numpy(), rect

    def run(self, clip) -> dict:
        frames, gray, rect = clip
        return self.score(frames, gray, self.hw, crop_rect=rect, device=self.ctx.device)

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        done = []
        while time.perf_counter() - t0 < seconds:
            k = len(done) % len(self.clips)
            with self.ctx.span("score"):
                done.append((k, self.run(self.clips[k])))
        self.elapsed = time.perf_counter() - t0
        self.done = done
        frames = sum(len(self.clips[k][0]) for k, _ in done)
        self.counters.update(frames=frames, clips=len(done))
        self.attempted, self.failed = len(done), 0

    def end_to_end(self) -> dict:
        return {"scored_frames_per_s": self.counters["frames"] / self.elapsed}

    def check(self):
        pick = np.random.RandomState(sub_seed(self.ctx.seed, 7)).randint(len(self.done))
        k, scores = self.done[pick]
        self.done = None
        serving.free_cuda()
        return checks.compare(self.gaps(self.clips[k], scores), self.ctx.wl["limits"])

    def gaps(self, clip, served: dict, dtype=torch.float32) -> dict:
        frames, gray, rect = clip
        dev = self.ctx.device
        ref = ref_score.score_clip(torch.from_numpy(frames).to(dev),
                                   torch.from_numpy(gray).to(dev), self.hw, rect)
        if served is None:       # the control: the reference at `dtype`
            served = ref_score.score_clip(torch.from_numpy(frames).to(dev),
                                          torch.from_numpy(gray).to(dev), self.hw, rect,
                                          dtype=dtype)
        return {"score_gap": max(abs(served[k] - ref[k]) for k in ref)}

    def reading(self, seed: int, control=None) -> dict:
        """The compared numbers on `seed`'s first clip
        (`benchmarks/limits.py`); with `control`, of the reference with its
        flow in bfloat16 in the program's place."""
        clip = self.make(seed, 0)
        if control is not None:
            return self.gaps(clip, None, dtype=torch.bfloat16)
        return self.gaps(clip, self.run(clip))
