"""Synthetic shaky clips, made on the device from a seed.

A copy of the program's `data/synthetic.make_video` (a drifting sinusoid
texture with a box, translated rigidly frame by frame, plus uniform jitter,
three equal channels), computed in float32 on the device so that hundreds of
720p frames take milliseconds.  The draws (phases, drift, jitter) come from
a `numpy.random.RandomState` of the clip's own seed, as there.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 32-bit seed for one part of a run, from the run's `--seed` (any
    size) and the part's position."""
    return int(np.random.SeedSequence([int(seed) % (1 << 63), *path]).generate_state(1)[0])


def make_clip(seed: int, frames: int, height: int, width: int, jitter: float,
              device) -> torch.Tensor:
    """(frames, height, width, 3) uint8 on `device`."""
    rng = np.random.RandomState(seed)
    phase_x = rng.uniform(0, 2 * np.pi)
    phase_y = rng.uniform(0, 2 * np.pi)
    drift = np.cumsum(rng.uniform(-1.5, 1.5, (frames, 2)), axis=0)
    shake = (rng.uniform(-jitter, jitter, (frames, 2)) if jitter
             else np.zeros((frames, 2)))
    off = torch.as_tensor(drift + shake, dtype=torch.float32, device=device)
    dx, dy = off[:, 0, None, None], off[:, 1, None, None]
    xs = torch.arange(width, dtype=torch.float32, device=device)[None, None, :]
    ys = torch.arange(height, dtype=torch.float32, device=device)[None, :, None]
    img = (127.5 + 60 * torch.sin(2 * math.pi * (xs + dx) / 37 + phase_x)
           + 50 * torch.sin(2 * math.pi * (ys + dy) / 29 + phase_y))
    cbx = (17 * seed + 11) % max(width - 24, 1)
    cby = (13 * seed + 7) % max(height - 20, 1)
    in_box = (torch.remainder(xs + dx - cbx, width) < 20) & (torch.remainder(ys + dy - cby, height) < 16)
    img = torch.where(in_box, 255.0 if seed % 2 == 0 else 0.0, img)
    gray = img.clamp(0, 255).to(torch.uint8)
    return gray[..., None].expand(-1, -1, -1, 3).contiguous()


def make_clips(seed: int, count: int, frames: int, hw: Sequence[int], jitter: float,
               device) -> torch.Tensor:
    """(count, frames, H, W, 3) uint8: `count` clips, each of its own seed."""
    return torch.stack([make_clip(sub_seed(seed, 1, c), frames, hw[0], hw[1], jitter, device)
                        for c in range(count)])
