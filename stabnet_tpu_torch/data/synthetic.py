"""Synthetic test clips, in numpy (the reference ships none of its DeepStab
data).  A synthetic "video" is a smoothly drifting textured pattern; the
"unstable" variant adds jitter, so the stabilization problem is real but tiny.
The same function as the JAX package's data/synthetic.py `make_video`.
"""

from __future__ import annotations

import numpy as np


def make_video(num_frames: int, height: int, width: int, seed: int = 0,
               jitter: float = 0.0, channels: int = 3,
               return_offsets: bool = False) -> np.ndarray:
    """(T, H, W, C) uint8 synthetic clip: drifting sinusoid texture + a box.

    The whole frame translates rigidly by the per-frame (dx, dy) offset
    (returned with `return_offsets`): content at coordinate q sits at pixel
    q - offset[t].  Two clips with the same seed share drift and texture;
    `jitter` adds independent per-frame shake on top (the "unstable" camera).
    The box is periodic in content coordinates, so it re-enters across the
    opposite edge instead of jumping.
    """
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    phase_x = rng.uniform(0, 2 * np.pi)
    phase_y = rng.uniform(0, 2 * np.pi)
    out = np.zeros((num_frames, height, width, channels), np.uint8)
    drift = np.cumsum(rng.uniform(-1.5, 1.5, (num_frames, 2)), axis=0)
    shake = (rng.uniform(-jitter, jitter, (num_frames, 2)) if jitter
             else np.zeros((num_frames, 2)))
    offsets = drift + shake
    box_color = 255 if seed % 2 == 0 else 0        # seed-, not frame-, keyed
    cbx = (17 * seed + 11) % max(width - 24, 1)    # box content coordinates
    cby = (13 * seed + 7) % max(height - 20, 1)
    for t in range(num_frames):
        dx, dy = offsets[t]
        img = (
            127.5
            + 60 * np.sin(2 * np.pi * (xs + dx) / 37 + phase_x)
            + 50 * np.sin(2 * np.pi * (ys + dy) / 29 + phase_y)
        )
        in_box = (((xs + dx - cbx) % width) < 20) & (((ys + dy - cby) % height) < 16)
        img = np.where(in_box, float(box_color), img)
        out[t] = np.clip(img, 0, 255).astype(np.uint8)[..., None].repeat(channels, -1)
    if return_offsets:
        return out, offsets.astype(np.float32)
    return out
