"""Synthetic clips and raw training examples, in numpy (the reference ships
none of its DeepStab data).  A synthetic "video" is a smoothly drifting
textured pattern; the "unstable" variant adds jitter, so the stabilization
problem is real but tiny.  The same functions, with the same `RandomState`
draws, as the JAX package's data/synthetic.py: their outputs are equal.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from stabnet_tpu_torch.config import StabNetConfig


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


def to_gray_train(frame: np.ndarray) -> np.ndarray:
    """uint8 (H, W, C) -> float32 (H, W) in [-0.5, 0.5] (reference: config.py:6-21)."""
    if frame.ndim == 3:
        # BT.601 luma, matching cv2 BGR2GRAY / tf rgb_to_grayscale weights.
        b, g, r = frame[..., 0], frame[..., 1], frame[..., 2]
        gray = 0.114 * b + 0.587 * g + 0.299 * r
    else:
        gray = frame.astype(np.float32)
    return gray.astype(np.float32) / 255.0 - 0.5


def make_raw_example(cfg: StabNetConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """One raw Siamese example in the layout `augment_batch` expects.

    The shake magnitude is drawn per example from a wide range (the
    reference trains on footage whose shake spans calm to violent).  The
    flow and the feature matches are consistent with the rendered motion:
    a random flow or random matches would make the temporal and feature
    losses unsatisfiable.
    """
    rng = np.random.RandomState(seed)
    jitter = float(rng.uniform(1.0, 6.0))
    span = max(cfg.indices) + 2
    stable_clip, st_off = make_video(span + 1, cfg.height, cfg.width,
                                     seed=seed, return_offsets=True)
    unstable_clip, un_off = make_video(span + 1, cfg.height, cfg.width,
                                       seed=seed, jitter=jitter,
                                       return_offsets=True)
    pos = span  # last frame index

    def g(clip, t):
        return to_gray_train(clip[t])

    def to_u8(f):
        return np.clip(np.round((f + 0.5) * 255.0), 0, 255).astype(np.uint8)

    stable = np.stack([to_u8(g(stable_clip, base - i))
                       for base in (pos - 1, pos) for i in cfg.indices if i >= 0],
                      axis=-1)
    unstable = np.stack([to_u8(g(unstable_clip, base - i))
                         for base in (pos - 1, pos) for i in cfg.indices if i <= 0],
                        axis=-1)

    # flow(p): where the content at p of stable frame pos-1 sits in stable
    # frame pos, p + d_{pos-1} - d_pos, in the sampler's (x+1)*size/2 NDC.
    delta = st_off[pos - 1] - st_off[pos]                  # (dx, dy) pixels
    xp, yp = np.meshgrid(np.arange(cfg.width, dtype=np.float32),
                         np.arange(cfg.height, dtype=np.float32))
    flow = np.stack(
        [
            2.0 * (xp + delta[0]) / cfg.width - 1.0,
            2.0 * (yp + delta[1]) / cfg.height - 1.0,
        ],
        axis=-1,
    ).astype(np.float32)

    # Matches [x_stable, y_stable, x_unstable, y_unstable]: for a pure
    # translation p_unstable = p_stable - shake_t, plus SIFT-like noise.
    def make_matches(t):
        shake = un_off[t] - st_off[t]
        n = rng.randint(cfg.max_matches // 4, cfg.max_matches // 2)
        matches = np.zeros((cfg.max_matches, 4), np.float32)
        pts = rng.uniform(-0.9, 0.9, (n, 2)).astype(np.float32)
        noise = rng.uniform(-0.005, 0.005, (n, 2)).astype(np.float32)
        matches[:n, :2] = pts
        matches[:n, 2] = pts[:, 0] - 2.0 * shake[0] / cfg.width + noise[:, 0]
        matches[:n, 3] = pts[:, 1] - 2.0 * shake[1] / cfg.height + noise[:, 1]
        mask = np.zeros((cfg.max_matches,), np.bool_)
        mask[:n] = True
        return matches, mask

    matches1, mask1 = make_matches(pos - 1)
    matches2, mask2 = make_matches(pos)
    return {"stable": stable, "unstable": unstable, "flow": flow,
            "matches1": matches1, "mask1": mask1,
            "matches2": matches2, "mask2": mask2}


def make_raw_batch(cfg: StabNetConfig, batch_size: int,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """`batch_size` raw examples stacked (example b has seed seed*1000 + b)."""
    exs = [make_raw_example(cfg, seed=seed * 1000 + b) for b in range(batch_size)]
    return {k: np.stack([e[k] for e in exs]) for k in exs[0]}
