"""A training corpus in the program's record format, made from a seed.

A copy of the program's `data/synthetic.make_raw_example` (the frames of a
stable and a shaky synthetic clip of one texture, the dense flow between the
stable pair and noisy feature matches that follow the shake), with the clips
rendered on the device by `video.make_clip`, and of `data/records.
write_shards`' format: compressed `shard-NNNNN.npz` archives of stacked
arrays and an `n` count, named in `list.txt`.  Example k of a corpus is drawn
from its own sub-seed of the run's seed.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List

import numpy as np
import torch

from benchmarks.traffic.video import make_clip, sub_seed

SHARD_KEYS = ("stable", "unstable", "flow", "matches1", "mask1", "matches2", "mask2")


def offsets(seed: int, frames: int, jitter: float) -> np.ndarray:
    """(frames, 2) per-frame (dx, dy) of `make_clip(seed, ..., jitter)`: the
    same draws in the same order."""
    rng = np.random.RandomState(seed)
    rng.uniform(0, 2 * np.pi, 2)
    drift = np.cumsum(rng.uniform(-1.5, 1.5, (frames, 2)), axis=0)
    shake = rng.uniform(-jitter, jitter, (frames, 2)) if jitter else np.zeros((frames, 2))
    return drift + shake


def make_example(cfg: dict, seed: int, device) -> Dict[str, np.ndarray]:
    """One raw Siamese example: `stable` (H, W, 2 (before + 1)) uint8, the
    current stable frame and its history at `indices`, first for the step
    before the last frame, then for the last; `unstable` (H, W, 2) uint8,
    the shaky current frames of both steps; `flow` (H, W, 2) float32, NDC
    positions in the last stable frame of each pixel of the one before;
    `matches1`/`2` (max_matches, 4) float32 [x, y stable, x, y unstable] in
    NDC with their masks (a quarter to a half of the rows used)."""
    H, W = cfg["height"], cfg["width"]
    rng = np.random.RandomState(seed)
    jitter = float(rng.uniform(1.0, 6.0))
    span = max(cfg["indices"]) + 2
    stable = make_clip(seed, span + 1, H, W, 0.0, device)[..., 0]
    unstable = make_clip(seed, span + 1, H, W, jitter, device)[..., 0]
    st_off = offsets(seed, span + 1, 0.0)
    un_off = offsets(seed, span + 1, jitter)
    pos = span
    st = [base - i for base in (pos - 1, pos) for i in cfg["indices"] if i >= 0]
    un = [base - i for base in (pos - 1, pos) for i in cfg["indices"] if i <= 0]
    delta = st_off[pos - 1] - st_off[pos]
    xp, yp = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    flow = np.stack([2.0 * (xp + delta[0]) / W - 1.0, 2.0 * (yp + delta[1]) / H - 1.0],
                    axis=-1).astype(np.float32)

    def matches(t):
        shake = un_off[t] - st_off[t]
        M = cfg["max_matches"]
        n = rng.randint(M // 4, M // 2)
        out = np.zeros((M, 4), np.float32)
        pts = rng.uniform(-0.9, 0.9, (n, 2)).astype(np.float32)
        noise = rng.uniform(-0.005, 0.005, (n, 2)).astype(np.float32)
        out[:n, :2] = pts
        out[:n, 2] = pts[:, 0] - 2.0 * shake[0] / W + noise[:, 0]
        out[:n, 3] = pts[:, 1] - 2.0 * shake[1] / H + noise[:, 1]
        mask = np.zeros((M,), np.bool_)
        mask[:n] = True
        return out, mask

    m1, k1 = matches(pos - 1)
    m2, k2 = matches(pos)
    return {"stable": stable[st].permute(1, 2, 0).cpu().numpy(),
            "unstable": unstable[un].permute(1, 2, 0).cpu().numpy(),
            "flow": flow, "matches1": m1, "mask1": k1, "matches2": m2, "mask2": k2}


def write_corpus(path: str, cfg: dict, seed: int, shards: int, per_shard: int,
                 device) -> List[str]:
    """Replace whatever `path` holds with `shards` shards of `per_shard`
    examples each from `seed`; returns the shards' names."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    names = []
    with torch.no_grad():
        for s in range(shards):
            exs = [make_example(cfg, sub_seed(seed, 8, s * per_shard + i), device)
                   for i in range(per_shard)]
            name = f"shard-{s:05d}.npz"
            np.savez_compressed(os.path.join(path, name), n=per_shard,
                                **{k: np.stack([e[k] for e in exs]) for k in SHARD_KEYS})
            names.append(name)
    with open(os.path.join(path, "list.txt"), "w") as f:
        f.write(" ".join(names))
    return names
