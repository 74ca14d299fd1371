"""Build training shards from raw stable/unstable video pairs.

The PyTorch port of stabnet_tpu/data/ingest.py.  The reference trains only
on pre-baked DeepStab TFRecords, made by an offline pipeline that is not in
its repository; this module ingests plain video pairs instead:

  * frames: decoded and reduced to model-scale uint8 grayscale (the
    reference's `cvt_img2train`, through stream.video_io);
  * feature matches: ORB, cross-checked Hamming matching and homography
    RANSAC on each (stable, unstable) frame pair, through OpenCV on the
    host, normalized to the feature loss's [-1, 1] coordinates (reference
    feature_fetcher.py:11-17 normalizes its SIFT matches the same way);
  * optical flow: not baked; `train --compute-flow` estimates it on the
    device from the augmented stable pair (ops/flow.py).

`clips_to_examples` works on in-memory arrays; `video_pair_to_examples`
wraps it for video files; `build_dataset` drives the DeepStab directory
layout (prefix/{stable,unstable}/<name>) for the `make-dataset` command.
Everything here is host code: it needs OpenCV and no card.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.data.records import write_shards
from stabnet_tpu_torch.stream import video_io
from stabnet_tpu_torch.utils import get_logger

logger = get_logger()

# ORB features per frame and the RANSAC reprojection threshold in pixels
# (the JAX package's defaults).
_N_FEATURES = 1500
_RANSAC_PX = 4.0


def _to_u8_gray(frame: np.ndarray, cfg: StabNetConfig) -> np.ndarray:
    """BGR (or gray) frame of any size -> model-scale uint8 grayscale."""
    g = video_io.to_gray_train(frame, cfg.height, cfg.width)   # [-0.5, 0.5] f32
    return np.clip(np.round((g + 0.5) * 255.0), 0, 255).astype(np.uint8)


def match_frames(stable_u8: np.ndarray, unstable_u8: np.ndarray,
                 cfg: StabNetConfig):
    """ORB matches between one stable/unstable frame pair.

    Returns (matches (max_matches, 4) float32 rows [x_s, y_s, x_u, y_u] in
    [-1, 1], mask (max_matches,) bool).  Matches are cross-checked, then
    filtered by homography RANSAC: a stabilization pair is related by a
    near-global motion, so the inliers are the correspondences the feature
    loss wants.  Raises RuntimeError without OpenCV (never empty matches).
    """
    cv2 = video_io._require_cv2("ORB feature matching needs it (pip install opencv-python)")
    H, W = stable_u8.shape
    orb = cv2.ORB_create(nfeatures=_N_FEATURES)
    k1, d1 = orb.detectAndCompute(stable_u8, None)
    k2, d2 = orb.detectAndCompute(unstable_u8, None)
    out = np.zeros((cfg.max_matches, 4), np.float32)
    mask = np.zeros((cfg.max_matches,), np.bool_)
    if d1 is None or d2 is None or len(k1) < 8 or len(k2) < 8:
        return out, mask
    bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
    raw = bf.match(d1, d2)
    if len(raw) < 8:
        return out, mask
    pts_s = np.float32([k1[m.queryIdx].pt for m in raw])
    pts_u = np.float32([k2[m.trainIdx].pt for m in raw])
    _, inl = cv2.findHomography(pts_s, pts_u, cv2.RANSAC, _RANSAC_PX)
    if inl is None:
        return out, mask
    keep = inl.ravel().astype(bool)
    pts_s, pts_u = pts_s[keep], pts_u[keep]
    n = min(len(pts_s), cfg.max_matches)
    out[:n, 0] = 2.0 * pts_s[:n, 0] / W - 1.0
    out[:n, 1] = 2.0 * pts_s[:n, 1] / H - 1.0
    out[:n, 2] = 2.0 * pts_u[:n, 0] / W - 1.0
    out[:n, 3] = 2.0 * pts_u[:n, 1] / H - 1.0
    mask[:n] = True
    return out, mask


def clips_to_examples(stable_u8: np.ndarray, unstable_u8: np.ndarray,
                      cfg: StabNetConfig, stride: int = 4,
                      max_examples: Optional[int] = None
                      ) -> List[Dict[str, np.ndarray]]:
    """Model-scale uint8 gray clips (T, H, W) -> raw Siamese examples.

    The channel layout is the record schema's (data/synthetic.py
    `make_raw_example`; reference get_data_mini_after.py:178-196): for each
    Siamese base in (pos-1, pos), the stable history at offsets
    `cfg.indices` and the unstable frame at the base.  No flow field is
    emitted: train with `--compute-flow`.
    """
    T = min(len(stable_u8), len(unstable_u8))
    span = max(cfg.indices)
    lookahead = max(0, -min(cfg.indices))   # negative offsets read future frames
    examples = []
    for pos in range(span + 1, T - lookahead, stride):
        stable_ch = [stable_u8[base - i]
                     for base in (pos - 1, pos)
                     for i in cfg.indices if i >= 0]
        unstable_ch = [unstable_u8[base - i]
                       for base in (pos - 1, pos)
                       for i in cfg.indices if i <= 0]
        matches1, mask1 = match_frames(stable_u8[pos - 1], unstable_u8[pos - 1], cfg)
        matches2, mask2 = match_frames(stable_u8[pos], unstable_u8[pos], cfg)
        examples.append({
            "stable": np.stack(stable_ch, axis=-1),
            "unstable": np.stack(unstable_ch, axis=-1),
            "matches1": matches1,
            "mask1": mask1,
            "matches2": matches2,
            "mask2": mask2,
        })
        if max_examples and len(examples) >= max_examples:
            break
    return examples


def video_pair_to_examples(stable_path: str, unstable_path: str,
                           cfg: StabNetConfig, stride: int = 4,
                           max_examples: Optional[int] = None
                           ) -> List[Dict[str, np.ndarray]]:
    """Decode a stable/unstable video pair and build raw examples."""
    def read(path):
        r = video_io.VideoReader(path)
        frames = [_to_u8_gray(f, cfg) for f in r]
        r.close()
        return (np.stack(frames) if frames
                else np.zeros((0, cfg.height, cfg.width), np.uint8))

    return clips_to_examples(read(stable_path), read(unstable_path), cfg,
                             stride=stride, max_examples=max_examples)


def build_dataset(prefix: str, names: Sequence[str], out_dir: str,
                  cfg: StabNetConfig, stride: int = 4,
                  max_per_video: Optional[int] = None) -> int:
    """DeepStab-layout directory (prefix/{stable,unstable}/<name>) -> shards
    under `out_dir`; returns the number of examples."""
    examples: List[Dict[str, np.ndarray]] = []
    for name in names:
        sp = os.path.join(prefix, "stable", name)
        up = os.path.join(prefix, "unstable", name)
        if not (os.path.exists(sp) and os.path.exists(up)):
            logger.warning("skipping %s: missing stable or unstable video", name)
            continue
        ex = video_pair_to_examples(sp, up, cfg, stride=stride,
                                    max_examples=max_per_video)
        n_matched = sum(int(e["mask1"].sum() > 0) for e in ex)
        logger.info("%s: %d examples (%d with matches)", name, len(ex), n_matched)
        examples.extend(ex)
    if not examples:
        raise ValueError(f"no examples built from {prefix} ({list(names)})")
    write_shards(out_dir, examples)
    return len(examples)
