"""Training debug visualizer (the PyTorch port of
stabnet_tpu/train/visualize.py).

The reference's `save_warpped_features` (train_bundle_nobm.py:41-94): for a
batch, per-example mosaics of [stable | net output ; |error| | unstable
with the matches drawn], the per-channel input stack of the first example,
and each example's per-cell homographies as text.  Written with OpenCV on
the host; without it the dump is skipped with a warning.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.utils import get_logger, host_array

logger = get_logger()

# Examples of a batch drawn per dump (the JAX package's default).
_MAX_EXAMPLES = 4


def _to_u8(img: np.ndarray) -> np.ndarray:
    """Model-scale [-0.5, 0.5] (H, W) -> uint8 (H, W, 3)."""
    g = np.clip((np.asarray(img).squeeze() + 0.5) * 255.0, 0, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=-1)


def _draw_points(img: np.ndarray, pts_ndc: np.ndarray, mask: np.ndarray,
                 color) -> np.ndarray:
    """Draw NDC points as circles (reference: draw, train_bundle_nobm.py:45-55)."""
    try:
        import cv2
    except ImportError:
        return img
    out = img.copy()
    H, W = img.shape[:2]
    px = ((pts_ndc[:, 0] / 2 + 0.5) * W).astype(np.int32)
    py = ((pts_ndc[:, 1] / 2 + 0.5) * H).astype(np.int32)
    for x, y, m in zip(px, py, mask):
        if m:
            cv2.circle(out, (int(x), int(y)), 5, color, 1)
    return out


def save_debug_batch(out_dir: str, batch: Dict, outputs, cfg: StabNetConfig,
                     step: int) -> List[np.ndarray]:
    """Write debug mosaics for up to `_MAX_EXAMPLES` of a Siamese batch.

    Args:
      batch: augmented training batch (x1/y1/matches1/mask1/...), numpy
        arrays or tensors on any device.
      outputs: `models.stabnet.StabNetOutput` of branch 1 (x1).

    Returns:
      The mosaics written ((2H, 2W, 3) uint8 BGR each), for other sinks
      such as TensorBoard; [] without OpenCV.
    """
    try:
        import cv2
    except ImportError:
        logger.warning("cv2 unavailable; skipping debug dump")
        return []
    os.makedirs(out_dir, exist_ok=True)

    x1 = host_array(batch["x1"])
    y1 = host_array(batch["y1"])
    matches = host_array(batch["matches1"])
    mask = host_array(batch["mask1"]) > 0.5
    out_img = host_array(outputs.warp.output)
    Hs = host_array(outputs.warp.Hs)

    mosaics = []
    for b in range(min(x1.shape[0], _MAX_EXAMPLES)):
        stable = _draw_points(_to_u8(y1[b]), matches[b, :, :2], mask[b], (0, 0, 255))
        unstable = _to_u8(x1[b, :, :, cfg.cur_channel])
        unstable = _draw_points(unstable, matches[b, :, 2:], mask[b], (0, 255, 0))
        net = _to_u8(out_img[b])
        err = np.abs(net.astype(np.int32) - _to_u8(y1[b]).astype(np.int32))
        top = np.concatenate([stable, net], axis=1)
        bottom = np.concatenate([err.astype(np.uint8), unstable], axis=1)
        mosaic = np.concatenate([top, bottom], axis=0)
        mosaics.append(mosaic)
        cv2.imwrite(os.path.join(out_dir, f"step{step:06d}-ex{b}.jpg"), mosaic)
        np.savetxt(os.path.join(out_dir, f"step{step:06d}-ex{b}-Hs.txt"),
                   Hs[b].reshape(-1, 9))

    # Per-channel input stack of example 0 (the reference dumps x1-%d.jpg).
    for c in range(x1.shape[-1]):
        cv2.imwrite(os.path.join(out_dir, f"step{step:06d}-x1-ch{c}.jpg"),
                    _to_u8(x1[0, :, :, c]))
    logger.info("wrote debug dump for step %d to %s", step, out_dir)
    return mosaics
