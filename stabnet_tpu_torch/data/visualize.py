"""Data-pipeline visual checks (the PyTorch port of
stabnet_tpu/data/visualize.py).

The reference's manual harnesses (get_data_mini_after.py:255-323: `run()`
dumps a batch's channel stack as images, `test()` draws the feature
matches over a stable/unstable pair) as image files from any record
directory: `python -m stabnet_tpu_torch.cli.main inspect-data`.  The
images are written with OpenCV on the host; without it the dump is skipped
with a warning.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.utils import get_logger, host_array, resolve_device

logger = get_logger()


def _u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img).squeeze()
    if img.dtype == np.uint8:
        g = img
    else:
        g = np.clip((img + 0.5) * 255.0, 0, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=-1)


def dump_example(out_dir: str, example, cfg: StabNetConfig, name: str = "ex",
                 augmented: bool = False) -> None:
    """Write per-channel images and a match overlay of one example.

    `example` is a raw record (keys stable/unstable/...) or an augmented
    example (keys x1/y1/...), as numpy arrays or tensors on any device.
    """
    try:
        import cv2
    except ImportError:
        logger.warning("cv2 unavailable; skipping data dump")
        return
    os.makedirs(out_dir, exist_ok=True)

    if augmented:
        x1 = host_array(example["x1"])
        y1 = host_array(example["y1"])
        for c in range(x1.shape[-1]):
            cv2.imwrite(os.path.join(out_dir, f"{name}-x1-ch{c}.jpg"), _u8(x1[:, :, c]))
        cv2.imwrite(os.path.join(out_dir, f"{name}-y1.jpg"), _u8(y1))
        stable = _u8(y1)
        unstable = _u8(x1[:, :, cfg.cur_channel])
        matches = host_array(example["matches1"])
        mask = host_array(example["mask1"]) > 0.5
    else:
        stable_stack = host_array(example["stable"])
        for c in range(stable_stack.shape[-1]):
            cv2.imwrite(os.path.join(out_dir, f"{name}-stable-ch{c}.jpg"),
                        _u8(stable_stack[:, :, c]))
        unstable_stack = host_array(example["unstable"])
        for c in range(unstable_stack.shape[-1]):
            cv2.imwrite(os.path.join(out_dir, f"{name}-unstable-ch{c}.jpg"),
                        _u8(unstable_stack[:, :, c]))
        stable = _u8(stable_stack[:, :, 0])
        unstable = _u8(unstable_stack[:, :, 1])
        matches = host_array(example["matches1"])
        mask = host_array(example["mask1"]).astype(bool)

    # Side-by-side match rendering (reference: test(), lines drawn between
    # the stable and unstable coordinates of one in ten matches).
    H, W = stable.shape[:2]
    panel = np.concatenate([stable, unstable], axis=1)
    rng = np.random.RandomState(0)
    for (xs, ys, xu, yu), m in zip(matches, mask):
        if not m or rng.rand() > 0.1:
            continue
        p1 = (int((xs / 2 + 0.5) * W), int((ys / 2 + 0.5) * H))
        p2 = (int((xu / 2 + 0.5) * W) + W, int((yu / 2 + 0.5) * H))
        cv2.line(panel, p1, p2, tuple(int(v) for v in rng.rand(3) * 255), 1)
    cv2.imwrite(os.path.join(out_dir, f"{name}-matches.jpg"), panel)
    logger.info("wrote data dump '%s' to %s", name, out_dir)


def inspect_dataset(record_dir: str, out_dir: str, cfg: StabNetConfig,
                    num: int = 2, device=None) -> None:
    """Dump the first `num` examples raw and augmented on `device` (CUDA
    unless the CPU is asked for), example i with the draws of
    `torch.Generator().manual_seed(i)`."""
    from stabnet_tpu_torch.data.augment import augment_example, prepare_raw
    from stabnet_tpu_torch.data.records import iterate_examples

    dev = resolve_device(device)
    for i, ex in enumerate(iterate_examples(record_dir, epochs=1, shuffle=False)):
        if i >= num:
            break
        dump_example(out_dir, ex, cfg, name=f"raw{i}")
        raw = {k: torch.from_numpy(v).to(dev) for k, v in prepare_raw(ex).items()}
        aug = augment_example(torch.Generator().manual_seed(i), raw, cfg)
        dump_example(out_dir, aug, cfg, name=f"aug{i}", augmented=True)
