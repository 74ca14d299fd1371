"""Consistent data augmentation, run on the device (PyTorch port of
stabnet_tpu/data/augment.py).

Reference behavior (get_data_mini_after.py:7-147): every training example
draws ONE augmentation parameter set (resize-crop offsets, flip bit,
contrast factor, brightness delta) applied consistently to all decoded
frames AND to the optical-flow map AND to both feature-match point sets,
plus per-history-frame random homography black-border masks.

The JAX package writes each function for one example and vmaps it; here
every function takes a leading batch dimension (AugParams fields of shape
(B,)), which one example is a case of.  The random draws come from a
`torch.Generator` on the host (a few numbers per example); they cannot equal
`jax.random`'s, and need not: given an `AugParams` or a homography, every
function computes what the JAX function computes.  The two intentional
deviations of the JAX package from the reference hold here too
(half-pixel-center resize; per-axis scales in the coordinate fix-up).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.ops.resize import resize_crop_hwc


def prepare_raw(raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Normalize a host raw batch's dtypes for the upload: uint8 frames and
    bool masks stay compact (frames go to model scale on the device),
    everything else becomes float32."""
    return {k: a if a.dtype in (np.bool_, np.uint8) else a.astype(np.float32)
            for k, a in raw.items()}


class AugParams(NamedTuple):
    """One parameter draw per example (reference: get_rand_para); each field
    is a tensor of the batch shape."""

    crop_h: torch.Tensor      # int64 in [0, big_h - height)
    crop_w: torch.Tensor      # int64 in [0, big_w - width)
    flip: torch.Tensor        # bool; the reference uses (crop_h + crop_w) % 2
    contrast: torch.Tensor    # float32 in [0.5, 1.5)
    brightness: torch.Tensor  # float32 in [-32/255, 32/255)

    def to(self, device) -> "AugParams":
        return AugParams(*(t.to(device) for t in self))


def big_size(cfg: StabNetConfig) -> Tuple[int, int]:
    """Upscaled size before the random crop (reference: get_data_mini_after.py:8-9)."""
    return int(cfg.height / cfg.random_crop_rate), int(cfg.width / cfg.random_crop_rate)


def draw_params(generator: torch.Generator, cfg: StabNetConfig,
                batch: int) -> AugParams:
    """`batch` parameter draws from `generator` (CPU tensors)."""
    bh, bw = big_size(cfg)
    crop_h = torch.randint(0, bh - cfg.height, (batch,), generator=generator)
    crop_w = torch.randint(0, bw - cfg.width, (batch,), generator=generator)
    flip = (crop_h + crop_w) % 2 == 1
    contrast = 0.5 + torch.rand((batch,), generator=generator)
    brightness = (torch.rand((batch,), generator=generator) * 2.0 - 1.0) * (32.0 / 255.0)
    return AugParams(crop_h, crop_w, flip, contrast, brightness)


def _per_example(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) parameter broadcast against a (B, ...) tensor."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def warp_img(img: torch.Tensor, p: AugParams, cfg: StabNetConfig) -> torch.Tensor:
    """Resize-crop-flip-contrast-brightness (B, H, W, C) image stacks; all
    channels of an example get the same geometry and photometry (reference:
    warp_img, get_data_mini_after.py:14-29)."""
    crop = resize_crop_hwc(img, big_size(cfg), p.crop_h, p.crop_w,
                           (cfg.height, cfg.width))
    crop = torch.where(_per_example(p.flip, crop), crop.flip(-2), crop)
    # tf.image.random_contrast: per-channel mean-centered scaling.
    mean = crop.mean(dim=(-3, -2), keepdim=True)
    crop = (crop - mean) * _per_example(p.contrast, crop) + mean
    crop = crop + _per_example(p.brightness, crop)
    return crop.clamp(-0.5, 0.5)


def _warp_x_coord(x: torch.Tensor, p: AugParams, cfg: StabNetConfig,
                  flip: bool = True) -> torch.Tensor:
    """NDC x-coordinates (B, ...) under the shared resize-crop(-flip)."""
    bh, bw = big_size(cfg)
    ww = _per_example(p.crop_w.float(), x)
    x = (x + 1.0 - 2.0 * ww / bw) * (bw / cfg.width) - 1.0
    if not flip:
        return x
    return torch.where(_per_example(p.flip, x), -x - 1.0 / cfg.width, x)


def _warp_y_coord(y: torch.Tensor, p: AugParams, cfg: StabNetConfig) -> torch.Tensor:
    bh, bw = big_size(cfg)
    hh = _per_example(p.crop_h.float(), y)
    return (y + 1.0 - 2.0 * hh / bh) * (bh / cfg.height) - 1.0


def warp_flow(flow: torch.Tensor, p: AugParams, cfg: StabNetConfig) -> torch.Tensor:
    """Transform dense NDC correspondence maps (B, H, W, 2) consistently:
    the values get the point transform, the field is resampled like an image
    and, under flip, mirrored (reference: warp_flow,
    get_data_mini_after.py:31-48)."""
    crop = resize_crop_hwc(flow, big_size(cfg), p.crop_h, p.crop_w,
                           (cfg.height, cfg.width))
    fx = _warp_x_coord(crop[..., 0], p, cfg, flip=False)
    fy = _warp_y_coord(crop[..., 1], p, cfg)
    flip = _per_example(p.flip, fx)
    fx = torch.where(flip, -fx.flip(-1) - 1.0 / cfg.width, fx)
    fy = torch.where(flip, fy.flip(-1), fy)
    return torch.stack([fx, fy], dim=-1)


def warp_points(points: torch.Tensor, mask: torch.Tensor, p: AugParams,
                cfg: StabNetConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transform match points (B, N, 4) = [xs, ys, xu, yu]; out-of-frame
    points leave the mask (reference: warp_point, get_data_mini_after.py:50-65)."""
    out = torch.stack([_warp_x_coord(points[..., 0], p, cfg),
                       _warp_y_coord(points[..., 1], p, cfg),
                       _warp_x_coord(points[..., 2], p, cfg),
                       _warp_y_coord(points[..., 3], p, cfg)], dim=-1)
    in_bounds = ((out >= -1.0) & (out <= 1.0)).all(dim=-1)
    return out, in_bounds & mask


# --- synthetic black-border history masking ----------------------------------

def rand_homography(generator: torch.Generator, cfg: StabNetConfig,
                    shape: Tuple[int, ...] = ()) -> torch.Tensor:
    """Random (*shape, 3, 3) homographies, uniform within
    [rand_h_min, rand_h_max] (reference: get_rand_H); CPU tensors."""
    lo = torch.tensor(cfg.rand_h_min(), dtype=torch.float32)
    hi = torch.tensor(cfg.rand_h_max(), dtype=torch.float32)
    u = torch.rand(tuple(shape) + (3, 3), generator=generator)
    return lo + u * (hi - lo)


def homography_oob_mask(H: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(..., height, width) float mask: 1.0 where the (..., 3, 3)
    homographies send the NDC grid out of frame.  A plain z divide, no eps
    (reference: get_rand_mask, get_data_mini_after.py:93-108)."""
    dev = H.device
    xs = torch.linspace(-1.0, 1.0, width, device=dev)
    ys = torch.linspace(-1.0, 1.0, height, device=dev)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([xg, yg, torch.ones_like(xg)], dim=-1)     # (h, w, 3)
    q = torch.einsum("...ij,hwj->...hwi", H.float(), pts)
    x = q[..., 0] / q[..., 2]
    y = q[..., 1] / q[..., 2]
    return ((x < -1) | (x > 1) | (y < -1) | (y > 1)).float()


def add_history_masks(Hs: torch.Tensor, history: torch.Tensor,
                      cfg: StabNetConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paint random black borders onto history frames; return (frames, masks).

    history: (B, H, W, before_ch); Hs: (B, before_ch, 3, 3), one random
    homography per history channel (`rand_homography`), smoothed along the
    channels unless rand_H_change_rate is 1 (v2_93: i.i.d. draws).  Masked
    pixels are set to -1 (reference: add_mask, get_data_mini_after.py:127-147).
    """
    if cfg.rand_H_change_rate != 1.0:
        # H_i <- r H_i + (1 - r) H_{i-1}, in order (reference: get_rand_H).
        r = cfg.rand_H_change_rate
        seq = [Hs[:, 0] * r + Hs[:, 0] * (1 - r)]
        for i in range(1, Hs.shape[1]):
            seq.append(Hs[:, i] * r + seq[-1] * (1 - r))
        Hs = torch.stack(seq, dim=1)
    masks = homography_oob_mask(Hs, cfg.height, cfg.width).permute(0, 2, 3, 1)
    frames = history * (1.0 - masks) + masks * (-1.0)
    return frames, masks


# --- full augmentation ---------------------------------------------------------

def augment_batch(generator: torch.Generator, raw: Dict[str, torch.Tensor],
                  cfg: StabNetConfig, part: Tuple[int, int] = (0, 1)
                  ) -> Dict[str, torch.Tensor]:
    """Raw batch (tensors on the device) -> Siamese training batch.

    Raw layout (records.py, mirroring get_data_mini_after.py:178-226):
      stable:   (B, H, W, 2*(before_ch+1)) uint8 or model scale; channels
                [0..bc] are the frames of step 1 (current stable first),
                [bc+1..] the same for step 2;
      unstable: (B, H, W, 2) the current unstable frames of steps 1 and 2;
      flow:     (B, H, W, 2) NDC correspondence map between the stable pair;
      matches1, matches2: (B, max_matches, 4); mask1, mask2: (B, max_matches).

    Returns x1, y1, x2, y2, flow, matches1, mask1, matches2, mask2 with x*
    of shape (B, H, W, in_channels).  The draws come from `generator`;
    with `part=(index, count)` they are drawn for a global batch of count *
    B examples, and this batch is its index-th slice (a data-parallel rank's
    share, parallel/multihost.py).
    """
    B = raw["stable"].shape[0]
    dev = raw["stable"].device
    bc = cfg.before_ch
    index, count = part
    mine = slice(index * B, (index + 1) * B)
    p = AugParams(*(t[mine] for t in draw_params(generator, cfg, B * count))).to(dev)
    Hs = rand_homography(generator, cfg, (2, B * count, bc))[:, mine].to(dev)

    def to_model_scale(a):
        # uint8 records (4x cheaper upload); model scale is [-0.5, 0.5]
        # (reference: get_img, get_data_mini_after.py:149-156).
        return a.float() / 255.0 - 0.5 if a.dtype == torch.uint8 else a

    stable = warp_img(to_model_scale(raw["stable"]), p, cfg)
    unstable = warp_img(to_model_scale(raw["unstable"]), p, cfg)
    frames1, masks1 = add_history_masks(Hs[0], stable[..., 1: 1 + bc], cfg)
    frames2, masks2 = add_history_masks(Hs[1], stable[..., bc + 2: 2 * bc + 2], cfg)
    parts1 = ([masks1] if cfg.input_mask else []) + [frames1, unstable[..., 0:1]]
    parts2 = ([masks2] if cfg.input_mask else []) + [frames2, unstable[..., 1:2]]
    matches1, mask1 = warp_points(raw["matches1"], raw["mask1"].bool(), p, cfg)
    matches2, mask2 = warp_points(raw["matches2"], raw["mask2"].bool(), p, cfg)
    out = {
        "x1": torch.cat(parts1, dim=-1), "y1": stable[..., 0:1],
        "x2": torch.cat(parts2, dim=-1), "y2": stable[..., bc + 1: bc + 2],
        "matches1": matches1, "mask1": mask1.float(),
        "matches2": matches2, "mask2": mask2.float(),
    }
    if "flow" in raw:
        out["flow"] = warp_flow(raw["flow"], p, cfg)
    return out


def augment_example(generator: torch.Generator, raw: Dict[str, torch.Tensor],
                    cfg: StabNetConfig) -> Dict[str, torch.Tensor]:
    """`augment_batch` of one example (raw arrays without the batch axis)."""
    out = augment_batch(generator, {k: v[None] for k, v in raw.items()}, cfg)
    return {k: v[0] for k, v in out.items()}
