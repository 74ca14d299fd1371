"""StabNet loss library (PyTorch port of stabnet_tpu/losses/losses.py).

All loss terms of the reference training objective, as functions of tensors
(reference: s_net_bundle_nobm.py:139-230,301-359 and
train_bundle_nobm.py:115-126).  The gates (`use_black`, `use_temp`,
`use_theta_only`) multiply the terms; they never skip one, so every term and
every kernel under it runs at every step, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.models.resnet import Conv, Dense


def id_loss(theta: torch.Tensor) -> torch.Tensor:
    """Identity prior: mean |theta| (reference: s_net_bundle_nobm.py:262-263)."""
    return theta.abs().mean()


def black_pos_loss(pts1: torch.Tensor, do_crop_rate: float) -> torch.Tensor:
    """Mean squared hinge on mesh cell corners beyond +/- 1/do_crop_rate
    (reference: s_net_bundle_nobm.py:139-146,312-317)."""
    bound = 1.0 / do_crop_rate
    err = (pts1 - bound).clamp_min(0.0) + (-bound - pts1).clamp_min(0.0)
    return (err * err).mean()


def distortion_loss(pts1: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """Right-angle rigidity over 8 triangle orientations per mesh cell.

    pts1: (B, grid_h, grid_w, 8) in [x_tl x_tr x_bl x_br | y_tl ...] layout.
    Reference: s_net_bundle_nobm.py:148-181.
    """
    h = 2.0 / grid_h
    w = 2.0 / grid_w
    pts = pts1.reshape(-1, 2, 4)               # (B*cells, xy, corner)
    p = [pts[:, :, k] for k in range(4)]       # each (N, 2) = (x, y)

    def rotate(v, k, clock):
        # R @ v for R = [[0, -k], [k, 0]] (ccw) or [[0, k], [-k, 0]] (cw).
        x, y = v[:, 0], v[:, 1]
        if not clock:
            return torch.stack([-k * y, k * x], dim=1)
        return torch.stack([k * y, -k * x], dim=1)

    def term(p0, p1, p2, clock, hw):
        k = (h / w) if hw == 0 else (w / h)
        d = (rotate(p1 - p0, k, clock) - (p2 - p1)).abs()
        return d * d

    loss = (
        term(p[0], p[1], p[3], 0, 0)
        + term(p[1], p[3], p[2], 0, 1)
        + term(p[3], p[2], p[0], 0, 0)
        + term(p[2], p[0], p[1], 0, 1)
        + term(p[1], p[0], p[2], 1, 0)
        + term(p[0], p[2], p[3], 1, 1)
        + term(p[2], p[3], p[1], 1, 0)
        + term(p[3], p[1], p[0], 1, 1)
    )
    return loss.mean() / 8.0


def consistency_loss(mesh: torch.Tensor) -> torch.Tensor:
    """Second-difference mesh smoothness (reference: s_net_bundle_nobm.py:183-210).

    mesh: (B, grid_h+1, grid_w+1, 2).  The reference enumerates each interior
    vertex triple twice (forward and backward); both difference stacks are
    concatenated twice to keep that weighting.
    """
    dv = 2.0 * mesh[:, 1:-1] - mesh[:, 2:] - mesh[:, :-2]
    dh = 2.0 * mesh[:, :, 1:-1] - mesh[:, :, 2:] - mesh[:, :, :-2]
    flat = torch.cat([e.abs().reshape(e.shape[0], -1) for e in (dv, dv, dh, dh)],
                     dim=1)
    return (flat * flat).mean()


def warp_pts(pts: torch.Tensor, x_map: torch.Tensor,
             y_map: torch.Tensor) -> torch.Tensor:
    """Gather the dense sampling maps at (rounded) match coordinates.

    pts: (B, N, 2) NDC (x, y); maps (B, H, W).  Returns (B, N, 2).  The
    coordinates are clipped, rounded half to even and read by a flat gather
    (reference: s_net_bundle_nobm.py:215-230).
    """
    B, H, W = x_map.shape
    x = ((pts[..., 0] + 1.0) / 2.0 * W).clamp(0, W - 1).round().long()
    y = ((pts[..., 1] + 1.0) / 2.0 * H).clamp(0, H - 1).round().long()
    idx = x + y * W                                       # (B, N)
    flow = torch.stack([x_map, y_map], dim=-1).reshape(B, H * W, 2)
    return torch.gather(flow, 1, idx[..., None].expand(-1, -1, 2))


def feature_loss(matches: torch.Tensor, match_mask: torch.Tensor,
                 x_map: torch.Tensor, y_map: torch.Tensor) -> torch.Tensor:
    """Feature-match reprojection loss: the map read at each stable point
    should give back the matched unstable point.  Masked mean over matches,
    mean over the batch.  matches (B, N, 4) rows [xs, ys, xu, yu]; mask
    (B, N).  Reference: s_net_bundle_nobm.py:335-343."""
    warped = warp_pts(matches[..., :2], x_map, y_map)
    per_match = (warped - matches[..., 2:]).abs().sum(dim=2)      # (B, N)
    m = match_mask.to(per_match.dtype)
    per_ex = (per_match * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return per_ex.mean()


def masked_mse(err: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Sum of squared masked error normalized per sample by the kept area.
    err, keep: (B, H, W, 1).  Reference: s_net_bundle_nobm.py:347-352."""
    e = err * keep
    num = (e * e).sum(dim=(1, 2, 3))
    den = keep.sum(dim=(1, 2, 3)) + 1e-8
    return (num / den).mean()


def img_loss(output: torch.Tensor, y: torch.Tensor,
             black_pix: torch.Tensor) -> torch.Tensor:
    """Pixel alignment to the ground-truth stable frame, black pixels out."""
    return masked_mse(output - y, (1.0 - black_pix)[..., None])


def temporal_loss(out1: torch.Tensor, black1: torch.Tensor,
                  out2_warped: torch.Tensor,
                  noblack2_warped: torch.Tensor) -> torch.Tensor:
    """Temporal consistency between adjacent outputs after flow warping
    (reference: train_bundle_nobm.py:115-126)."""
    keep = (1.0 - black1)[..., None] * noblack2_warped
    return masked_mse(out1 - out2_warped, keep)


def l2_regularization(model: nn.Module, weight_decay: float,
                      head_weight_decay: float) -> torch.Tensor:
    """0.5 * the weighted sum of squares of every conv and dense kernel:
    `head.out`'s at `head_weight_decay`, the rest at `weight_decay`; biases
    and BatchNorm parameters are not regularized (reference: resnet.py:23-41,
    s_net_bundle_nobm.py:324-325).  Layers are picked by module type, since
    BatchNorm's scale is also named `weight`."""
    terms = []
    for name, mod in model.named_modules():
        if isinstance(mod, (Conv, Dense)):
            scale = head_weight_decay if name.endswith("head.out") else weight_decay
            terms.append(scale * mod.weight.float().square().sum())
    return torch.stack(terms).sum() * 0.5


def total_loss(terms: Dict[str, torch.Tensor], cfg: StabNetConfig,
               use_black: float, use_theta_only: float) -> torch.Tensor:
    """Combine the UNWEIGHTED terms with their weights and gates
    (reference: s_net_bundle_nobm.py:357-359)."""
    theta_term = terms["id"] * cfg.id_mul * cfg.theta_mul
    grid_theta_term = terms["id"] * cfg.id_mul * cfg.grid_theta_mul
    gated = (
        terms["img"] * cfg.img_mul
        + terms["regu"] * cfg.regu_mul
        + terms["black"] * cfg.black_mul * use_black
        + terms["distortion"] * cfg.distortion_mul
        + terms["consistency"] * cfg.consistency_mul
        + terms["feature"] * cfg.feature_mul
    )
    return theta_term + grid_theta_term + (1.0 - use_theta_only) * gated
