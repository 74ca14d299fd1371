"""StabNet model: input stack -> theta -> mesh -> warped frame.

Functional equivalent of the reference `inference_stable_net` forward path
(s_net_bundle_nobm.py:266-307); the JAX package's models/stabnet.py.
`forward` serves (inference mode); `forward_train` carries gradients.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.models.resnet import StabNetRegressor, init_weights
from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.ops.homography import mesh_to_homographies
from stabnet_tpu_torch.ops.mesh import cell_pts, theta_to_mesh
from stabnet_tpu_torch.ops.warp import WarpResult, black_mask, dense_maps, transformer


class StabNetOutput(NamedTuple):
    theta: torch.Tensor    # (B, theta_dim) raw vertex offsets
    mesh: torch.Tensor     # (B, gh+1, gw+1, 2) clamped mesh ("pts2")
    pts1: torch.Tensor     # (B, gh, gw, 8) per-cell corner bundles
    warp: WarpResult       # warped current frame + maps + black mask


def make_model(cfg: StabNetConfig,
               generator: Optional[torch.Generator] = None) -> StabNetRegressor:
    """The regressor of `cfg`, on the CPU, in eval mode, with Flax-style
    random weights drawn from `generator` (a generator seeded 0 if None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = StabNetRegressor(cfg.in_channels, cfg.theta_dim,
                             dtype=getattr(torch, cfg.compute_dtype))
    return init_weights(model, generator).eval()


def current_frame(x: torch.Tensor, cfg: StabNetConfig) -> torch.Tensor:
    """Slice the current unstable frame from the (B, H, W, C) input stack
    (reference: s_net_bundle_nobm.py:280-283)."""
    c = cfg.cur_channel
    return x[..., c: c + 1]


@torch.inference_mode()
def forward(model: StabNetRegressor, x: torch.Tensor,
            cfg: StabNetConfig) -> StabNetOutput:
    """Run the regressor and warp the current frame (inference).

    x: (B, H, W, C_in) input stack (history masks + history frames +
    current), on the model's device.
    """
    theta = model(x)
    mesh = theta_to_mesh(theta, cfg.grid_h, cfg.grid_w, cfg.do_crop_rate)
    cur = current_frame(x, cfg).to(getattr(torch, cfg.warp_dtype))
    warp = transformer(cur, mesh, cfg.grid_h, cfg.grid_w)
    return StabNetOutput(theta=theta, mesh=mesh, pts1=cell_pts(mesh), warp=warp)


def forward_train(model: StabNetRegressor, x: torch.Tensor,
                  cfg: StabNetConfig) -> StabNetOutput:
    """Run the regressor and warp the current frame, with gradients.

    The JAX package's `forward(..., train=True, pallas_warp=...)`
    (stabnet_tpu/models/stabnet.py:41-87).  BatchNorm follows the model's
    mode: in `model.train()` it normalizes with batch statistics and updates
    its running statistics in place.  The current frame is data, so the
    warp needs map gradients only: `bilinear_sample_const_image` (K2
    forward, K6b backward on CUDA; the plain sampler under autograd on CPU).
    """
    theta = model(x)
    mesh = theta_to_mesh(theta, cfg.grid_h, cfg.grid_w, cfg.do_crop_rate)
    cur = current_frame(x, cfg).to(getattr(torch, cfg.warp_dtype))
    Hs = mesh_to_homographies(mesh, cfg.grid_h, cfg.grid_w)
    x_map, y_map = dense_maps(Hs, cfg.height, cfg.width)
    warp = WarpResult(
        output=cuda_warp.bilinear_sample_const_image(cur, x_map, y_map),
        black_pix=black_mask(x_map, y_map), x_map=x_map, y_map=y_map, Hs=Hs)
    return StabNetOutput(theta=theta, mesh=mesh, pts1=cell_pts(mesh), warp=warp)


def scale_theta_head(model: StabNetRegressor, factor: float = 0.05
                     ) -> StabNetRegressor:
    """Scale the final theta layer so random-init warps have production
    magnitude (a random head emits O(1)-NDC mesh offsets, ~20x what a
    converged stabilizer produces).  Scales exactly `head.out`'s weight and
    bias, in place; returns the model."""
    out = model.head.out
    with torch.no_grad():
        out.weight.mul_(factor)
        out.bias.mul_(factor)
    return model
