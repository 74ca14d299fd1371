"""Siamese training step and the loss-gate schedule.

PyTorch port of stabnet_tpu/train/train.py.  What it reproduces:

  * Siamese over two adjacent time steps with shared weights
    (train_bundle_nobm.py:107-108): ONE forward over the concatenated pair
    batch, split at B, so BatchNorm sees both halves as one batch.
  * The temporal loss between output 1 and output 2 warped by the flow
    (train_bundle_nobm.py:115-126): output 2 and its validity stacked into
    one 2-channel image and sampled once, through K5 on CUDA.
  * The loss-gate schedule per step (train_bundle_nobm.py:219-236): the
    gates multiply the terms and never skip one, so every kernel launches
    at every step.
  * Adam with the staircase decay (train_bundle_nobm.py:155-160), and the BN
    statistics updated by the step's one forward.
  * Data parallelism (the JAX package's step over a mesh): in a process
    group, BatchNorm takes the global batch's statistics, the gradients are
    averaged over the ranks before Adam, and the loss terms returned are
    the global batch's (parallel/multihost.py).  Without one, nothing of
    that runs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from stabnet_tpu_torch import losses
from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.models.stabnet import StabNetOutput, forward_train
from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.parallel.multihost import average_gradients, mean_over_ranks
from stabnet_tpu_torch.train.state import TrainState, learning_rate

Batch = Dict[str, torch.Tensor]


def loss_gates(step: int, cfg: StabNetConfig) -> Dict[str, float]:
    """Phase-in gates of `step` (reference: train_bundle_nobm.py:219-236).

    `use_theta` mirrors a dead reference placeholder (the multiplier is
    commented out in the reference loss, s_net_bundle_nobm.py:310); kept to
    document the schedule, consumed by nothing."""
    use_theta = 0.0 if step > cfg.no_theta_iter else 1.0
    if step <= cfg.do_theta_10_iter:
        use_theta = 10.0
    return {
        "use_theta": use_theta,
        "use_temp": 1.0 if step >= cfg.do_temp_loss_iter else 0.0,
        "use_black": 1.0 if step >= cfg.do_black_loss_iter else 0.0,
        "use_theta_only": 1.0 if step <= cfg.do_theta_only_iter else 0.0,
    }


def _branch_losses(out: StabNetOutput, y: torch.Tensor, matches: torch.Tensor,
                   mask: torch.Tensor, regu: torch.Tensor, cfg: StabNetConfig,
                   gates: Dict[str, float]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """All per-branch terms (reference: s_net_bundle_nobm.py:308-359)."""
    terms = {
        "id": losses.id_loss(out.theta),
        "black": losses.black_pos_loss(out.pts1, cfg.do_crop_rate),
        "distortion": losses.distortion_loss(out.pts1, cfg.grid_h, cfg.grid_w),
        "consistency": losses.consistency_loss(out.mesh),
        "feature": losses.feature_loss(matches, mask, out.warp.x_map,
                                       out.warp.y_map),
        "img": losses.img_loss(out.warp.output, y, out.warp.black_pix),
        "regu": regu,
    }
    total = losses.total_loss(terms, cfg, use_black=gates["use_black"],
                              use_theta_only=gates["use_theta_only"])
    return total, terms


def _split(out: StabNetOutput, B: int) -> Tuple[StabNetOutput, StabNetOutput]:
    def part(sl):
        w = out.warp
        return StabNetOutput(out.theta[sl], out.mesh[sl], out.pts1[sl],
                             type(w)(*(t[sl] for t in w)))
    return part(slice(None, B)), part(slice(B, None))


def compute_losses(model, batch: Batch, cfg: StabNetConfig,
                   gates: Dict[str, float]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full Siamese loss of `batch`: (total, aux terms).

    BatchNorm follows the model's mode (train: batch statistics, running
    statistics updated in place; eval: running statistics).  The JAX
    package's `compute_losses` (stabnet_tpu/train/train.py:80-140)."""
    B = batch["x1"].shape[0]
    out = forward_train(model, torch.cat([batch["x1"], batch["x2"]]), cfg)
    out1, out2 = _split(out, B)

    regu = losses.l2_regularization(model, cfg.weight_decay,
                                    cfg.head_weight_decay)
    t1, terms1 = _branch_losses(out1, batch["y1"], batch["matches1"],
                                batch["mask1"], regu, cfg, gates)
    t2, terms2 = _branch_losses(out2, batch["y2"], batch["matches2"],
                                batch["mask2"], regu, cfg, gates)

    # Gradients flow into the warped image (the sibling's output); the flow
    # is data: K5 on CUDA, the plain sampler under autograd on the CPU.
    flow = batch["flow"]
    noblack2 = (1.0 - out2.warp.black_pix)[..., None]
    stacked = torch.cat([out2.warp.output, noblack2], dim=-1)
    warped = cuda_warp.bilinear_sample_const_maps(stacked, flow[..., 0],
                                                  flow[..., 1])
    temp = losses.temporal_loss(out1.warp.output, out1.warp.black_pix,
                                warped[..., 0:1], warped[..., 1:2])
    temp = temp * gates["use_temp"]

    total = t1 + t2 + temp * cfg.temp_mul
    aux = {f"{k}1": v for k, v in terms1.items()}
    aux.update({f"{k}2": v for k, v in terms2.items()})
    aux["temp"] = temp * cfg.temp_mul
    aux["total"] = total
    return total, aux


def train_step(state: TrainState, batch: Batch, cfg: StabNetConfig
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step, in place: the forward updates the BN statistics,
    the backward gives the gradients, Adam applies them at the learning rate
    of the step before the update.  Returns the state with `step + 1` and
    the detached loss terms (on the device; reading them waits for it)."""
    model = state.model.train()
    gates = loss_gates(state.step, cfg)
    for p in model.parameters():
        p.grad = None
    total, aux = compute_losses(model, batch, cfg, gates)
    total.backward()
    average_gradients(state.opt.params)
    state.opt.step(learning_rate(state.step, cfg))
    state.step += 1
    return state, mean_over_ranks({k: v.detach() for k, v in aux.items()})


@torch.no_grad()
def eval_step(state: TrainState, batch: Batch, cfg: StabNetConfig
              ) -> Dict[str, torch.Tensor]:
    """Held-out loss with frozen statistics (eval-mode BN, no gradients);
    the reference evaluates with the training graph, the JAX package and
    this port with the deployed branch (train_bundle_nobm.py:273-315)."""
    model = state.model.eval()
    try:
        _, aux = compute_losses(model, batch, cfg, loss_gates(state.step, cfg))
    finally:
        model.train()
    return mean_over_ranks(aux)
