"""Siamese training step, the loss-gate schedule, and the compiled steps.

PyTorch port of stabnet_tpu/train/train.py.  What it reproduces:

  * Siamese over two adjacent time steps with shared weights
    (train_bundle_nobm.py:107-108): ONE forward over the concatenated pair
    batch, split at B, so BatchNorm sees both halves as one batch.
  * The temporal loss between output 1 and output 2 warped by the flow
    (train_bundle_nobm.py:115-126): output 2 and its validity stacked into
    one 2-channel image and sampled once, through K5 on CUDA.
  * The loss-gate schedule per step (train_bundle_nobm.py:219-236): the
    gates multiply the terms and never skip one, so every kernel launches
    at every step.  As in the JAX package they are computed from the step
    counter on the device, and so are the learning rate and Adam's bias
    corrections (train/state.py), so one compiled step serves every phase.
  * Adam with the staircase decay (train_bundle_nobm.py:155-160), and the BN
    statistics updated by the step's one forward.
  * The compiled steps (`make_train_step`, `make_eval_step`: the JAX
    package's `jax.jit` of the step with the state donated): on CUDA, one
    captured CUDA graph per batch signature (utils/graphs.py), replayed bit
    for bit as the eager `train_step` / `eval_step`, which stay the
    reference and the CPU's path.
  * Data parallelism (the JAX package's step over a mesh): in a process
    group, BatchNorm takes the global batch's statistics, the gradients are
    averaged over the ranks before Adam, and the loss terms returned are
    the global batch's (parallel/multihost.py).  Without one, nothing of
    that runs.  An NCCL rank's compiled steps are graphs too, each with its
    collectives inside (BatchNorm's sums, the gradient all-reduce, the mean
    of the loss terms), as the JAX package's jit over the mesh holds its
    all-reduces; a gloo rank's steps run eagerly, since gloo's all-reduce
    of CUDA tensors goes through the host and cannot be captured.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch

from stabnet_tpu_torch import losses
from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.models.stabnet import StabNetOutput, forward_train
from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.parallel.multihost import (average_gradients, group_backend,
                                                  mean_over_ranks)
from stabnet_tpu_torch.train.state import TrainState, learning_rate

Batch = Dict[str, torch.Tensor]
Gate = Union[float, torch.Tensor]

# The loss terms a step returns, in the order a compiled step stacks them.
TERMS = ("id", "black", "distortion", "consistency", "feature", "img", "regu")
AUX_KEYS = tuple(f"{k}{i}" for i in (1, 2) for k in TERMS) + ("temp", "total")


def loss_gates(step: Union[int, torch.Tensor], cfg: StabNetConfig) -> Dict[str, Gate]:
    """Phase-in gates of `step` (reference: train_bundle_nobm.py:219-236):
    Python floats for a host int; for a 0-d integer tensor, 0-d float32
    tensors on its device, computed with `torch.where` as the JAX package's
    `loss_gates` computes them (stabnet_tpu/train/train.py:41-57).  Each
    gate is 0, 1 or 10, so a product with one is exact either way.

    `use_theta` mirrors a dead reference placeholder (the multiplier is
    commented out in the reference loss, s_net_bundle_nobm.py:310); kept to
    document the schedule, consumed by nothing."""
    if isinstance(step, torch.Tensor):
        def f(v):
            return torch.full((), v, dtype=torch.float32, device=step.device)

        one, zero = f(1.0), f(0.0)
        use_theta = torch.where(step > cfg.no_theta_iter, zero, one)
        return {
            "use_theta": torch.where(step <= cfg.do_theta_10_iter, f(10.0), use_theta),
            "use_temp": torch.where(step >= cfg.do_temp_loss_iter, one, zero),
            "use_black": torch.where(step >= cfg.do_black_loss_iter, one, zero),
            "use_theta_only": torch.where(step <= cfg.do_theta_only_iter, one, zero),
        }
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
                   gates: Dict[str, Gate]
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
                   gates: Dict[str, Gate]
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


def _train_body(state: TrainState, batch: Batch, cfg: StabNetConfig) -> Batch:
    """The device work of one optimizer step, with the model in training
    mode: the gradients set to None (so a capture allocates them from its
    graph's pool), forward (updating the BN statistics), backward, Adam at
    the learning rate of the step before the update, and the device
    counters advanced in place.  Gates, learning rate and bias corrections
    come from `state.step_t`, so the body reads no host counter and
    advances none: a capture runs this Python again without executing it."""
    model = state.model
    gates = loss_gates(state.step_t, cfg)
    for p in model.parameters():
        p.grad = None
    total, aux = compute_losses(model, batch, cfg, gates)
    total.backward()
    average_gradients(state.opt.params)
    state.opt.update(learning_rate(state.step_t, cfg))
    state.step_t.add_(1)
    return {k: v.detach() for k, v in aux.items()}


def train_step(state: TrainState, batch: Batch, cfg: StabNetConfig
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step, eagerly and in place (`_train_body`), then the
    host counters mirrored.  Returns the state with `step + 1` and the
    detached loss terms (on the device; reading them waits for it)."""
    state.model.train()
    aux = _train_body(state, batch, cfg)
    state.advance()
    return state, mean_over_ranks(aux)


@torch.no_grad()
def _eval_body(state: TrainState, batch: Batch, cfg: StabNetConfig) -> Batch:
    model = state.model.eval()
    try:
        _, aux = compute_losses(model, batch, cfg, loss_gates(state.step_t, cfg))
    finally:
        model.train()
    return aux


def eval_step(state: TrainState, batch: Batch, cfg: StabNetConfig
              ) -> Dict[str, torch.Tensor]:
    """Held-out loss with frozen statistics (eval-mode BN, no gradients);
    the reference evaluates with the training graph, the JAX package and
    this port with the deployed branch (train_bundle_nobm.py:273-315)."""
    return mean_over_ranks(_eval_body(state, batch, cfg))


def _compiled(state: TrainState) -> bool:
    """Whether `state`'s compiled steps replay graphs: on CUDA, alone or as
    a rank of an NCCL group (a capture holds NCCL's collectives); eager on
    the CPU and under gloo, whose all-reduce of CUDA tensors goes through
    the host."""
    return state.device.type == "cuda" and group_backend() in (None, "nccl")


def _replay(state: TrainState, key: tuple, body, batch: Batch,
            cfg: StabNetConfig) -> Dict[str, torch.Tensor]:
    """`body(state, batch, cfg)`'s loss terms averaged over the ranks (the
    global batch's, as the eager steps return them) through the state's
    graph of `key` and the batch's signature; copied out of the graph's
    buffer."""
    names = tuple(sorted(batch))

    def fn(*tensors):
        aux = mean_over_ranks(body(state, dict(zip(names, tensors)), cfg))
        assert set(aux) == set(AUX_KEYS), sorted(aux)
        return (torch.stack([aux[k].float() for k in AUX_KEYS]),)

    with state.graphs.lock:
        (stacked,) = state.graphs(key + (cfg, names), fn, [batch[k] for k in names],
                                  state.device)
        values = stacked.clone()
    return dict(zip(AUX_KEYS, values.unbind()))


def make_train_step(cfg: StabNetConfig) -> Callable[[TrainState, Batch],
                                                     Tuple[TrainState, Batch]]:
    """The compiled train step (the JAX package's `make_train_step`):
    `step(state, batch) -> (state, loss terms)`, `train_step`'s result.

    On a CUDA state, alone or as an NCCL rank, it replays the state's
    captured CUDA graph of the whole step for the batch's shapes and dtypes
    (captured at the first such call, which runs eagerly and is that call's
    step), then mirrors the host counters; the loss terms are copied out of
    the graph, whose next replay overwrites them.  An NCCL rank's graph
    holds the step's collectives, so every rank must reach each batch
    signature at the same step.  A failed capture or replay raises.  On the
    CPU, and under gloo, it is `train_step`."""
    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Batch]:
        if not _compiled(state):
            return train_step(state, batch, cfg)
        state.model.train()
        with torch.enable_grad():
            aux = _replay(state, ("train_step",), _train_body, batch, cfg)
        state.advance()
        return state, aux

    return step


def make_eval_step(cfg: StabNetConfig) -> Callable[[TrainState, Batch], Batch]:
    """The compiled eval step (the JAX package's `make_eval_step`):
    `step(state, batch) -> loss terms`, `eval_step`'s result; a graph per
    batch signature on a CUDA state, alone or as an NCCL rank, as
    `make_train_step`."""
    def step(state: TrainState, batch: Batch) -> Batch:
        if not _compiled(state):
            return eval_step(state, batch, cfg)
        return _replay(state, ("eval_step",), _eval_body, batch, cfg)

    return step
