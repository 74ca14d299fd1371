"""Train state and optimizer (reference: train_bundle_nobm.py:155-160).

The JAX package keeps an immutable `TrainState` of step, parameters, batch
statistics and optax state.  Here the model holds its parameters and BN
statistics, the optimizer holds its moments, and a step updates both in
place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.models.stabnet import make_model
from stabnet_tpu_torch.utils import resolve_device


def learning_rate(step: int, cfg: StabNetConfig) -> float:
    """Staircase exponential decay lr0 * decay^floor(step / step_size), in
    float32 like optax's `exponential_decay(staircase=True)`
    (reference: train_bundle_nobm.py:156-158).  The update that takes the
    model from `step` to `step + 1` uses `learning_rate(step)`."""
    p = np.float32(math.floor(step / cfg.step_size))
    return float(np.float32(cfg.initial_learning_rate)
                 * np.float32(cfg.lr_decay_rate) ** p)


class Adam:
    """Adam with optax's formula and rounding order (`optax.adam`):

        mu <- (1 - b1) g + b1 mu,     nu <- (1 - b2) g^2 + b2 nu,
        p  <- p + (-lr) * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    with t the update count and the bias corrections in float32.  torch's
    `optim.Adam` is the same function, rounded in another order.  The
    reference uses b1 0.9, b2 0.999, eps 1e-8 (train_bundle_nobm.py:159).
    """

    def __init__(self, params: List[nn.Parameter], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        """Apply one update from the parameters' `.grad` (None counts as 0)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        self.count += 1
        c1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(self.count))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - self.b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, g2)
        den = torch._foreach_div(self.nu, c2)
        if den and den[0].device.type == "cpu":
            # torch's CPU sqrt is not correctly rounded (CUDA's and XLA's
            # are); through float64 it is.
            den = [d.double().sqrt_().float() for d in den]
        else:
            torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
                dst.copy_(src)


@dataclasses.dataclass
class TrainState:
    """The step counter (updates applied so far), the model and its
    optimizer.  A train step mutates the model and optimizer in place."""

    step: int
    model: nn.Module
    opt: Adam


def create_train_state(cfg: StabNetConfig, device=None, seed: int = 0) -> TrainState:
    """A fresh TrainState on `device` (CUDA unless the CPU is asked for):
    `cfg`'s regressor with Flax-style weights drawn from a generator seeded
    `seed`, in training mode, and a zeroed Adam."""
    model =make_model(cfg, torch.Generator().manual_seed(seed))
    model = model.to(resolve_device(device)).train()
    return TrainState(step=0, model=model, opt=Adam(model.parameters()))
