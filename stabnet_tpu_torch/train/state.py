"""Train state and optimizer (reference: train_bundle_nobm.py:155-160).

The JAX package keeps an immutable `TrainState` of step, parameters, batch
statistics and optax state, and its jitted step computes the learning rate
and Adam's bias corrections from the step and update counters on the
device.  Here the model holds its parameters and BN statistics, the
optimizer holds its moments, and a step updates both in place.  Each
counter is a pair: a host int, which the loop, the logs and the
checkpoints read, and a 0-d int64 tensor on the model's device, which the
step reads and increments in place, so one captured CUDA graph of the step
serves every learning rate (train/train.py).  Setting `TrainState.step` or
`Adam.count` moves both halves of its pair.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch
from torch import nn

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.models.stabnet import make_model
from stabnet_tpu_torch.utils import resolve_device
from stabnet_tpu_torch.utils.graphs import GraphCache


def power_f32(base: float, exponent: Union[int, float, torch.Tensor]
              ) -> Union[float, torch.Tensor]:
    """float32(base) ** exponent, correctly rounded to float32: the float64
    power rounded once.  A host number for a number, a 0-d float32 tensor
    on its device for a tensor.  Neither numpy's float32 power nor torch's
    (CPU or CUDA `powf`) is correctly rounded: numpy's is off by one ulp at
    177 of the first 200,000 powers of 0.9, which moved Adam's bias
    correction off optax's at count 4 (tests/test_torch_train_graph.py)."""
    b = float(np.float32(base))
    if isinstance(exponent, torch.Tensor):
        return torch.pow(torch.full((), b, dtype=torch.float64, device=exponent.device),
                         exponent.double()).float()
    return float(np.float32(np.float64(b) ** np.float64(exponent)))


def learning_rate(step: Union[int, torch.Tensor], cfg: StabNetConfig
                  ) -> Union[float, torch.Tensor]:
    """Staircase exponential decay lr0 * decay^floor(step / step_size), in
    float32 in optax's order (`exponential_decay(staircase=True)`;
    reference: train_bundle_nobm.py:156-158).  The update that takes the
    model from `step` to `step + 1` uses `learning_rate(step)`.  `step` a
    host int gives a float; a 0-d device tensor, a 0-d float32 tensor there
    (the step counter of a captured step), the same value."""
    lr0 = np.float32(cfg.initial_learning_rate)
    if isinstance(step, torch.Tensor):
        size = torch.full((), float(cfg.step_size), dtype=torch.float32, device=step.device)
        p = torch.floor(step.float() / size)
        return power_f32(cfg.lr_decay_rate, p) * float(lr0)
    p = np.floor(np.float32(step) / np.float32(cfg.step_size))
    return float(lr0 * np.float32(power_f32(cfg.lr_decay_rate, p)))


class Adam:
    """Adam with optax's formula and rounding order (`optax.adam`):

        mu <- (1 - b1) g + b1 mu,     nu <- (1 - b2) g^2 + b2 nu,
        p  <- p + (-lr) * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    with t the update count and the bias corrections in float32, computed
    on the device from the device count `count_t`.  torch's `optim.Adam` is
    the same function, rounded in another order.  The reference uses b1
    0.9, b2 0.999, eps 1e-8 (train_bundle_nobm.py:159).
    """

    def __init__(self, params: List[nn.Parameter], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count_t = torch.zeros((), dtype=torch.int64, device=self.params[0].device)
        self._count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @property
    def count(self) -> int:
        """Updates applied so far (the host half of the pair)."""
        return self._count

    @count.setter
    def count(self, value: int) -> None:
        self._count = int(value)
        self.count_t.fill_(self._count)

    @torch.no_grad()
    def update(self, lr: Union[float, torch.Tensor]) -> None:
        """Apply one update from the parameters' `.grad` (None counts as 0)
        at `lr` (a float or a 0-d float32 tensor on the device), advancing
        the device count in place and not the host one: the device work of
        `step`, which a captured CUDA graph can hold."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        self.count_t.add_(1)
        c1 = 1.0 - power_f32(self.b1, self.count_t)
        c2 = 1.0 - power_f32(self.b2, self.count_t)
        if not isinstance(lr, torch.Tensor):
            lr = torch.full((), lr, dtype=torch.float32, device=self.count_t.device)
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
        torch._foreach_mul_(upd, torch.neg(lr))
        torch._foreach_add_(self.params, upd)

    def step(self, lr: Union[float, torch.Tensor]) -> None:
        """`update(lr)` and the host count with it."""
        self.update(lr)
        self.advance()

    def advance(self) -> None:
        """Mirror on the host one update the device count has taken (after a
        replayed graph of `update`)."""
        self._count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        """Copy `state` in: the moments in place (a captured step keeps
        reading the same tensors), the count through its setter."""
        self.count = int(state["count"])
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
                dst.copy_(src)


class TrainState:
    """The step counter (updates applied so far), the model and its
    optimizer.  A train step mutates the model and optimizer in place.

    `step` is the host half of the step pair and `step_t` the device half
    (a 0-d int64 tensor on the model's device); assigning `step` sets both.
    `graphs` holds the captured CUDA graphs of the state's train and eval
    steps (train/train.py): they bake in the addresses of the model's and
    Adam's tensors, so they belong to the state, with a memory pool of
    their own.  Restores therefore copy in place (`checkpoint.restore`)."""

    def __init__(self, step: int, model: nn.Module, opt: Adam):
        self.model, self.opt = model, opt
        self.step_t = torch.zeros((), dtype=torch.int64, device=opt.count_t.device)
        self.step = step
        self.graphs = GraphCache(shared_pool=True)

    @property
    def step(self) -> int:
        return self._step

    @step.setter
    def step(self, value: int) -> None:
        self._step = int(value)
        self.step_t.fill_(self._step)

    @property
    def device(self) -> torch.device:
        return self.step_t.device

    def advance(self) -> None:
        """Mirror on the host one step the device counters have taken."""
        self._step += 1
        self.opt.advance()


def create_train_state(cfg: StabNetConfig, device=None, seed: int = 0) -> TrainState:
    """A fresh TrainState on `device` (CUDA unless the CPU is asked for):
    `cfg`'s regressor with Flax-style weights drawn from a generator seeded
    `seed`, in training mode, and a zeroed Adam."""
    model = make_model(cfg, torch.Generator().manual_seed(seed))
    model = model.to(resolve_device(device)).train()
    return TrainState(step=0, model=model, opt=Adam(model.parameters()))
