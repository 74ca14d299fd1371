"""Random weights of the configuration's model, made on the device from a seed.

Flax's default initialisation, which the program's model also uses: conv and
dense kernels truncated normal on [-2, 2] scaled to std sqrt(1/fan_in) / .8796,
the final `head.out` kernel uniform on +-sqrt(3/fan_in), biases 0, BatchNorm's
scale 1, offset 0, mean 0, variance 1.  Two calls on a `torch.Generator` of
the device: one truncated normal over every kernel at once, one uniform.  The
head's output layer is then scaled by the configuration's
`theta_head_scale`, so that random warps have the size a trained stabilizer's
have.  The same dict is loaded into the program and handed to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmarks.reference.model import param_spec
from benchmarks.traffic.video import sub_seed

LECUN_STD = 0.87962566103423978


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = param_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    lecun = [(n, s) for n, s, k in spec if k == "lecun"]
    flat = torch.empty(sum(math.prod(s) for _, s in lecun), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape in lecun:
        n = math.prod(shape)
        fan_in = n // shape[0]
        out[name] = flat[at: at + n].view(shape) * (math.sqrt(1.0 / fan_in) / LECUN_STD)
        at += n
    scale = float(cfg.get("theta_head_scale", 1.0))
    for name, shape, kind in spec:
        if kind == "head":
            limit = math.sqrt(3.0 / shape[1])
            w = torch.empty(shape, device=device).uniform_(-limit, limit, generator=gen)
            out[name] = w * scale
        elif kind in ("zero", "one"):
            out[name] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
    return {name: out[name] for name, _, _ in spec}
