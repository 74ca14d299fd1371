"""Plain float32 StabNet regressor: TF-slim's resnet_v2_50 over the input
stack and the theta head (reference: s_net_bundle_nobm.py:250-259,
configs/v2_93.py), written as functions of a dict of weights.

The weights are keyed by the names under which the program's model holds
them, so one dict, made by the benchmark from the seed, feeds both sides.
Nothing here imports the program.  A float32 matrix product on the card may
run in TF32 unless it is switched off, so `plain_precision()` switches it off
for the reference.

`quant`, where given, is applied to the input and the weights of every
convolution and dense layer of the trunk and the MLP (not `head.out`, which
the configuration keeps in float32), and to every activation the trunk
holds: the control's lower precision, where the program holds them in
bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
STAGES = ((3, 256, 64, 2), (4, 512, 128, 2), (6, 1024, 256, 2), (3, 2048, 512, 1))
MLP = (2048, 1024, 512)

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def plain_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def in_channels(cfg: dict) -> int:
    before = sum(1 for i in cfg["indices"] if i > 0)
    return before + 1 + (before if cfg["input_mask"] else 0)


def theta_dim(cfg: dict) -> int:
    return (cfg["grid_h"] + 1) * (cfg["grid_w"] + 1) * 2


def units(cfg: dict) -> List[Tuple[str, int, int, int, int]]:
    """(name, depth_in, depth, bottleneck depth, stride) of each unit; the
    stride sits on the last unit of a block (slim's convention)."""
    out, depth_in = [], 64
    for b, (n, depth, bottleneck, stride) in enumerate(STAGES):
        for u in range(n):
            out.append((f"block{b + 1}_unit{u + 1}", depth_in, depth, bottleneck,
                        stride if u == n - 1 else 1))
            depth_in = depth
    return out


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every weight and statistic: init "lecun"
    (truncated normal, std sqrt(1/fan_in)/.8796), "head" (uniform,
    sqrt(3/fan_in)), "zero" or "one": Flax's default initialisation."""
    spec = []

    def conv(name, cin, cout, k, bias):
        spec.append((f"{name}.weight", (cout, cin, k, k), "lecun"))
        if bias:
            spec.append((f"{name}.bias", (cout,), "zero"))

    def bn(name, c):
        spec.extend([(f"{name}.weight", (c,), "one"), (f"{name}.bias", (c,), "zero"),
                     (f"{name}.running_mean", (c,), "zero"),
                     (f"{name}.running_var", (c,), "one")])

    r = "resnet_v2_50"
    conv(f"{r}.conv1.conv", in_channels(cfg), 64, 7, True)
    for name, din, d, dbn, _ in units(cfg):
        p = f"{r}.{name}"
        bn(f"{p}.preact_bn", din)
        if din != d:
            conv(f"{p}.shortcut_conv", din, d, 1, True)
        conv(f"{p}.conv1", din, dbn, 1, False)
        bn(f"{p}.bn1", dbn)
        conv(f"{p}.conv2.conv", dbn, dbn, 3, False)
        bn(f"{p}.bn2", dbn)
        conv(f"{p}.conv3", dbn, d, 1, True)
    bn(f"{r}.postnorm", 2048)
    widths = (2048,) + MLP
    for i in range(3):
        spec.append((f"head.fc{i + 1}.weight", (widths[i + 1], widths[i]), "lecun"))
        spec.append((f"head.fc{i + 1}.bias", (widths[i + 1],), "zero"))
    spec.append(("head.out.weight", (theta_dim(cfg), MLP[-1]), "head"))
    spec.append(("head.out.bias", (theta_dim(cfg),), "zero"))
    return spec


def _q(t: torch.Tensor, quant: Quant) -> torch.Tensor:
    return t if quant is None else quant(t)


def conv(W: Dict[str, torch.Tensor], name: str, x: torch.Tensor, stride: int,
         quant: Quant) -> torch.Tensor:
    w = W[f"{name}.weight"]
    k = w.shape[-1]
    return F.conv2d(_q(x, quant), _q(w, quant), W.get(f"{name}.bias"), stride, (k - 1) // 2)


def bn(W, name: str, x: torch.Tensor) -> torch.Tensor:
    """Eval mode: the running statistics."""
    mean = W[f"{name}.running_mean"][None, :, None, None]
    var = W[f"{name}.running_var"][None, :, None, None]
    scale = W[f"{name}.weight"][None, :, None, None] * torch.rsqrt(var + BN_EPS)
    return (x - mean) * scale + W[f"{name}.bias"][None, :, None, None]


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """TF "SAME" max pool: out = ceil(n / s), the padding's larger half last."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=-math.inf), k, s)


def trunk(W, x: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """(B, C, H, W) -> (B, 2048, H/32, W/32).  With `quant`, every
    activation the trunk holds (each convolution's and BatchNorm's output
    and each residual sum) is rounded by it too, as a trunk computed in a
    lower precision holds them."""
    r = "resnet_v2_50"

    def q(t):
        return _q(t, quant)

    def cv(name, t, stride):
        return q(conv(W, name, t, stride, quant))

    def norm(name, t):
        return q(bn(W, name, t))

    h = max_pool_same(cv(f"{r}.conv1.conv", x, 2))
    for name, din, d, _, stride in units(cfg):
        p = f"{r}.{name}"
        pre = F.relu(norm(f"{p}.preact_bn", h))
        if din == d:
            short = h if stride == 1 else h[:, :, ::stride, ::stride]
        else:
            short = cv(f"{p}.shortcut_conv", pre, stride)
        res = F.relu(norm(f"{p}.bn1", cv(f"{p}.conv1", pre, 1)))
        res = F.relu(norm(f"{p}.bn2", cv(f"{p}.conv2.conv", res, stride)))
        h = q(short + cv(f"{p}.conv3", res, 1))
    return F.relu(norm(f"{r}.postnorm", h))


def regressor(W, x: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """(B, H, W, C_in) input stack -> (B, theta_dim) mesh-vertex offsets."""
    feats = trunk(W, x.permute(0, 3, 1, 2).float(), cfg, quant)
    h = feats.mean(dim=(2, 3))
    for i in range(3):
        name = f"head.fc{i + 1}"
        h = F.relu(F.linear(_q(h, quant), _q(W[f"{name}.weight"], quant), W[f"{name}.bias"]))
    return F.linear(h, W["head.out.weight"], W["head.out.bias"])


def _to_fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """`t` rounded to a float8 format with one scale per tensor (its largest
    magnitude at the format's largest finite value `top`), back in float32;
    the clamp keeps a quotient that rounds past `top` from becoming NaN."""
    s = t.abs().amax().float().clamp_min(1e-30) / top
    return (t / s).clamp(-top, top).to(dtype).to(t.dtype) * s


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` computed in float8: rounded to e4m3, one scale per tensor."""
    return _to_fp8(t, torch.float8_e4m3fn, 448.0)
