"""ResNet-v2-50 backbone with a 13-channel stem, slim-layout compatible.

The reference regressor is TF-slim's `resnet_v2_50` with `global_pool=False`,
`output_stride=32` (reference: s_net_bundle_nobm.py:250-259).  The module and
parameter names follow the JAX package's Flax modules one for one, so a
converted checkpoint (`models/convert.py`) loads by name:

  * pre-activation bottleneck units (BN+ReLU before each conv); the shortcut
    conv reads the pre-activation,
  * stride placed on the LAST unit of each block (slim convention, unlike
    torchvision, which strides the first unit),
  * `conv2d_same`: a fixed (k-1)//2, k//2 pad for strided convs, "SAME" with
    stride 1 (both symmetric for the odd kernels used here),
  * stem: 7x7/2 conv with no BN/ReLU, then a 3x3/2 max-pool with TF "SAME"
    padding, which is asymmetric ((0, 1) at 144x256; nn.MaxPool2d(3, 2, 1)
    would differ),
  * the 1x1 strided "subsample" shortcut is x[..., ::s, ::s],
  * final post-activation BN+ReLU, BN epsilon 1e-5,
  * mean-pool, fc 2048/1024/512 with ReLU, and an fp32 `head.out` layer.

Public inputs are NHWC stacks as in the JAX package; inside, the trunk runs
NCHW (a permuted NHWC tensor is channels-last memory, which cuDNN prefers).
Every parameter is held in fp32 and conv and dense weights are cast to the
compute dtype at each use, as Flax does (`param_dtype=float32`): Adam's steps
at the reference learning rate are far below bf16's resolution.  BN
statistics and the final `head.out` layer stay fp32.  A serving engine casts
the conv and dense weights once instead (`cast_weights`), which gives the
same values and saves the cast at every frame.

Training mode (`model.train()`) gives BatchNorm Flax's training branch:
normalize with the biased batch variance, statistics reduced in fp32, and
running statistics updated as ra <- 0.997 ra + 0.003 batch, with the biased
variance too.  In a process group of several ranks (data parallelism) the
statistics are the global batch's, summed over the ranks.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.997          # Flax's convention: ra <- momentum * ra + ...


class BatchNorm(nn.Module):
    """Batch norm over channel dim 1 with fp32 statistics and parameters."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        if _ranks() > 1:
            return self._forward_across_ranks(x)
        # torch normalizes with the biased batch variance, as Flax does, but
        # moves running_var towards the UNBIASED one: rv' = (1-m) rv + m v n/(n-1).
        # Flax wants (1-m) rv + m v = rv' (n-1)/n + (1-m) rv / n, exactly.
        # torch's backward reads the statistics it was given, so it gets
        # copies and the buffers are written afterwards.
        n = x.numel() // x.shape[1]
        m = 1.0 - BN_MOMENTUM
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, m, BN_EPS)
        with torch.no_grad():
            self.running_mean.copy_(mean)
            self.running_var.mul_((1.0 - m) / n).add_(var * ((n - 1) / n))
        return y

    def _forward_across_ranks(self, x):
        """Training statistics of the GLOBAL batch, as the JAX package's
        SPMD step computes them (stabnet_tpu/train/train.py:185-198): the
        per-channel count, sum and sum of squares, in fp32, summed over the
        ranks by one differentiable all-reduce; Flax's biased variance
        E[x^2] - E[x]^2 and its running update."""
        xf = x.float()
        dims = [d for d in range(x.dim()) if d != 1]
        count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.float32,
                           device=x.device)
        stats = _SumOverRanks.apply(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]))
        C = x.shape[1]
        n = stats[2 * C]
        mean = stats[:C] / n
        var = torch.clamp(stats[C: 2 * C] / n - mean * mean, min=0.0)
        shape = (1, C) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean.reshape(shape)) * scale.reshape(shape) + self.bias.reshape(shape)
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1.0 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1.0 - BN_MOMENTUM) * var)
        return y.to(x.dtype)


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over the ranks; its gradient on each rank is the
    sum of the ranks' gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t):
        import torch.distributed as dist

        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g)
        return g


def _ranks() -> int:
    """The ranks of the active process group, 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Conv(nn.Module):
    """Conv with slim's padding: (k-1)//2 each side for the odd kernels here
    ("SAME" at stride 1, `conv2d_same` at stride > 1)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = True, dtype=torch.bfloat16):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"odd kernel sizes only, got {kernel}")
        self.stride = stride
        self.pad = (kernel - 1) // 2
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride,
                        self.pad)


class SlimConv(nn.Module):
    """Conv with slim's `conv2d_same` padding semantics (Flax: `SlimConv`)."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 use_bias: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.conv = Conv(cin, features, kernel, stride, use_bias, dtype)

    def forward(self, x):
        return self.conv(x)


class BottleneckV2(nn.Module):
    """Pre-activation bottleneck unit (slim resnet_v2 `bottleneck`)."""

    def __init__(self, depth_in: int, depth: int, depth_bottleneck: int,
                 stride: int, dtype=torch.bfloat16):
        super().__init__()
        self.depth_in, self.depth, self.stride = depth_in, depth, stride
        self.preact_bn = BatchNorm(depth_in)
        if depth_in != depth:
            self.shortcut_conv = Conv(depth_in, depth, 1, stride, True, dtype)
        self.conv1 = Conv(depth_in, depth_bottleneck, 1, 1, False, dtype)
        self.bn1 = BatchNorm(depth_bottleneck)
        self.conv2 = SlimConv(depth_bottleneck, depth_bottleneck, 3, stride,
                              False, dtype)
        self.bn2 = BatchNorm(depth_bottleneck)
        self.conv3 = Conv(depth_bottleneck, depth, 1, 1, True, dtype)

    def forward(self, x):
        preact = F.relu(self.preact_bn(x))
        if self.depth_in == self.depth:
            # slim `subsample`: a 1x1 max pool with stride.
            shortcut = x if self.stride == 1 else x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = self.shortcut_conv(preact)
        residual = F.relu(self.bn1(self.conv1(preact)))
        residual = F.relu(self.bn2(self.conv2(residual)))
        residual = self.conv3(residual)
        return shortcut + residual


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """TF "SAME" max pool: pad so out = ceil(n/s), pad_beg = total // 2."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):          # F.pad order: last dim first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, k, s)


class ResNetV2(nn.Module):
    """slim-style resnet_v2 trunk: (B, C, H, W) -> (B, 2048, H/32, W/32)."""

    def __init__(self, in_channels: int,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 stage_depths: Sequence[Tuple[int, int]] = (
                     (256, 64), (512, 128), (1024, 256), (2048, 512)),
                 stage_strides: Sequence[int] = (2, 2, 2, 1),
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = SlimConv(in_channels, 64, 7, 2, True, dtype)
        self.unit_names = []
        depth_in = 64
        for b, (num_units, (depth, depth_bn), block_stride) in enumerate(
                zip(stage_sizes, stage_depths, stage_strides)):
            for u in range(num_units):
                stride = block_stride if u == num_units - 1 else 1
                name = f"block{b + 1}_unit{u + 1}"
                self.add_module(name, BottleneckV2(depth_in, depth, depth_bn,
                                                   stride, dtype))
                self.unit_names.append(name)
                depth_in = depth
        self.out_features = depth_in
        self.postnorm = BatchNorm(depth_in)

    def forward(self, x):
        x = x.to(self.dtype)
        x = max_pool_same(self.conv1(x))
        for name in self.unit_names:
            x = getattr(self, name)(x)
        return F.relu(self.postnorm(x))


class Dense(nn.Module):
    """Flax `nn.Dense` layout: y = x @ W^T + b, computed in `dtype`."""

    def __init__(self, fin: int, fout: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x):
        return F.linear(x, self.weight.to(self.dtype), self.bias.to(self.dtype))


class ThetaHead(nn.Module):
    """Mean-pool + 3-layer MLP + linear mesh-offset head
    (reference: s_net_bundle_nobm.py:254-259)."""

    def __init__(self, in_features: int, theta_dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        widths = (in_features, 2048, 1024, 512)
        for i in range(3):
            self.add_module(f"fc{i + 1}", Dense(widths[i], widths[i + 1], dtype))
        # Final layer in fp32: theta magnitudes are small mesh offsets and the
        # warp path is fp32.
        self.out = Dense(512, theta_dim, torch.float32)

    def forward(self, feats):
        x = feats.float().mean(dim=(2, 3)).to(self.dtype)
        for i in range(3):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return self.out(x.float())


class StabNetRegressor(nn.Module):
    """Backbone + head: (B, H, W, C_in) NHWC input stack -> (B, theta_dim)."""

    def __init__(self, in_channels: int, theta_dim: int = 50,
                 dtype=torch.bfloat16, **trunk_kw):
        super().__init__()
        self.resnet_v2_50 = ResNetV2(in_channels, dtype=dtype, **trunk_kw)
        self.head = ThetaHead(self.resnet_v2_50.out_features, theta_dim, dtype)

    def forward(self, x):
        feats = self.resnet_v2_50(x.permute(0, 3, 1, 2))
        return self.head(feats)


def init_weights(model: nn.Module,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Flax's default initialisation, drawn from `generator`.

    Conv and dense kernels: lecun normal (truncated normal on [-2, 2] std,
    std = sqrt(1/fan_in) / .8796); `head.out`: variance scaling uniform,
    limit sqrt(3/fan_in); biases 0; BN scale 1, bias 0, mean 0, var 1.
    """
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            elif isinstance(mod, (Conv, Dense)):
                w = mod.weight
                fan_in = w[0].numel()
                tmp = torch.empty(w.shape, dtype=torch.float32)
                if name.endswith("head.out"):
                    limit = math.sqrt(3.0 / fan_in)
                    tmp.uniform_(-limit, limit, generator=generator)
                else:
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                          generator=generator)
                    tmp.mul_(std)
                w.copy_(tmp)
                if mod.bias is not None:
                    mod.bias.zero_()
    return model


def cast_weights(model: nn.Module) -> nn.Module:
    """Store every conv and dense weight and bias in its layer's compute
    dtype, in place, so that the cast at each use costs nothing: the values
    are those the fp32 parameters give at use.  For serving; a model cast so
    is not to be trained."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Conv, Dense)):
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.data = p.data.to(mod.dtype)
    return model
