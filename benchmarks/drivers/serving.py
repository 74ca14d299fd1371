"""What the serving cells share: the program's configuration checked against
the configuration file, the model made from the benchmark's weights, and the
comparison of served frames with the plain reference's."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmarks.reference import geometry as ref_geo
from benchmarks.reference import model as ref_model
from benchmarks.reference import serve as ref_serve
from benchmarks.traffic.weights import make_weights

# Fields of the program's configuration that the configuration file fixes.
FIXED = ("height", "width", "grid_h", "grid_w", "indices", "input_mask", "do_crop_rate",
         "crop_rate", "compute_dtype", "warp_dtype")


def program_config(cfg: dict, more=()):
    """The program's configuration named by the file, refused where it
    differs from the file's numbers in `FIXED` or in `more`."""
    from stabnet_tpu_torch.config import get_config

    prog = get_config(cfg["program_config"])
    for k in FIXED + tuple(more):
        have = getattr(prog, k)
        want = tuple(cfg[k]) if isinstance(have, tuple) else cfg[k]
        if have != want:
            raise SystemExit(f"benchmark: the program's {cfg['program_config']}.{k} is "
                             f"{have!r}, the configuration file says {want!r}")
    return prog


def make_model(ctx, prog, seed: int) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """The program's regressor on the device holding `seed`'s weights, and
    the weights themselves (float32, the reference's copy)."""
    from stabnet_tpu_torch.models.resnet import StabNetRegressor

    with torch.device(ctx.device):
        model = StabNetRegressor(prog.in_channels, prog.theta_dim,
                                 dtype=getattr(torch, prog.compute_dtype))
    return model.eval(), load_weights(model, ctx, seed)


def load_weights(model: torch.nn.Module, ctx, seed: int) -> Dict[str, torch.Tensor]:
    """`seed`'s weights copied into `model`'s own tensors (at their dtypes,
    so a serving engine's graphs read them), and returned in float32."""
    W = make_weights(ctx.cfg, seed, ctx.device)
    model.load_state_dict(W)
    return W


class FrameGaps:
    """Mean absolute gap, in uint8 levels, between each served frame and the
    reference's: the worst frame's over every frame compared."""

    def __init__(self):
        self.worst = 0.0
        self.frames = 0

    def add(self, served: torch.Tensor, ref: torch.Tensor) -> None:
        """served, ref: (N, H, W, 3) uint8 on one device."""
        gap = (served.float() - ref.float()).abs().mean(dim=(1, 2, 3))
        self.worst = max(self.worst, float(gap.max()))
        self.frames += int(gap.numel())


def reference_gaps(W, cfg: dict, colors_at, T: int, out_hw, served_at, quant=None) -> Tuple[FrameGaps, np.ndarray]:
    """Run the plain stabilizer over the clips and hold each frame t >= 1
    that `served_at(t)` gives (a list of (S, Ho, Wo, 3) uint8 on the device,
    one per served call of these clips) against its own.  Returns the gaps
    and the reference's black counts."""
    ref_model.plain_precision()
    gaps = FrameGaps()

    def on_frame(t, warped):
        for served in served_at(t):
            gaps.add(served, warped)

    black = ref_serve.stabilize(W, colors_at, T, cfg, out_hw, quant=quant,
                                on_frame=on_frame)
    return gaps, black


def crop_gap(served: List[List[Tuple[int, int, int, int]]], black: np.ndarray) -> float:
    """The largest gap, in model pixels, between a side of a served crop
    rectangle (one list of rectangles per served call) and the reference's
    (from its black counts), over the clips."""
    ref = [ref_geo.max_clear_rect(b) for b in black]
    return max(float(abs(a - c)) for rects in served for rect, r in zip(rects, ref)
               for a, c in zip(rect, r))


def flops_per_frame(cfg: dict) -> int:
    """The regressor's forward FLOPs on one frame, as
    `torch.utils.flop_counter.FlopCounterMode` counts them (two per
    multiply-add of each convolution and matrix product), on the meta
    device, of the plain model: v2_93, 22,780,889,088."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        W = {n: torch.zeros(s) for n, s, _ in ref_model.param_spec(cfg)}
        x = torch.zeros((1, cfg["height"], cfg["width"], ref_model.in_channels(cfg)))
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            ref_model.regressor(W, x, cfg)
    return int(counter.get_total_flops())


def free_cuda() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

