"""Plain online stabilizer: the deploy loop of deploy_bundle.py:183-371 over S
clips in lock step, in float32.

Frame 0 fills every slot of the 32-frame history; each later frame's input
stack is the history's masks and frames at the offsets `indices` (ascending)
and the current gray; the net's output at model scale, with its black
border at -1, goes back into the history, its black mask beside it, and the
mask is added to the clip's black count; the full-resolution color frame is
warped by the smoothed maps.  The final crop is the largest rectangle that
no frame's border reached.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from benchmarks.reference import geometry as geo
from benchmarks.reference import model as net


class History:
    """The ring of one batch of streams: frames, masks, next slot, black
    counts."""

    def __init__(self, first_gray: torch.Tensor, cfg: dict):
        S, H, W = first_gray.shape
        L = max(cfg["indices"])
        self.frames = first_gray.float()[:, None].repeat(1, L, 1, 1)
        self.masks = torch.zeros_like(self.frames)
        self.all_black = torch.zeros((S, H, W), dtype=torch.int64, device=first_gray.device)
        self.ptr = 1
        self.offsets = [i for i in cfg["indices"] if i > 0]
        self.input_mask = cfg["input_mask"]

    def stack(self, cur_gray: torch.Tensor) -> torch.Tensor:
        L = self.frames.shape[1]
        slots = [(self.ptr - i) % L for i in self.offsets]
        parts = ([self.masks[:, s] for s in slots] if self.input_mask else [])
        parts += [self.frames[:, s] for s in slots] + [cur_gray.float()]
        return torch.stack(parts, dim=-1)

    def push(self, kept: torch.Tensor, black: torch.Tensor) -> None:
        slot = self.ptr % self.frames.shape[1]
        self.frames[:, slot] = kept
        self.masks[:, slot] = black
        self.all_black += torch.round(black).long()
        self.ptr += 1


def step(W, hist: History, cur_gray: torch.Tensor, cur_color: torch.Tensor, cfg: dict,
         out_hw: Tuple[int, int], quant=None) -> torch.Tensor:
    """One frame of every stream; returns the warped color frames (S, Ho,
    Wo, 3) uint8 and advances `hist`."""
    x = hist.stack(cur_gray)
    for k in range(max(cfg.get("refine", 1), 1)):
        theta = net.regressor(W, x, cfg, quant)
        mesh = geo.theta_to_mesh(theta, cfg)
        xm, ym = geo.dense_maps(geo.homographies(mesh, cfg), cfg["height"], cfg["width"])
        black = geo.black_mask(xm, ym)
        out = geo.sample(x[..., -1:], xm, ym)[..., 0]
        kept = out - black
        x = torch.cat([x[..., :-1], kept[..., None]], dim=-1)
    hist.push(kept, black)
    return geo.warp_color(cur_color, xm, ym, out_hw)


@torch.no_grad()
def run(W, color_at: Callable[[int], torch.Tensor], T: int, cfg: dict,
        out_hw: Tuple[int, int], quant=None,
        on_frame: Optional[Callable[[int, torch.Tensor], None]] = None) -> History:
    """Stabilize S clips of T frames; `color_at(t)` gives frame t of every
    clip, (S, Hf, Wf, 3) uint8 on the device; its model-scale gray is
    rounded as OpenCV rounds on the host.  `on_frame(t, warped)` sees each warped frame t >= 1 as it
    is made.  Returns the history after the last frame."""
    hw = (cfg["height"], cfg["width"])
    hist = History(geo.gray_host(color_at(0), hw), cfg)
    for t in range(1, T):
        color = color_at(t)
        warped = step(W, hist, geo.gray_host(color, hw), color, cfg, out_hw, quant)
        if on_frame is not None:
            on_frame(t, warped)
    return hist


def stabilize(*args, **kw) -> np.ndarray:
    """`run`'s black counts (S, H, W), from which the crop is cut."""
    return run(*args, **kw).all_black.cpu().numpy()
