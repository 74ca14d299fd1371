"""Online streaming stabilization engine (PyTorch port).

Reference equivalent: the deploy driver's per-frame loop
(deploy_bundle.py:183-371): assemble a 13-channel input from ring buffers,
run the net, warp the full-res color frame, push the net output back into the
history.  The JAX package's stream/engine.py runs the same step under jit and
the whole clip as one lax.scan; here the step runs eagerly and a clip is a
Python loop over it.

  * The 32-slot history ring (frames + masks) and the crop accumulator live
    on the device.  Ring writes are IN PLACE: a step mutates the tensors of
    the state it is given and returns a state that shares them (the JAX
    engine donates the state buffer for the same effect).
  * `ptr` is a host int shared by all streams (they advance in lock-step),
    so building the input stack never waits on the device.
  * The gray warp at model scale with its dense maps and black mask
    (kernel K2m, one launch per refine pass) and the full-resolution color
    warp with the fused map up-sample (kernel K1) run as the hand-written
    CUDA kernels of ops/cuda_warp.py on CUDA tensors, and as their plain
    versions on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.models.resnet import cast_weights
from stabnet_tpu_torch.models.stabnet import forward
from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.ops.crop import max_clear_rect
from stabnet_tpu_torch.ops.resize import resize_bilinear_bhw as resize_bilinear
from stabnet_tpu_torch.utils import resolve_device


class StreamState(NamedTuple):
    """Device-resident per-stream state (S = number of concurrent streams)."""

    frames: torch.Tensor     # (S, L, H, W) stabilized history, model scale
    masks: torch.Tensor      # (S, L, H, W) black-border history
    ptr: int                 # index of the next frame to process (host int;
                             # all streams advance in lock-step)
    all_black: torch.Tensor  # (S, H, W) int32 accumulated black mask counts


class StepOutput(NamedTuple):
    output_gray: torch.Tensor   # (S, H, W) net output, model scale
    black: torch.Tensor         # (S, H, W)
    x_map: torch.Tensor         # (S, H, W)
    y_map: torch.Tensor         # (S, H, W)
    warped_color: torch.Tensor  # (S, Ho, Wo, 3) uint8 stabilized full-res frame
    input_gray: torch.Tensor    # (S, H, W) the step's model-scale input frame


def init_state(first_gray: torch.Tensor, cfg: StabNetConfig) -> StreamState:
    """Warm-up: replicate frame 0 into every ring slot, zero masks
    (reference: deploy_bundle.py:216-224).  first_gray: (S, H, W)."""
    S, H, W = first_gray.shape
    L = cfg.history_len
    frames = first_gray.float()[:, None].expand(S, L, H, W).contiguous()
    masks = torch.zeros((S, L, H, W), dtype=torch.float32,
                        device=first_gray.device)
    all_black = torch.zeros((S, H, W), dtype=torch.int32,
                            device=first_gray.device)
    return StreamState(frames, masks, 1, all_black)  # frame 0 passes through


def _history_slots(ptr: int, L: int, cfg: StabNetConfig):
    """Ring slots of the history offsets, ascending offsets: (ptr - i) % L."""
    return [(ptr - i) % L for i in cfg.indices if i > 0]


def assemble_input(state: StreamState, cur_gray: torch.Tensor,
                   cfg: StabNetConfig) -> torch.Tensor:
    """Build the (S, H, W, C_in) input stack from the device ring buffers.

    Channel order matches training and deploy: history masks (offsets
    ascending), history frames, current frame (deploy_bundle.py:259-274).
    """
    slots = _history_slots(state.ptr, state.frames.shape[1], cfg)
    # Slices, not a list index: indexing with a host list uploads an index
    # tensor, which makes the host wait for the device's queue.
    rings = ([state.masks] if cfg.input_mask else []) + [state.frames]
    parts = [ring[:, s: s + 1] for ring in rings for s in slots]
    parts.append(cur_gray.float()[:, None])
    return torch.cat(parts, dim=1).permute(0, 2, 3, 1)


def gray_from_color(color: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Model-scale gray derived on the device from the full-res color frame.

    color: (S, 3, Hf, Wf) uint8 BGR, channels first.  BT.601 luma +
    half-pixel bilinear down-resize, the math the host
    `video_io.to_gray_train` performs with cv2 (reference: cvt_img2train,
    config.py:6-21), except that the gray stays float and the resize runs in
    f32 (cv2 rounds to uint8 and resizes in fixed point), each < 1/255.
    """
    colf = color.float()
    b, g, r = colf[:, 0], colf[:, 1], colf[:, 2]
    gray = 0.114 * b + 0.587 * g + 0.299 * r
    return resize_bilinear(gray, hw) / 255.0 - 0.5


def warp_color(color: torch.Tensor, x_map: torch.Tensor, y_map: torch.Tensor,
               out_hw: Tuple[int, int], smooth_rate: int = 4) -> torch.Tensor:
    """Warp full-resolution uint8 color frames by the (smoothed) NDC maps.

    color: (S, 3, Hf, Wf) uint8, channels first.  Returns (S, Ho, Wo, 3) uint8.  The maps are low-passed at model
    resolution (4x down), then kernel K1 up-samples them to `out_hw` in
    registers and samples the full-res frame (the reference warps a
    downscaled 512x288 frame on the host instead, deploy_bundle.py:136-146).
    """
    S, H, W = x_map.shape
    xs = resize_bilinear(x_map, (H // smooth_rate, W // smooth_rate))
    ys = resize_bilinear(y_map, (H // smooth_rate, W // smooth_rate))
    return cuda_warp.warp_uint8_cf_lowres(color.contiguous(), xs.contiguous(),
                                          ys.contiguous(), tuple(out_hw))


@torch.inference_mode()
def stream_step(model, state: StreamState, cur_gray: Optional[torch.Tensor],
                cur_color: torch.Tensor, cfg: StabNetConfig, refine: int = 1,
                out_hw: Optional[Tuple[int, int]] = None,
                history_override: Optional[torch.Tensor] = None
                ) -> Tuple[StreamState, StepOutput]:
    """Process one frame per stream; writes the ring slots of `state` in place.

    Args:
      cur_gray: (S, H, W) current unstable frame, model scale — or None to
        derive it on the device from `cur_color` (`gray_from_color`).
      cur_color: (S, 3, Hf, Wf) uint8 full-res current frame, channels
        first (StreamEngine transposes the caller's (S, Hf, Wf, 3) once).
      refine: number of self-refinement passes (deploy_bundle.py:284-295).
      history_override: optional (S, H, W, C_in - 1) replacing the ring's
        history channels (ablation modes).
    """
    H, W = cfg.height, cfg.width
    if cur_gray is None:
        cur_gray = gray_from_color(cur_color, (H, W))
    if history_override is None:
        x = assemble_input(state, cur_gray, cfg)
    else:
        x = torch.cat([history_override.float(), cur_gray.float()[..., None]],
                      dim=-1)

    passes = max(refine, 1)
    for k in range(passes):
        warp = forward(model, x, cfg).warp
        if k + 1 < passes:
            fed_back = warp.output[..., 0] + warp.black_pix * (-1.0)
            x = torch.cat([x[..., :-1], fed_back[..., None]], dim=-1)

    out_gray = warp.output[..., 0]
    black = warp.black_pix
    slot = state.ptr % state.frames.shape[1]
    state.frames[:, slot] = out_gray + black * (-1.0)
    state.masks[:, slot] = black
    state.all_black.add_(torch.round(black).to(torch.int32))
    new_state = state._replace(ptr=state.ptr + 1)

    warped = warp_color(cur_color, warp.x_map, warp.y_map,
                        out_hw or tuple(cur_color.shape[2:4]))
    return new_state, StepOutput(output_gray=out_gray, black=black,
                                 x_map=warp.x_map, y_map=warp.y_map,
                                 warped_color=warped, input_gray=cur_gray)


@torch.inference_mode()
def scan_frames(model, state: StreamState, clip_gray: torch.Tensor,
                clip_color: torch.Tensor, cfg: StabNetConfig,
                refine: int = 1, out_hw: Optional[Tuple[int, int]] = None,
                valid: Optional[np.ndarray] = None
                ) -> Tuple[torch.Tensor, StreamState]:
    """Process T' frames per stream from `state` (no warm-up).

    Args:
      clip_gray: (S, T', H, W) model-scale gray frames, ALL processed.
      clip_color: (S, T', Hf, Wf, 3) uint8 full-res frames.
      valid: optional (S, T') host bool array.  Where False, the stream's
        ring slot and crop accumulator are left untouched and its output for
        that step is to be discarded.  Validity must be a per-stream PREFIX
        (once False, False for the rest): clips of unequal length padded to
        a common T', each frozen exactly at its true end.

    Returns:
      (warped, final_state): warped (S, T', Ho, Wo, 3) uint8.
    """
    out_hw = out_hw or tuple(clip_color.shape[2:4])
    # One whole-clip transpose to channels-first: no layout change per frame.
    color_cf = clip_color.permute(0, 1, 4, 2, 3).contiguous()
    warped = []
    for t in range(clip_gray.shape[1]):
        keep = None
        if valid is not None and not bool(np.all(valid[:, t])):
            keep = torch.as_tensor(np.asarray(valid[:, t], bool),
                                   device=clip_gray.device)
            slot = state.ptr % state.frames.shape[1]
            old = (state.frames[:, slot].clone(), state.masks[:, slot].clone(),
                   state.all_black.clone())
        state, out = stream_step(model, state, clip_gray[:, t], color_cf[:, t],
                                 cfg, refine=refine, out_hw=out_hw)
        if keep is not None:
            k3 = keep[:, None, None]
            state.frames[:, slot] = torch.where(k3, state.frames[:, slot], old[0])
            state.masks[:, slot] = torch.where(k3, state.masks[:, slot], old[1])
            state.all_black.copy_(torch.where(k3, state.all_black, old[2]))
        warped.append(out.warped_color)
    return torch.stack(warped, dim=1), state


def stabilize_clip_device(model, clip_gray: torch.Tensor,
                          clip_color: torch.Tensor, cfg: StabNetConfig,
                          refine: int = 1,
                          out_hw: Optional[Tuple[int, int]] = None,
                          valid: Optional[np.ndarray] = None
                          ) -> Tuple[torch.Tensor, StreamState]:
    """Stabilize whole clips on the device: frame 0 warms up the history,
    frames 1..T-1 are processed.

    clip_gray: (S, T, H, W); clip_color: (S, T, Hf, Wf, 3) uint8; valid:
    optional (S, T-1) prefix validity for frames 1..T-1.  Returns (warped
    (S, T-1, Ho, Wo, 3) uint8, final_state).
    """
    state0 = init_state(clip_gray[:, 0], cfg)
    return scan_frames(model, state0, clip_gray[:, 1:], clip_color[:, 1:], cfg,
                       refine=refine, out_hw=out_hw, valid=valid)


class StreamEngine:
    """Online stabilizer over S concurrent streams on one device.

    `device` defaults to CUDA and raises if CUDA is missing; pass
    device="cpu" to run the plain versions on the CPU.  The model is moved
    to the device, put in eval mode, and its conv and dense weights are cast
    to the compute dtype in place (`cast_weights`: the values the fp32
    parameters give at each use, without a cast per frame).
    """

    def __init__(self, model, cfg: StabNetConfig, refine: int = 1,
                 out_hw: Optional[Tuple[int, int]] = None, device=None):
        self.device = resolve_device(device)
        self.model = cast_weights(model.to(self.device).eval())
        self.cfg = cfg
        self.refine = refine
        self.out_hw = out_hw

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _put_color(self, color) -> torch.Tensor:
        """(S, Hf, Wf, 3) uint8 -> (S, 3, Hf, Wf) on the device (one copy
        after the upload)."""
        return self._put(color).permute(0, 3, 1, 2).contiguous()

    def init(self, first_gray: np.ndarray) -> StreamState:
        return init_state(self._put(first_gray), self.cfg)

    def step(self, state: StreamState, cur_gray: Optional[np.ndarray],
             cur_color: np.ndarray,
             history_override: Optional[np.ndarray] = None
             ) -> Tuple[StreamState, StepOutput]:
        """One frame per stream.  `cur_gray=None` derives the model-scale gray
        on the device from `cur_color` (the single-upload path)."""
        return stream_step(
            self.model, state,
            None if cur_gray is None else self._put(cur_gray),
            self._put_color(cur_color), self.cfg, refine=self.refine,
            out_hw=self.out_hw,
            history_override=(None if history_override is None
                              else self._put(history_override)))

    def stabilize_clip(self, clip_gray: np.ndarray, clip_color: np.ndarray,
                       valid: Optional[np.ndarray] = None
                       ) -> Tuple[torch.Tensor, StreamState]:
        """Whole-clip stabilization (see stabilize_clip_device)."""
        return stabilize_clip_device(self.model, self._put(clip_gray),
                                     self._put(clip_color), self.cfg,
                                     refine=self.refine, out_hw=self.out_hw,
                                     valid=valid)

    def continue_clip(self, state: StreamState, clip_gray: np.ndarray,
                      clip_color: np.ndarray,
                      valid: Optional[np.ndarray] = None
                      ) -> Tuple[torch.Tensor, StreamState]:
        """Process a segment of frames from an existing state (see
        scan_frames); `state`'s ring is updated in place."""
        return scan_frames(self.model, state, self._put(clip_gray),
                           self._put(clip_color), self.cfg, refine=self.refine,
                           out_hw=self.out_hw, valid=valid)


def crop_rectangle(all_black: np.ndarray) -> Tuple[int, int, int, int]:
    """Final maximal black-free crop over the whole clip of one stream's
    (H, W) accumulated black map (reference: deploy_bundle.py:344-365; see
    ops/crop.py)."""
    return max_clear_rect(np.asarray(all_black))
