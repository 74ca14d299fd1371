"""Host-side streaming driver: video frames in, stabilized frames out.

Reference equivalent: the deploy_bundle.py main loop (deploy_bundle.py:183-371)
in its production mode: warm-up, --refine, and the final accumulated-black
maximal crop.  Each frame is read back before the next is sent (synchronous
serving).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from stabnet_tpu_torch.ops.crop import max_clear_rect
from stabnet_tpu_torch.stream import video_io
from stabnet_tpu_torch.stream.engine import StreamEngine, gray_from_color
from stabnet_tpu_torch.utils.profiling import StageTimer

logger = logging.getLogger("stabnet_tpu_torch")


@dataclasses.dataclass
class DeployOptions:
    """The deploy CLI flags the port serves (deploy_bundle.py:12-31)."""

    refine: int = 1
    output_size: Optional[Tuple[int, int]] = None  # (H, W); None = source size
    device_gray: bool = False  # derive the model-scale gray on the device from
                               # the uploaded color frame (engine.gray_from_color;
                               # < 1/255 from the host conversion)
    collect_input_gray: bool = False  # keep the model-scale inputs in ClipResult
                                      # (O(T) host memory; `stabilize --metrics`)


@dataclasses.dataclass
class ClipResult:
    frames: np.ndarray            # (T, Ho, Wo, 3) uint8 stabilized frames
    cropped: np.ndarray           # (T, Hc, Wc, 3) uint8 black-free crop
    crop_rect: Tuple[int, int, int, int]
    all_black: np.ndarray         # (H, W) accumulated black counts
    fps_net: float                # net-step throughput (frames/s)
    stage_summary: Optional[dict] = None  # per-frame latency decomposition
                                          # (StageTimer.summary())
    input_gray: Optional[np.ndarray] = None  # (T, H, W) model-scale inputs, the
                                             # grays the steps computed (frame 0
                                             # without the crop zoom)


class StreamDriver:
    """Stabilize clips with a StreamEngine; one instance per engine config."""

    def __init__(self, engine: StreamEngine,
                 options: Optional[DeployOptions] = None):
        self.engine = engine
        self.cfg = engine.cfg
        self.opt = options or DeployOptions()

    def stabilize_clip(self, unstable: np.ndarray) -> ClipResult:
        """Stabilize one clip given as (T, H, W, 3) uint8 BGR frames."""
        cfg, opt = self.cfg, self.opt
        T = len(unstable)
        if T < 2:
            raise ValueError("need at least 2 frames")
        first = unstable[0]
        first_gray = video_io.to_gray_train(first, cfg.height, cfg.width,
                                            cfg.crop_rate)
        state = self.engine.init(first_gray[None])

        out_hw = tuple(opt.output_size or unstable.shape[1:3])
        out_frames: List[np.ndarray] = [self._resize_color(first, out_hw)]
        # Only the quality metrics keep the inputs (O(T) host memory).
        in_grays: Optional[List[np.ndarray]] = (
            [self._model_gray(first)] if opt.collect_input_gray else None)
        timers = StageTimer()
        for t in range(1, T):
            frame = unstable[t]
            with timers.stage("pre"):
                cur_gray = None
                if not opt.device_gray:
                    cur_gray = video_io.to_gray_train(
                        frame, cfg.height, cfg.width, 1.0)[None]
            with timers.stage("net"):  # one frame's latency: both below
                with timers.stage("dispatch"):
                    state, out = self.engine.step(state, cur_gray, frame[None])
                with timers.stage("readback"):
                    out_frames.append(out.warped_color[0].cpu().numpy())
            if in_grays is not None:
                in_grays.append(cur_gray[0] if cur_gray is not None
                                else out.input_gray[0].cpu().numpy())

        all_black = state.all_black[0].cpu().numpy()
        rect = max_clear_rect(all_black)
        ys, xs = self._crop_slices(rect, out_hw)
        frames_arr = np.stack(out_frames)
        summary = timers.summary()
        tot_net = summary["net"]["total_s"]
        fps_net = (T - 1) / tot_net if tot_net > 0 else float("inf")
        return ClipResult(frames=frames_arr, cropped=frames_arr[:, ys, xs, :],
                          crop_rect=rect, all_black=all_black, fps_net=fps_net,
                          stage_summary=summary,
                          input_gray=None if in_grays is None else np.stack(in_grays))

    def _model_gray(self, frame: np.ndarray) -> np.ndarray:
        """(H, W) model-scale gray of one (Hf, Wf, 3) frame, without the crop
        zoom, derived where the steps derive it (host or device)."""
        cfg = self.cfg
        if not self.opt.device_gray:
            return video_io.to_gray_train(frame, cfg.height, cfg.width, 1.0)
        color = torch.from_numpy(frame[None]).to(self.engine.device).permute(0, 3, 1, 2)
        return gray_from_color(color, (cfg.height, cfg.width))[0].cpu().numpy()

    def stabilize_file(self, unstable_path: str, output_dir: str) -> ClipResult:
        """Stabilize a video file, writing `output/<name>.avi` and
        `output/<name>_cut.avi` under `output_dir` (reference:
        deploy_bundle.py:183-371)."""
        reader = video_io.VideoReader(unstable_path)
        frames = np.stack(list(reader))
        reader.close()
        res = self.stabilize_clip(frames)
        name = os.path.basename(unstable_path)
        prod = os.path.join(output_dir, "output")
        os.makedirs(prod, exist_ok=True)
        self._write_video(os.path.join(prod, name + ".avi"), res.frames,
                          reader.fps)
        self._write_video(os.path.join(prod, name + "_cut.avi"), res.cropped,
                          reader.fps)
        logger.info("%s: %d frames, net fps=%.1f, crop=%s",
                    name, len(res.frames), res.fps_net, res.crop_rect)
        return res

    def _crop_slices(self, rect: Tuple[int, int, int, int],
                     out_hw: Tuple[int, int]) -> Tuple[slice, slice]:
        """Scale a model-resolution crop rectangle to output-resolution
        slices (ceil/floor so the cut never includes a black border pixel)."""
        sy = out_hw[0] / self.cfg.height
        sx = out_hw[1] / self.cfg.width
        top, left, bot, right = rect
        return (slice(int(np.ceil(top * sy)), int(np.floor((bot + 1) * sy))),
                slice(int(np.ceil(left * sx)),
                      int(np.floor((right + 1) * sx))))

    @staticmethod
    def _resize_color(frame: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
        """(H, W, 3) uint8 -> out_hw: cv2 bilinear, or nearest without OpenCV."""
        if frame.shape[:2] == tuple(out_hw):
            return frame
        cv2 = video_io.optional_cv2()
        if cv2 is not None:
            return cv2.resize(frame, (out_hw[1], out_hw[0]))
        return video_io._resize_nearest(frame, *out_hw)

    @staticmethod
    def _write_video(path: str, frames: np.ndarray, fps: float):
        w = video_io.VideoWriter(path, fps, frames.shape[1:3])
        for f in frames:
            w.write(f)
        w.close()
