"""Host-side streaming driver: video frames in, stabilized frames out.

Reference equivalent: the deploy_bundle.py main loop (deploy_bundle.py:183-371)
with all its options: warm-up, --refine, --max-span, --infer-with-stable /
--infer-with-last, --random-black occlusion testing, --deploy-vis diagnostic
mosaics, --start-with-stable, and the final accumulated-black maximal crop
(the JAX package's stream/driver.py).  Three serving modes:

  * `stabilize_clip`: one clip, frame by frame; the production path reads
    frame t-1 back while step t runs (pipelined), the ablation and vis modes
    read every frame back before the next is sent;
  * `stabilize_batch`: many clips as lock-step streams of the engine's scan;
  * `stabilize_stream` / `stabilize_file(stream_chunk=K)`: a stream in
    constant host memory, K frames at a time.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from stabnet_tpu_torch.ops.crop import max_clear_rect
from stabnet_tpu_torch.stream import video_io
from stabnet_tpu_torch.stream.engine import StreamEngine, gray_from_color
from stabnet_tpu_torch.utils import get_logger
from stabnet_tpu_torch.utils.profiling import StageTimer

logger = get_logger()


@dataclasses.dataclass
class DeployOptions:
    """Mirror of the reference deploy CLI flags (deploy_bundle.py:12-31)."""

    refine: int = 1
    max_span: int = 1
    infer_with_stable: bool = False
    infer_with_last: bool = False
    start_with_stable: bool = False
    random_black: Optional[int] = None
    deploy_vis: bool = False
    output_size: Optional[Tuple[int, int]] = None  # (H, W); None = source size
    device_gray: bool = False  # derive the model-scale gray on the device from
                               # the uploaded color frame (engine.gray_from_color;
                               # < 1/255 from the host conversion)
    collect_input_gray: bool = False  # keep the model-scale inputs in ClipResult
                                      # (O(T) host memory; `stabilize --metrics`)
    pipelined: Optional[bool] = None  # read frame t-1's output back after
                                      # dispatching step t.  None = auto: on
                                      # unless an ablation or vis mode needs
                                      # each output on the host before the
                                      # next frame.  Results are identical.

    @property
    def ablations(self) -> bool:
        """Whether a mode outside the production path is on (history
        ablations, --start-with-stable, --deploy-vis)."""
        return (self.infer_with_stable or self.infer_with_last or self.max_span > 1
                or self.random_black is not None or self.deploy_vis
                or self.start_with_stable)


@dataclasses.dataclass
class ClipResult:
    frames: Optional[np.ndarray]   # (T, Ho, Wo, 3) uint8 stabilized frames
                                   # (None when streamed: frames go to the writer)
    cropped: Optional[np.ndarray]  # (T, Hc, Wc, 3) uint8 black-free crop
    crop_rect: Tuple[int, int, int, int]
    all_black: np.ndarray          # (H, W) accumulated black counts
    fps_net: float                 # net-step throughput (frames/s)
    vis: Optional[np.ndarray] = None  # (T-1, 2H, 2W, 3) uint8 --deploy-vis mosaics
    input_gray: Optional[np.ndarray] = None  # (T, H, W) model-scale inputs, the
                                             # grays the steps computed (frame 0
                                             # without the crop zoom)
    num_frames: int = 0            # output frames (the warm-up frame 0 included)
    stage_summary: Optional[dict] = None  # StageTimer.summary(): per frame
                                          # "pre", "dispatch", "readback", "net"
                                          # (dispatch + readback); per batch
                                          # "pre" and "scan"

    def __post_init__(self):
        if self.frames is not None and not self.num_frames:
            self.num_frames = len(self.frames)


def _bounce(delta: int, bound: int, speed: int) -> Tuple[int, int]:
    """Bouncing occlusion offset (reference: getNext, deploy_bundle.py:95-99)."""
    tmp = delta + speed
    if tmp >= bound or tmp < 0:
        speed *= -1
    return delta + speed, speed


class _Readback:
    """A step's output frame on its way to the host.

    On CUDA, a non-blocking copy into a pinned host buffer, queued right
    after the step's launches, and an event after it: reading waits for that
    step alone.  (A `.cpu()` issued after the NEXT step's launches would queue
    behind that step too.)  The caller alternates two buffers, so the host
    never reads a buffer that a copy is writing.  On the CPU the step's output
    is already a host tensor of its own.
    """

    def __init__(self, frame: torch.Tensor, buf: Optional[torch.Tensor]):
        self.event = None
        if buf is None:
            self.frame = frame
        else:
            buf.copy_(frame, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            self.frame = buf

    def read(self) -> np.ndarray:
        if self.event is None:
            return self.frame.numpy()
        self.event.synchronize()
        return self.frame.numpy().copy()


class StreamDriver:
    """Stabilize clips with a StreamEngine; one instance per engine config."""

    def __init__(self, engine: StreamEngine,
                 options: Optional[DeployOptions] = None):
        self.engine = engine
        self.cfg = engine.cfg
        self.opt = options or DeployOptions()

    # -- one clip, frame by frame --------------------------------------------
    def stabilize_clip(self, unstable: np.ndarray,
                       stable: Optional[np.ndarray] = None) -> ClipResult:
        """Stabilize one clip given as (T, H, W, 3) uint8 BGR frames.

        `stable`, the clip's ground-truth stable frames, feeds
        --infer-with-stable, --random-black, --start-with-stable and the vis
        mosaics.
        """
        cfg, opt = self.cfg, self.opt
        T = len(unstable)
        if T < 2:
            raise ValueError("need at least 2 frames")
        first = stable[0] if (opt.start_with_stable and stable is not None) else unstable[0]
        first_gray = video_io.to_gray_train(first, cfg.height, cfg.width,
                                            cfg.crop_rate)
        state = self.engine.init(first_gray[None])

        out_hw = tuple(opt.output_size or unstable.shape[1:3])
        out_frames: List[np.ndarray] = [self._resize_color(first, out_hw)]
        # Only the quality metrics keep the inputs (O(T) host memory); grays
        # derived on the device stay there until the clip ends.
        in_grays = [self._model_gray(unstable[0])] if opt.collect_input_gray else None
        vis_frames: List[np.ndarray] = []

        # Ablation bookkeeping (host-side history, only when needed).
        host_hist = host_masks = None
        if opt.infer_with_stable or opt.infer_with_last or opt.max_span > 1:
            host_hist = [first_gray.copy() for _ in range(cfg.history_len)]
            host_masks = [np.zeros_like(first_gray) for _ in range(cfg.history_len)]
        span_stack = None
        span_age = 0
        delta, speed = 0, opt.random_black or 0
        if opt.random_black is not None and stable is None:
            # Reference quirk kept: the occlusion applies to the STABLE train
            # frame (deploy_bundle.py:252-256), so without a stable clip there
            # is nothing to occlude.
            logger.warning(
                "--random-black has no effect: no stable ground-truth video "
                "for this clip (the occlusion applies to the stable history "
                "frames; pair it with --infer-with-stable)")

        # Same-step host feedback (history ablations, vis mosaics) cannot lag
        # a frame behind; the production path can.
        needs_sync = host_hist is not None or opt.deploy_vis
        pipelined = opt.pipelined
        if pipelined is None:
            pipelined = not needs_sync
        elif pipelined and needs_sync:
            raise ValueError(
                "pipelined serving defers each frame's readback by one step; "
                "history ablations and --deploy-vis need the output on host "
                "before the next frame (drop those modes, or pipelined=False)")
        pinned = pipelined and self.engine.device.type == "cuda"
        bufs: List[Optional[torch.Tensor]] = [None, None]

        timers = StageTimer()
        pending = None  # pipelined: (the previous frame's _Readback, its dispatch s)
        # At t=1 the "last output" is the warm-up frame replicated into the
        # history (deploy_bundle.py:216-224).
        prev_fed_back: np.ndarray = first_gray.copy()
        for t in range(1, T):
            frame = unstable[t]
            with timers.stage("pre"):
                # device_gray: the engine derives the model-scale gray from
                # the uploaded color frame; the host converts only what the
                # HOST consumes (vis).
                cur_gray = None
                if not opt.device_gray or opt.deploy_vis:
                    cur_gray = video_io.to_gray_train(frame, cfg.height, cfg.width, 1.0)
                # --random-black occludes the STABLE train frame that feeds
                # the history under --infer-with-stable (deploy_bundle.py:
                # 249-256), a robustness test of the history channels.  Built
                # here so the vis mosaic shows the occlusion too.
                stable_gray = None
                if stable is not None and t < len(stable):
                    stable_gray = video_io.to_gray_train(
                        stable[t], cfg.height, cfg.width, cfg.crop_rate)
                    if opt.random_black is not None:
                        delta, speed = _bounce(delta, 50, speed)
                        w = stable_gray.shape[1]
                        stable_gray[:, delta:] = stable_gray[:, : w - delta]
                        stable_gray[:, :delta] = -1.0

                override = None
                if host_hist is not None:
                    offs = [i for i in cfg.indices if i > 0]
                    chans = [host_masks[-i] for i in offs] if cfg.input_mask else []
                    chans += [host_hist[-i] for i in offs]
                    override = np.stack(chans, axis=-1)[None]
                    if opt.max_span > 1:
                        if span_stack is None or span_age >= opt.max_span:
                            span_stack, span_age = override, 0
                        override = span_stack
                        span_age += 1

            with timers.stage("dispatch"):
                state, out = self.engine.step(
                    state, None if opt.device_gray else cur_gray[None],
                    frame[None], history_override=override)
            dispatch_s = timers.samples["dispatch"][-1]
            if in_grays is not None:
                in_grays.append(out.input_gray[0] if opt.device_gray else cur_gray)

            if pipelined:
                # Frame t's copy is queued now; frame t-1 is read only after
                # step t was dispatched.
                buf = None
                if pinned:
                    if bufs[t % 2] is None:
                        bufs[t % 2] = torch.empty(tuple(out.warped_color.shape[1:]),
                                                  dtype=torch.uint8, pin_memory=True)
                    buf = bufs[t % 2]
                current = (_Readback(out.warped_color[0], buf), dispatch_s)
                if pending is not None:
                    self._collect(pending, out_frames, timers)
                pending = current
                continue

            with timers.stage("readback"):
                out_frames.append(out.warped_color[0].cpu().numpy())
            timers.add("net", dispatch_s + timers.samples["readback"][-1])
            if needs_sync:
                out_gray = out.output_gray[0].cpu().numpy()
                black = out.black[0].cpu().numpy()
                if opt.deploy_vis:
                    vis_frames.append(self._vis_mosaic(out_gray, cur_gray, stable_gray,
                                                       prev_fed_back))
                prev_fed_back = out_gray + black * (-1.0)

            if host_hist is not None:
                if opt.infer_with_stable and stable_gray is not None:
                    host_hist.append(stable_gray)
                    host_masks.append(np.zeros_like(first_gray))
                else:
                    host_hist.append(prev_fed_back)
                    host_masks.append(black)
                if opt.infer_with_last:
                    host_hist = [host_hist[-1]] * len(host_hist)
                host_hist.pop(0)
                host_masks.pop(0)

        if pending is not None:
            self._collect(pending, out_frames, timers)

        all_black = state.all_black[0].cpu().numpy()
        rect = max_clear_rect(all_black)
        ys, xs = self._crop_slices(rect, out_hw)
        frames_arr = np.stack(out_frames)
        summary = timers.summary()
        tot_net = summary["net"]["total_s"]
        fps_net = (T - 1) / tot_net if tot_net > 0 else float("inf")
        if in_grays is not None:
            in_grays = np.stack([g if isinstance(g, np.ndarray) else g.cpu().numpy()
                                 for g in in_grays])
        return ClipResult(
            frames=frames_arr, cropped=frames_arr[:, ys, xs, :], crop_rect=rect,
            all_black=all_black, fps_net=fps_net,
            vis=np.stack(vis_frames) if vis_frames else None,
            input_gray=in_grays, stage_summary=summary)

    @staticmethod
    def _collect(pending, out_frames: List[np.ndarray], timers: StageTimer) -> None:
        """Read a pipelined frame back; its "net" is its dispatch plus this
        wait."""
        readback, dispatch_s = pending
        with timers.stage("readback"):
            out_frames.append(readback.read())
        timers.add("net", dispatch_s + timers.samples["readback"][-1])

    def _model_gray(self, frame: np.ndarray) -> np.ndarray:
        """(H, W) model-scale gray of one (Hf, Wf, 3) frame, without the crop
        zoom, derived where the steps derive it (host or device)."""
        cfg = self.cfg
        if not self.opt.device_gray:
            return video_io.to_gray_train(frame, cfg.height, cfg.width, 1.0)
        color = torch.from_numpy(frame[None]).to(self.engine.device).permute(0, 3, 1, 2)
        return gray_from_color(color, (cfg.height, cfg.width))[0].cpu().numpy()

    # -- many clips as lock-step streams (throughput mode) -------------------
    def stabilize_batch(self, clips: List[np.ndarray],
                        chunk: Optional[int] = None,
                        sharded: bool = False,
                        pad_streams: Optional[int] = None) -> List[ClipResult]:
        """Stabilize S clips concurrently as the lock-step streams of the
        engine's scan.

        Clips are padded to a common length; a per-stream validity mask
        freezes each clip's ring buffers and crop accumulator at its true
        end, so each result is what the clip gives alone.

        Args:
          clips: list of (T_s, H, W, 3) uint8 frame arrays, T_s >= 2.
          chunk: scan the time axis in segments of this many frames (bounded
            device memory for long clips; the tail is padded with invalid
            steps).  None = one scan over the whole padded length.
          sharded: split the S clips over every local card, one model
            replica each (`StreamEngine.stabilize_clips_sharded`; S must
            divide among them); not with `chunk`.
          pad_streams: pad the stream count up to this value with dummy
            all-invalid streams (their compute is lock-step overhead, their
            results are dropped), so every group has the same shapes.

        The history ablations, --start-with-stable and --deploy-vis need the
        frame-at-a-time loop and are rejected.  Each result's stage summary
        holds the host's gray and resize preparation ("pre") apart from the
        device scan and readback ("scan"), which `fps_net` counts.
        """
        cfg, opt = self.cfg, self.opt
        if opt.ablations:
            raise ValueError(
                "batch mode serves the production path; history ablations, "
                "--start-with-stable, and --deploy-vis need the per-frame "
                "loop (drop --batch)")
        if sharded and chunk is not None:
            raise ValueError("chunked batch serving is a single-device path; "
                             "use one of chunk/sharded")
        if sharded and not hasattr(self.engine, "stabilize_clips_sharded"):
            raise ValueError("sharded batch serving needs a live engine")
        if not sharded:
            chunk = self.reconcile_chunk(chunk)
        if chunk is not None and not hasattr(self.engine, "continue_clip"):
            raise ValueError("chunked batch serving needs a live engine or an "
                             "artifact exported with --segment (plain artifacts "
                             "step frame by frame)")
        n_real = len(clips)
        if n_real < 1:
            raise ValueError("empty batch")
        short = [s for s, c in enumerate(clips) if len(c) < 2]
        if short:
            raise ValueError(f"clips need at least 2 frames (violated by "
                             f"batch indices {short})")
        S = max(n_real, pad_streams or 0)
        lengths = [len(c) for c in clips] + [2] * (S - n_real)
        T = max(lengths)
        if chunk is not None:
            # Whole segments up front, so no host clip buffer is copied later.
            T = 1 + -(-(T - 1) // chunk) * chunk
        if opt.output_size is None:
            sizes = {tuple(c.shape[1:3]) for c in clips}
            if len(sizes) > 1:
                raise ValueError(
                    f"clips in one batch have mixed resolutions {sizes}; "
                    f"pass output_size to pick one (single-clip mode keeps "
                    f"each clip's native size)")
        out_hw = tuple(opt.output_size or clips[0].shape[1:3])

        timers = StageTimer()
        with timers.stage("pre"):
            grays = np.zeros((S, T, cfg.height, cfg.width), np.float32)
            colors = np.zeros((S, T, *out_hw, 3), np.uint8)
            # Frames 1..T-1 are scanned; valid[s, t-1] <=> t < T_s (a prefix).
            valid = np.zeros((S, T - 1), bool)
            for s, clip in enumerate(clips):
                for t in range(lengths[s]):
                    grays[s, t] = video_io.to_gray_train(
                        clip[t], cfg.height, cfg.width,
                        cfg.crop_rate if t == 0 else 1.0)
                    colors[s, t] = self._resize_color(clip[t], out_hw)
                # Padded steps repeat the last real frame; their state writes
                # are masked out.
                grays[s, lengths[s]:] = grays[s, lengths[s] - 1]
                colors[s, lengths[s]:] = colors[s, lengths[s] - 1]
                valid[s, : lengths[s] - 1] = True

        with timers.stage("scan"):
            if chunk is None:
                scan = (self.engine.stabilize_clips_sharded if sharded
                        else self.engine.stabilize_clip)
                warped, state = scan(grays, colors, valid=valid)
                warped_np = warped.cpu().numpy()          # (S, T-1, Ho, Wo, 3)
            else:
                state = self.engine.init(grays[:, 0])
                segs = []
                for k in range((T - 1) // chunk):
                    lo, hi = 1 + k * chunk, 1 + (k + 1) * chunk
                    w, state = self.engine.continue_clip(
                        state, grays[:, lo:hi], colors[:, lo:hi],
                        valid=valid[:, lo - 1: hi - 1])
                    segs.append(w.cpu().numpy())
                warped_np = np.concatenate(segs, axis=1)
            all_black = state.all_black.cpu().numpy()
        summary = timers.summary()
        elapsed = summary["scan"]["total_s"]
        total_frames = sum(len(c) - 1 for c in clips)
        fps = total_frames / elapsed if elapsed > 0 else float("inf")

        results = []
        for s, clip in enumerate(clips):
            frames_arr = np.concatenate([self._resize_color(clip[0], out_hw)[None],
                                         warped_np[s, : lengths[s] - 1]])
            rect = max_clear_rect(all_black[s])
            ys, xs = self._crop_slices(rect, out_hw)
            # input_gray reuses grays[s, 1:] (crop_rate 1.0); only frame 0
            # differs (it used cfg.crop_rate).
            results.append(ClipResult(
                frames=frames_arr, cropped=frames_arr[:, ys, xs, :], crop_rect=rect,
                all_black=all_black[s], fps_net=fps, stage_summary=summary,
                input_gray=(np.concatenate([
                    video_io.to_gray_train(clip[0], cfg.height, cfg.width, 1.0)[None],
                    grays[s, 1: lengths[s]]]) if opt.collect_input_gray else None)))
        return results

    # -- a stream in constant host memory ------------------------------------
    def _check_streaming(self, chunk: int) -> int:
        """The streaming path's refusals, raised before any output exists;
        returns the chunk length to serve."""
        if self.opt.ablations or self.opt.collect_input_gray:
            raise ValueError(
                "streaming file serving runs the production whole-clip scan; "
                "ablation/vis/metrics modes need the buffered per-frame loop "
                "(drop --stream-chunk)")
        if chunk < 1:
            raise ValueError(f"stream_chunk must be >= 1, got {chunk}")
        if not hasattr(self.engine, "continue_clip"):
            raise ValueError("streaming file serving needs a live engine or an "
                             "artifact exported with --segment")
        return self.reconcile_chunk(chunk)

    def stabilize_stream(self, reader, writer, chunk: int,
                         name: str = "stream") -> ClipResult:
        """Serve frames from `reader` (`.read()` gives the next (H, W, 3)
        uint8 frame or None) to `writer` (`.write(frame)`), `chunk` frames
        at a time: host memory is bounded by `chunk` whatever the stream's
        length, and the device side by `engine.continue_clip`.  Production
        path only (the scan has no same-step host feedback for ablations or
        vis).  Returns the crop over the whole stream with `frames` None;
        neither `reader` nor `writer` is closed.
        """
        cfg, opt = self.cfg, self.opt
        chunk = self._check_streaming(chunk)
        first = reader.read()
        if first is None:
            raise ValueError(f"empty video: {name}")
        out_hw = tuple(opt.output_size or first.shape[:2])
        first_gray = video_io.to_gray_train(first, cfg.height, cfg.width, cfg.crop_rate)
        state = self.engine.init(first_gray[None])
        writer.write(self._resize_color(first, out_hw))
        n_out = 1
        tot_net = 0.0
        done = False
        while not done:
            grays = np.zeros((1, chunk, cfg.height, cfg.width), np.float32)
            colors = np.zeros((1, chunk, *out_hw, 3), np.uint8)
            valid = np.zeros((1, chunk), bool)
            for k in range(chunk):
                f = reader.read()
                if f is None:
                    done = True
                    break
                grays[0, k] = video_io.to_gray_train(f, cfg.height, cfg.width, 1.0)
                colors[0, k] = self._resize_color(f, out_hw)
                valid[0, k] = True
            n_valid = int(valid.sum())
            if n_valid == 0:
                break
            # The tail segment repeats its last real frame; `valid` masks the
            # padded steps out of the state and the crop accumulator.
            grays[0, n_valid:] = grays[0, n_valid - 1]
            colors[0, n_valid:] = colors[0, n_valid - 1]
            t0 = time.perf_counter()
            warped, state = self.engine.continue_clip(state, grays, colors, valid=valid)
            warped_np = warped[0, :n_valid].cpu().numpy()
            tot_net += time.perf_counter() - t0
            for f in warped_np:
                writer.write(f)
            n_out += n_valid
        all_black = state.all_black[0].cpu().numpy()
        rect = max_clear_rect(all_black)
        fps_net = (n_out - 1) / tot_net if tot_net > 0 else float("inf")
        logger.info("%s: %d frames (streamed, chunk=%d), net fps=%.1f, crop=%s",
                    name, n_out, chunk, fps_net, rect)
        return ClipResult(frames=None, cropped=None, crop_rect=rect,
                          all_black=all_black, fps_net=fps_net, num_frames=n_out)

    # -- file interface (reference CLI behavior) -----------------------------
    def stabilize_file(self, unstable_path: str, output_dir: str,
                       stable_path: Optional[str] = None,
                       stream_chunk: Optional[int] = None) -> ClipResult:
        """Stabilize a video file, writing `output/<name>.avi` and
        `output/<name>_cut.avi` under `output_dir` (reference:
        deploy_bundle.py:183-371), and with --deploy-vis
        `output-vis/<name>.avi`.  `stable_path`, if it exists, is the clip's
        stable ground truth.  `stream_chunk=K` serves the file in constant
        host memory (`stabilize_stream`)."""
        if stream_chunk is not None:
            return self._stabilize_file_streaming(unstable_path, output_dir,
                                                  stream_chunk)
        reader = video_io.VideoReader(unstable_path)
        frames = np.stack(list(reader))
        reader.close()
        stable = None
        if stable_path and os.path.exists(stable_path):
            sreader = video_io.VideoReader(stable_path)
            stable = np.stack(list(sreader))
            sreader.close()
        res = self.stabilize_clip(frames, stable)
        name = os.path.basename(unstable_path)
        prod = os.path.join(output_dir, "output")
        os.makedirs(prod, exist_ok=True)
        self._write_video(os.path.join(prod, name + ".avi"), res.frames, reader.fps)
        self._write_video(os.path.join(prod, name + "_cut.avi"), res.cropped,
                          reader.fps)
        if res.vis is not None:
            self._write_video(os.path.join(output_dir, "output-vis", name + ".avi"),
                              res.vis, reader.fps)
        logger.info("%s: %d frames, net fps=%.1f, crop=%s",
                    name, len(res.frames), res.fps_net, res.crop_rect)
        return res

    def _stabilize_file_streaming(self, unstable_path: str, output_dir: str,
                                  chunk: int) -> ClipResult:
        """`stabilize_stream` from a file to `output/<name>.avi`, then the
        `_cut.avi` pass re-reads that output: host memory stays bounded by
        `chunk`.  One deviation from the buffered mode: the cut crops the
        ENCODED output frames (one more MJPG decode), not the raw warps."""
        self._check_streaming(chunk)   # before any output file exists
        reader = video_io.VideoReader(unstable_path)
        name = os.path.basename(unstable_path)
        prod = os.path.join(output_dir, "output")
        out_path = os.path.join(prod, name + ".avi")
        # Opened at its first frame, whose size the stream decides.
        writer = video_io.VideoWriter(out_path, reader.fps)
        try:
            res = self.stabilize_stream(reader, writer, chunk, name=unstable_path)
        finally:
            writer.close()
            reader.close()
        ys, xs = self._crop_slices(res.crop_rect, writer.size_hw)
        cut_reader = video_io.VideoReader(out_path, allow_half_rate=False)
        cut_writer = video_io.VideoWriter(os.path.join(prod, name + "_cut.avi"),
                                          reader.fps)
        for f in cut_reader:
            cut_writer.write(f[ys, xs])
        cut_reader.close()
        cut_writer.close()
        return res

    # -- helpers -------------------------------------------------------------
    def reconcile_chunk(self, chunk: Optional[int]) -> Optional[int]:
        """Resolve a requested scan-chunk length against the engine.

        An engine with a baked whole-segment scan (an exported artifact's
        `segment`) fixes the segment length: chunked serving must ride it,
        and with no explicit request the baked length is adopted.  A live
        engine scans whatever length is asked for.  Raises ValueError on a
        conflict; callers run this before any output file is created.
        """
        baked = getattr(self.engine, "segment", None)
        if baked:
            if chunk is not None and chunk != baked:
                raise ValueError(
                    f"chunk size {chunk} conflicts with the artifact's "
                    f"baked {baked}-frame scan segment; use {baked}, or "
                    f"re-export with --segment {chunk}")
            return baked
        return chunk

    def _crop_slices(self, rect: Tuple[int, int, int, int],
                     out_hw: Tuple[int, int]) -> Tuple[slice, slice]:
        """Scale a model-resolution crop rectangle to output-resolution
        slices (ceil/floor so the cut never includes a black border pixel);
        every serving mode's cut goes through here."""
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

    @staticmethod
    def _vis_mosaic(out_gray: np.ndarray, cur_gray: np.ndarray,
                    stable_gray: Optional[np.ndarray],
                    prev_fed_back: np.ndarray) -> np.ndarray:
        """2x2 diagnostic mosaic (reference: draw_imgs, deploy_bundle.py:77-93):
        [net output | output - stable ; output - input | output - last].

        "last" is the previous stabilized frame as fed back into the history
        (the reference reads input channel 0, which in the mask-less layout is
        before_frames[-1]; with input_mask=True that literal index lands on a
        mask channel, so the intended frame is drawn).
        """
        net = video_io.from_gray_train(out_gray).astype(np.int32)
        unstable_img = video_io.from_gray_train(cur_gray).astype(np.int32)
        last_img = video_io.from_gray_train(prev_fed_back).astype(np.int32)
        if stable_gray is not None:
            st = video_io.from_gray_train(stable_gray).astype(np.int32)
        else:
            st = np.zeros_like(net)
        top = np.concatenate([net, np.abs(net - st)], axis=1)
        bottom = np.concatenate([np.abs(net - unstable_img),
                                 np.abs(net - last_img)], axis=1)
        img = np.concatenate([top, bottom], axis=0).astype(np.uint8)
        return np.repeat(img[..., None], 3, axis=-1)
