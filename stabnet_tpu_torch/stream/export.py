"""Serving artifacts: the streaming step traced by `torch.export`, weights
baked in (the PyTorch port of stabnet_tpu/stream/export.py).

`export_stream_step` traces `engine.functional_step`, the live step's body
as a pure function of a state whose ring pointer is a 0-d tensor, into a
`torch.export` program; `export_scan_segment` traces K such steps unrolled,
with a (S, K) validity mask applied on the device.  The kernels are
`torch.library` custom ops (ops/cuda_warp.py), so the program calls
`torch.ops.stabnet.warp_mesh` (K2m) and `torch.ops.stabnet.warp_uint8_cf_lowres`
(K1) as the live engine does; serving from the artifact needs the port's
package for those two ops and nothing of its model code or checkpoints.

A program is traced once, on the engine's device; `export_programs` makes
the program for each other device type asked for (`cuda`, `cpu`: the names
`jax.export` uses) with `torch.export.passes.move_to_device_pass`, which
moves the weights and constants and rewrites the devices baked into the
graph.  The custom ops dispatch on their tensors' device, so a CUDA program
launches K2m and K1 and a CPU program runs their plain versions, wherever
it was traced (the JAX package's multi-platform artifact falls back to the
XLA sampler everywhere instead).

Signatures, with S streams, H x W the model scale and Ho x Wo the output:

  step:    (frames, masks (S, L, H, W) f32, ptr () int64, all_black (S, H, W)
           int32, gray (S, H, W) f32, color (S, Ho, Wo, 3) uint8)
           -> (frames', masks', ptr', all_black', output_gray, black, x_map,
               y_map, warped_color (S, Ho, Wo, 3) uint8)
  segment: (frames, masks, ptr, all_black, gray (S, K, H, W), color
           (S, K, Ho, Wo, 3), valid (S, K) bool)
           -> (warped (S, K, Ho, Wo, 3), frames', masks', ptr', all_black')

`ExportedEngine` serves the loaded programs: on CUDA each replays one
captured CUDA graph (utils/graphs.py) of the step and of the segment, the
counterpart of the JAX package's `jax.jit(exported.call)`; on the CPU the
programs run eagerly.  `load_stream_step` is the plain call, the reference
the graphs are held to.

The artifact file is the JAX package's layout: a magic line, a 4-byte
length, a JSON header (`config`, `out_hw`, `streams`, `refine`,
`platforms`, and with a baked segment `segment`), then the payloads.  Here
each payload is one `torch.export.save`; the header also names its
`format` ("torch.export") and lists under `programs` each device type's
step (and segment) as [offset, length] into the payloads.  A header of the
first layout, one `device` with `step_len`, still loads.
"""

from __future__ import annotations

import io
import json
import types
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.stream.engine import (StepOutput, StreamEngine, StreamState,
                                             _GraphState, _tensor, functional_step,
                                             init_state)
from stabnet_tpu_torch.utils.graphs import GraphCache

FORMAT = "torch.export"
_MAGIC = b"STBX1\n"
PLATFORMS = ("cuda", "cpu")   # the device types a program is made for


class _Step(nn.Module):
    """One serving step of `model` as a pure function of its tensors."""

    def __init__(self, model, cfg: StabNetConfig, refine: int, out_hw: Tuple[int, int]):
        super().__init__()
        self.model, self.cfg, self.refine, self.out_hw = model, cfg, refine, out_hw

    def step(self, state: StreamState, gray, color, valid=None):
        return functional_step(self.model, state, gray, color.permute(0, 3, 1, 2).contiguous(),
                               self.cfg, self.refine, self.out_hw, valid=valid)

    def forward(self, frames, masks, ptr, all_black, gray, color):
        state, out = self.step(StreamState(frames, masks, ptr, all_black), gray, color)
        return (*state, *out[:5])


class _Segment(_Step):
    """K steps unrolled; a stream's state is kept where `valid` is False."""

    def forward(self, frames, masks, ptr, all_black, gray, color, valid):
        state = StreamState(frames, masks, ptr, all_black)
        warped = []
        for k in range(gray.shape[1]):
            state, out = self.step(state, gray[:, k], color[:, k], valid[:, k])
            warped.append(out.warped_color)
        return (torch.stack(warped, dim=1), *state)


def _state_args(cfg: StabNetConfig, streams: int, device) -> tuple:
    state = initial_state(torch.zeros((streams, cfg.height, cfg.width), device=device), cfg)
    return tuple(state)


def _export(module: nn.Module, args: tuple) -> bytes:
    with torch.no_grad():
        # One real call first: the shape-keyed caches of device constants
        # (ops/resize.py, ops/warp.py, ...) then hold real tensors, which the
        # program takes as constants; a first call under the tracer would
        # cache its fake tensors.
        module(*args)
        program = torch.export.export(module, args, strict=False)
    program.example_inputs = None   # zeros of the state's size; not saved
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_stream_step(engine: StreamEngine, out_hw: Tuple[int, int],
                       streams: int = 1) -> bytes:
    """The serving step of `engine` (its weights, refine count and device)
    for `streams` streams at output size `out_hw`, as `torch.export.save`
    bytes."""
    cfg, dev = engine.cfg, engine.device
    Ho, Wo = (int(v) for v in out_hw)
    args = _state_args(cfg, streams, dev) + (
        torch.zeros((streams, cfg.height, cfg.width), device=dev),
        torch.zeros((streams, Ho, Wo, 3), dtype=torch.uint8, device=dev))
    return _export(_Step(engine.model, cfg, engine.refine, (Ho, Wo)), args)


def export_scan_segment(engine: StreamEngine, out_hw: Tuple[int, int], streams: int,
                        segment: int) -> bytes:
    """`segment` serving steps of `engine` unrolled into one program, with
    a (streams, segment) bool `valid` mask (a per-stream prefix, as
    `scan_frames` takes it) applied on the device."""
    if segment < 1:
        raise ValueError(f"segment must be >= 1, got {segment}")
    cfg, dev = engine.cfg, engine.device
    Ho, Wo = (int(v) for v in out_hw)
    S, K = streams, segment
    args = _state_args(cfg, S, dev) + (
        torch.zeros((S, K, cfg.height, cfg.width), device=dev),
        torch.zeros((S, K, Ho, Wo, 3), dtype=torch.uint8, device=dev),
        torch.ones((S, K), dtype=torch.bool, device=dev))
    return _export(_Segment(engine.model, cfg, engine.refine, (Ho, Wo)), args)


def check_platforms(platforms: Sequence[str]) -> Tuple[str, ...]:
    """The device types of `export --platforms`, in order, once each;
    raises ValueError on a platform no program can be made for."""
    out = []
    for p in platforms:
        if p == "tpu":
            raise ValueError("the port has no TPU program: a torch.export program "
                             f"runs on {' or '.join(PLATFORMS)}")
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r}; choose from {', '.join(PLATFORMS)}")
        if p not in out:
            out.append(p)
    return tuple(out)


def _moved(data: bytes, device: str):
    """The program of `data` with its weights, constants and the devices
    baked into its graph on `device`."""
    from torch.export.passes import move_to_device_pass

    if device == "cuda" and not torch.cuda.is_available():
        raise ValueError("a cuda program is made on a machine with a card: "
                         "torch.cuda.is_available() is False here")
    return move_to_device_pass(torch.export.load(io.BytesIO(data)), device)


def export_programs(data: bytes, traced: str, platforms: Sequence[str]) -> Dict[str, bytes]:
    """The program `data`, traced on device type `traced`, for each of
    `platforms`: the traced one as it is, every other moved."""
    out = {}
    for p in check_platforms(platforms):
        if p == traced:
            out[p] = data
            continue
        buf = io.BytesIO()
        torch.export.save(_moved(data, p), buf)
        out[p] = buf.getvalue()
    return out


def _load_program(data: bytes):
    # The program's kernels are the port's custom ops: registered on import.
    from stabnet_tpu_torch.ops import cuda_warp  # noqa: F401

    return torch.export.load(io.BytesIO(data)).module()


def load_stream_step(data: bytes):
    """A step artifact's payload -> callable (state, gray, color) ->
    (state, StepOutput), on the device the program was traced on."""
    fn = _load_program(data)

    def step(state: StreamState, gray: torch.Tensor, color: torch.Tensor):
        with torch.no_grad():
            res = fn(*state, gray, color)
        return StreamState(*res[:4]), StepOutput(*res[4:], input_gray=gray)

    return step


def initial_state(first_gray: torch.Tensor, cfg: StabNetConfig) -> StreamState:
    """The warm-up state of an exported step: `init_state` with its ring
    pointer as a 0-d int64 tensor on the frames' device."""
    state = init_state(first_gray, cfg)
    return state._replace(ptr=torch.tensor(state.ptr, dtype=torch.int64,
                                           device=first_gray.device))


# -- self-describing artifact files -------------------------------------------

def save_artifact(path: str, programs: Dict[str, Tuple[bytes, Optional[bytes]]],
                  cfg: StabNetConfig, out_hw: Tuple[int, int], streams: int, refine: int,
                  segment: Optional[int] = None) -> None:
    """Write each device type's (step, segment or None) programs behind the
    JSON header that lets a serving process rebuild the run from the file."""
    meta = {"format": FORMAT, "platforms": list(programs), "config": cfg.name,
            "out_hw": [int(out_hw[0]), int(out_hw[1])], "streams": int(streams),
            "refine": int(refine), "programs": {}}
    payload = []
    off = 0
    for device, parts in programs.items():
        entry = {}
        for name, data in zip(("step", "segment"), parts):
            if data is None:
                continue
            entry[name] = [off, len(data)]
            payload.append(data)
            off += len(data)
        meta["programs"][device] = entry
    if any("segment" in e for e in meta["programs"].values()):
        if not segment or segment < 1:
            raise ValueError("a segment program needs its baked segment length")
        meta["segment"] = int(segment)
    header = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC + len(header).to_bytes(4, "little") + header + b"".join(payload))


def load_artifact(path: str) -> Tuple[bytes, dict]:
    """Read an artifact file -> (payload bytes, header dict), the header of
    the first layout (one `device`) given `platforms` and `programs` too.
    Refuses a file without the header (a bare payload), a JAX package
    artifact and any other format: their bytes are never run."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[: len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not a serving artifact (no header); export it "
                         f"with `stabnet_tpu_torch.cli.main export`")
    n = int.from_bytes(blob[len(_MAGIC): len(_MAGIC) + 4], "little")
    off = len(_MAGIC) + 4
    meta = json.loads(blob[off: off + n])
    fmt = meta.get("format")
    if fmt != FORMAT:
        what = ("a jax.export artifact of the JAX package (serve it with "
                "stabnet_tpu)" if fmt is None else f"format {fmt!r}")
        raise ValueError(f"{path}: {what}; this port serves {FORMAT!r} artifacts only")
    payload = blob[off + n:]
    if "programs" not in meta:
        step_len = meta.get("step_len", len(payload))
        entry = {"step": [0, step_len]}
        if step_len < len(payload):
            entry["segment"] = [step_len, len(payload) - step_len]
        meta["platforms"] = [meta["device"]]
        meta["programs"] = {meta["device"]: entry}
    return payload, meta


def select_program(payload: bytes, meta: dict, device) -> Tuple[bytes, Optional[bytes]]:
    """The (step, segment or None) programs of `device`'s type; raises
    ValueError, naming the artifact's platforms, if it lists none."""
    dev = torch.device(device).type
    if dev not in meta["programs"]:
        platforms = ", ".join(meta["platforms"])
        raise ValueError(f"artifact lowered for {platforms}; current device is {dev}: "
                         f"pass --device {meta['platforms'][0]} or re-export with "
                         f"--platforms {dev}")
    entry = meta["programs"][dev]

    def part(name):
        if name not in entry:
            return None
        off, n = entry[name]
        return payload[off: off + n]

    return part("step"), part("segment")


class _ExportedState(_GraphState):
    """`_GraphState` for the exported programs' state, whose ring pointer
    is a 0-d int64 device tensor: the slots a call wrote are copied back at
    the device pointer, so nothing is read from the device."""

    def store(self, state: StreamState, steps: int) -> StreamState:
        L = state.frames.shape[1]
        own = self.state
        if steps >= L:
            state.frames.copy_(own.frames)
            state.masks.copy_(own.masks)
        else:
            slots = (state.ptr + torch.arange(steps, device=state.ptr.device)) % L
            state.frames.index_copy_(1, slots, own.frames.index_select(1, slots))
            state.masks.index_copy_(1, slots, own.masks.index_select(1, slots))
        state.all_black.copy_(own.all_black)
        self._holds = state._replace(ptr=own.ptr.clone())
        return self._holds


class ExportedEngine:
    """A `StreamDriver` engine backed by an artifact's programs for one
    device (`from_artifact`): `stabilize --from-export`.  It serves the
    production path only: the history ablations and the device gray need a
    live engine, and the stream count and segment length are the baked
    ones.  Color frames of another size are resized on the host to the
    baked `out_hw`.  `continue_clip` exists only when a segment is baked
    (the driver's chunked and streaming modes look for it).

    A step (and a segment) runs the loaded program on state buffers the
    engine holds (`_ExportedState`), through `graphs`: on CUDA one captured
    CUDA graph of the step and one of the segment (the JAX package's
    `jax.jit(exported.call)`, stabnet_tpu/stream/export.py:159-164),
    captured at the first call, which runs eagerly, with the frames going
    in through pinned stages; on the CPU the program itself.  The program
    is functional; the captured body copies its new state back into the
    held buffers, and, as in the live engine, the ring slots a call wrote
    are copied into the given state's tensors, which the returned state
    shares.  The outputs are copied out of the graph's buffers, so each
    stays valid.  The values are the program's (`load_stream_step`) bit
    for bit.
    """

    def __init__(self, data: bytes, cfg: StabNetConfig, out_hw: Tuple[int, int],
                 streams: int = 1, scan_data: Optional[bytes] = None,
                 segment: Optional[int] = None, device=None):
        from stabnet_tpu_torch.utils import resolve_device

        self.device = resolve_device(device)
        self.cfg = cfg
        self.out_hw = (int(out_hw[0]), int(out_hw[1]))
        self.streams = int(streams)
        self._step = _load_program(data)
        self._scan = _load_program(scan_data) if scan_data else None
        self.segment = int(segment) if scan_data else None
        self.graphs = GraphCache(shared_pool=True)
        self._state = _ExportedState(self.streams, cfg, self.device)
        if self._scan is not None:
            self.continue_clip = self._continue_clip

    @classmethod
    def from_artifact(cls, payload: bytes, meta: dict, device=None) -> "ExportedEngine":
        """The engine of `load_artifact`'s result on `device` (CUDA unless
        the CPU is asked for), from the artifact's program for its type."""
        from stabnet_tpu_torch.config import get_config

        step, scan = select_program(payload, meta, "cuda" if device is None else device)
        return cls(step, get_config(meta["config"]), meta["out_hw"], streams=meta["streams"],
                   scan_data=scan, segment=meta.get("segment"), device=device)

    def _check_streams(self, S: int) -> None:
        if S != self.streams:
            raise ValueError(f"artifact baked for {self.streams} streams, got {S}; "
                             f"re-export with --streams {S}")

    def _resize(self, color: np.ndarray) -> np.ndarray:
        """(..., H, W, 3) -> (..., Ho, Wo, 3) on the host where sizes differ."""
        color = np.asarray(color)
        if color.shape[-3:-1] == self.out_hw:
            return color
        from stabnet_tpu_torch.stream.driver import StreamDriver

        flat = color.reshape((-1,) + color.shape[-3:])
        out = np.stack([StreamDriver._resize_color(f, self.out_hw) for f in flat])
        return out.reshape(color.shape[:-3] + out.shape[1:])

    def _call(self, state: StreamState, kind: str, program, inputs, steps: int):
        """`program(*held state, *inputs)` through the graph of `kind` and
        the inputs' shapes: the new state written back into the held
        buffers inside the call; returns (the outputs copied out, `state`
        advanced by `steps`)."""
        own = self._state.state

        def fn(*args):
            res = program(*own, *args)
            if kind == "step":   # the step's gray is its output's input_gray
                new, outs = res[:4], (*res[4:], args[0])
            else:
                new, outs = res[1:], res[:1]
            for dst, src in zip(own, new):
                dst.copy_(src)
            return outs

        with torch.inference_mode(), self.graphs.lock:
            self._state.load(state)
            outs = self.graphs(kind, fn, inputs, self.device)
            return tuple(t.clone() for t in outs), self._state.store(state, steps)

    def init(self, first_gray: np.ndarray) -> StreamState:
        self._check_streams(len(first_gray))
        return initial_state(_tensor(first_gray).to(self.device), self.cfg)

    def step(self, state: StreamState, cur_gray: Optional[np.ndarray], cur_color: np.ndarray,
             history_override: Optional[np.ndarray] = None):
        if history_override is not None:
            raise ValueError(
                "exported artifacts serve the production streaming path; "
                "--infer-with-*/--max-span/--random-black need a live engine "
                "(--model-dir/--tf-checkpoint/--weights)")
        if cur_gray is None:
            raise ValueError("--device-gray needs a live engine: the artifact's step "
                             "takes the model-scale gray as an input")
        self._check_streams(len(cur_color))
        outs, state = self._call(state, "step", self._step,
                                 (_tensor(cur_gray), _tensor(self._resize(cur_color))), 1)
        return state, StepOutput(*outs)

    def _continue_clip(self, state: StreamState, clip_gray: np.ndarray,
                       clip_color: np.ndarray, valid: Optional[np.ndarray] = None):
        """One baked-size segment from `state`: clip_gray (S, K, H, W),
        clip_color (S, K, Ho, Wo, 3), valid (S, K) prefix mask (None: all
        valid).  Returns (warped (S, K, Ho, Wo, 3), new state)."""
        S, K = clip_gray.shape[:2]
        if (S, K) != (self.streams, self.segment):
            raise ValueError(
                f"artifact segment baked for (streams, segment) = ({self.streams}, "
                f"{self.segment}), got ({S}, {K}); serve groups of {self.streams} "
                f"streams in {self.segment}-frame segments, or re-export with "
                f"--streams/--segment")
        valid = np.ones((S, K), bool) if valid is None else np.asarray(valid, bool)
        (warped,), state = self._call(
            state, "segment", self._scan,
            (_tensor(clip_gray), _tensor(self._resize(clip_color)), _tensor(valid)), K)
        return warped, state

    def stabilize_clip(self, clip_gray: np.ndarray, clip_color: np.ndarray,
                       valid: Optional[np.ndarray] = None):
        """Whole clips, as `StreamEngine.stabilize_clip` takes and returns
        them: on the baked segment (the tail padded with invalid repeats of
        the last frame), else step by step with each stream's crop
        accumulator kept at its clip's end (`valid`'s prefix length)."""
        S, T = clip_gray.shape[:2]
        self._check_streams(S)
        v_full = (np.ones((S, T - 1), bool) if valid is None
                  else np.asarray(valid, bool))
        state = self.init(clip_gray[:, 0])
        if self._scan is not None:
            K, chunks, t = self.segment, [], 1
            while t < T:
                k = min(K, T - t)
                g, c, v = clip_gray[:, t:t + k], clip_color[:, t:t + k], v_full[:, t - 1:t - 1 + k]
                if k < K:
                    g = np.concatenate([g, np.repeat(g[:, -1:], K - k, axis=1)], axis=1)
                    c = np.concatenate([c, np.repeat(c[:, -1:], K - k, axis=1)], axis=1)
                    v = np.pad(v, [[0, 0], [0, K - k]])
                warped, state = self._continue_clip(state, g, c, v)
                chunks.append(warped[:, :k])
                t += k
            return torch.cat(chunks, dim=1), state
        # Each stream's last valid step, on the device once per clip.
        ends = torch.as_tensor(v_full.sum(axis=1)).to(self.device)
        frozen = torch.zeros_like(state.all_black)
        warped = []
        for t in range(1, T):
            state, out = self.step(state, clip_gray[:, t], clip_color[:, t])
            warped.append(out.warped_color)
            frozen = torch.where((ends == t)[:, None, None], state.all_black, frozen)
        return torch.stack(warped, dim=1), types.SimpleNamespace(all_black=frozen)
