"""Online streaming stabilization (PyTorch port of stabnet_tpu.stream)."""

from stabnet_tpu_torch.stream.driver import ClipResult, DeployOptions, StreamDriver
from stabnet_tpu_torch.stream.engine import (
    StepOutput,
    StreamEngine,
    StreamState,
    assemble_input,
    crop_rectangle,
    init_state,
    scan_frames,
    stabilize_clip_device,
    stream_step,
    warp_color,
)

__all__ = [
    "ClipResult",
    "DeployOptions",
    "StepOutput",
    "StreamDriver",
    "StreamEngine",
    "StreamState",
    "assemble_input",
    "crop_rectangle",
    "init_state",
    "scan_frames",
    "stabilize_clip_device",
    "stream_step",
    "warp_color",
]
