"""Online streaming stabilization (PyTorch port of stabnet_tpu.stream)."""

from stabnet_tpu_torch.stream.driver import ClipResult, DeployOptions, StreamDriver
from stabnet_tpu_torch.stream.engine import (
    StepOutput,
    StreamEngine,
    StreamState,
    crop_rectangle,
    init_state,
    scan_frames,
    stabilize_clip_device,
    stream_step,
)
