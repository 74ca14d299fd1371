"""Checkpoints of the training state (reference: `tf.train.Saver`,
train_bundle_nobm.py:195,204-208,271-272).

`<model_dir>/<step>/state.pt` holds the step, the model's parameters and BN
statistics (its state_dict) and the optimizer's moments, written with
`torch.save`; the five newest are kept, as the JAX package's Orbax manager
keeps them.  The ImageNet transfer restore (`transfer_from_imagenet`) waits
for the port's `compat/` slice.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import List, Optional

import torch

from stabnet_tpu_torch.train.state import TrainState

logger = logging.getLogger("stabnet_tpu_torch")

MAX_TO_KEEP = 5
_FILE = "state.pt"


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.isfile(os.path.join(directory, d, _FILE)))


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpointed step in `directory`, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def save(directory: str, state: TrainState) -> str:
    """Write `state` as `<directory>/<step>/state.pt` (through a temporary
    file, so a crash leaves no half checkpoint) and drop all but the newest
    MAX_TO_KEEP; returns the step directory."""
    step_dir = os.path.join(os.path.abspath(directory), str(state.step))
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, _FILE)
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "opt": state.opt.state_dict()}, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(directory, str(old)))
    logger.info("saved checkpoint step=%d to %s", state.step, directory)
    return step_dir


def restore(directory: str, state: TrainState) -> TrainState:
    """Load the newest checkpoint of `directory` into `state` (in place:
    model, optimizer and step); raises FileNotFoundError if there is none."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    dev = next(state.model.parameters()).device
    ckpt = torch.load(os.path.join(directory, str(step), _FILE),
                      map_location=dev, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.opt.load_state_dict(ckpt["opt"])
    state.step = int(ckpt["step"])
    logger.info("restored checkpoint step=%d from %s", step, directory)
    return state
