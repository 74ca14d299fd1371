"""Checkpoints of the training state (reference: `tf.train.Saver`,
train_bundle_nobm.py:195,204-208,271-272).

`<model_dir>/<step>/state.pt` holds the step, the model's parameters and BN
statistics (its state_dict) and the optimizer's moments, written with
`torch.save`; the five newest are kept, as the JAX package's Orbax manager
keeps them.  `load_model_state` reads the model part alone, for serving.
`transfer_from_imagenet` is the cold-start transfer restore of an ImageNet
ResNet-v2-50 that keeps the 13-channel conv1 and the head
(train_bundle_nobm.py:101-102,184-191).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import torch

from stabnet_tpu_torch.train.state import TrainState
from stabnet_tpu_torch.utils import get_logger

logger = get_logger()

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


def load_model_state(directory: str) -> Dict[str, torch.Tensor]:
    """The model's state_dict from the newest checkpoint of `directory`, on
    the CPU; raises FileNotFoundError if there is none."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    ckpt = torch.load(os.path.join(directory, str(step), _FILE),
                      map_location="cpu", weights_only=True)
    logger.info("loaded model of checkpoint step=%d from %s", step, directory)
    return ckpt["model"]


_TRUNK = "resnet_v2_50."
_STATS = ("running_mean", "running_var")


def _trunk_units(state: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, Dict]]:
    """{collection: {unit: {leaf path: shape}}} of the `resnet_v2_50.*`
    keys, with the Flax collections: BN running statistics are
    "batch_stats", everything else "params"."""
    units: Dict[str, Dict[str, Dict]] = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        if not key.startswith(_TRUNK):
            continue
        unit, _, leaf = key[len(_TRUNK):].partition(".")
        collection = "batch_stats" if leaf.endswith(_STATS) else "params"
        units[collection].setdefault(unit, {})[leaf] = tuple(value.shape)
    return units


def transfer_from_imagenet(model_state: Dict[str, torch.Tensor],
                           trunk_state: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """Graft pretrained trunk weights, keeping the 13-channel stem and the
    head as they are.

    Args:
      model_state: the StabNet regressor's state_dict.
      trunk_state: `resnet_v2_50.*` entries of a trunk with a 3-channel stem
        (`compat.convert_imagenet_checkpoint`).  The reference's
        `get_variables_to_restore` selects MODEL variables, which include the
        BN moving mean and variance, so the statistics transfer too.

    Returns:
      a new state_dict with every trunk unit except `conv1` replaced.

    Raises:
      KeyError / ValueError on a missing, extra or misshapen unit (a wrong
      pretrained checkpoint must fail loudly, not train from garbage), with
      the JAX package's messages (stabnet_tpu/train/checkpoint.py:57-112).
    """
    have, src = _trunk_units(model_state), _trunk_units(trunk_state)
    for collection in ("params", "batch_stats"):
        # Both directions must fail loudly: extra pretrained units mean the
        # wrong checkpoint; MISSING ones would leave model blocks randomly
        # initialized (a truncated or smaller resnet).
        missing = set(have[collection]) - set(src[collection]) - {"conv1"}
        if missing:
            raise KeyError(
                f"pretrained checkpoint lacks {collection} for model trunk "
                f"unit(s) {sorted(missing)}; wrong checkpoint?")
        for unit, shapes in src[collection].items():
            if unit == "conv1":
                continue  # the 13-channel stem stays as it is
            if unit not in have[collection]:
                raise KeyError(
                    f"pretrained trunk has {collection}/{unit!r} but the model "
                    f"does not; wrong checkpoint?")
            if have[collection][unit] != shapes:
                raise ValueError(
                    f"shape mismatch grafting {collection}/{unit}: "
                    f"model {have[collection][unit]} vs pretrained {shapes}")
    out = dict(model_state)
    for key, value in trunk_state.items():
        if key.startswith(_TRUNK) and not key.startswith(_TRUNK + "conv1."):
            out[key] = value.detach().clone()
    return out
