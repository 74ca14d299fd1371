"""Training driver: the loop with eval, checkpoints and metrics.

Reference: train_bundle_nobm.py:199-357 — per-100-iteration loss display
with the data-read vs. train-time split, per-500-iteration held-out eval
over 10 batches, per-5000-iteration checkpoints; the JAX package's
stabnet_tpu/train/loop.py.  Data parallelism and the debug mosaics come
with later slices of the port.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Iterator, Optional

import numpy as np

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.train import checkpoint as ckpt
from stabnet_tpu_torch.train.state import create_train_state
from stabnet_tpu_torch.train.train import eval_step, train_step
from stabnet_tpu_torch.utils.profiling import StageTimer

logger = logging.getLogger("stabnet_tpu_torch")


class MetricsWriter:
    """Scalar metrics to `log_dir/metrics.jsonl`, optionally mirrored to
    TensorBoard event files under `log_dir/tb` (the reference's
    observability plane, train_bundle_nobm.py:128-153)."""

    def __init__(self, log_dir: str, tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                logger.warning("tensorboard writer unavailable; scalars go to "
                               "JSONL only")
            else:
                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def write(self, step: int, tag: str, values: Dict[str, float]) -> None:
        self._f.write(json.dumps({"step": step, "tag": tag, **values}) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{tag}/{k}", v, step)
            self._tb.flush()   # disp_freq-paced: keep the tail of a crashed run

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def train(cfg: StabNetConfig, train_batches: Iterator,
          test_batches: Optional[Iterator] = None, restore: bool = False,
          num_steps: Optional[int] = None, seed: int = 0,
          tensorboard: bool = False, device=None,
          imagenet_ckpt: Optional[str] = None):
    """Run training to step `num_steps` (default cfg.training_iter); returns
    (final TrainState, the last step's loss terms).

    Logs the loss terms and the mean "data" and "step" stage times since
    the last log every `disp_freq` steps and at the last, evaluates on
    `cfg.test_batches` batches of `test_batches` every `test_freq` steps and
    at the last, saves every `save_freq` steps and always at the last, and
    with `restore` resumes from the newest checkpoint in cfg.model_dir
    (reference: --restore, train_bundle_nobm.py:36,204-206).  Without
    `restore`, `imagenet_ckpt` (slim's ImageNet resnet_v2_50 checkpoint)
    grafts its trunk onto the fresh model, conv1 and the head kept
    (train_bundle_nobm.py:184-191,208).  `device` defaults to CUDA.
    """
    state = create_train_state(cfg, device=device, seed=seed)
    if restore:
        state = ckpt.restore(cfg.model_dir, state)
    elif imagenet_ckpt:
        from stabnet_tpu_torch.compat import convert_imagenet_checkpoint

        state.model.load_state_dict(ckpt.transfer_from_imagenet(
            state.model.state_dict(), convert_imagenet_checkpoint(imagenet_ckpt)))
        logger.info("transferred ImageNet trunk from %s (conv1 + head kept "
                    "random)", imagenet_ckpt)
    metrics = MetricsWriter(cfg.log_dir, tensorboard=tensorboard)
    timers = StageTimer()
    total = num_steps if num_steps is not None else cfg.training_iter
    aux = None
    try:
        for i in range(state.step, total):
            with timers.stage("data"):
                batch = next(train_batches)
            with timers.stage("step"):
                state, aux = train_step(state, batch, cfg)

            if i % cfg.disp_freq == 0 or i == total - 1:
                vals = {k: float(v) for k, v in aux.items()}
                s = timers.summary()
                data_ms, step_ms = s["data"]["mean_ms"], s["step"]["mean_ms"]
                logger.info(
                    "iter %d total=%.5f img=%.5f temp=%.5f (data %.1fms step %.1fms)",
                    i, vals["total"], vals["img1"], vals["temp"], data_ms, step_ms)
                metrics.write(i, "train", {**vals, "data_ms": data_ms,
                                           "step_ms": step_ms})
                timers.reset()

            if test_batches is not None and (i % cfg.test_freq == 0 or i == total - 1):
                test_loss = float(np.mean([
                    float(eval_step(state, next(test_batches), cfg)["total"])
                    for _ in range(cfg.test_batches)]))
                logger.info("iter %d test_loss=%.5f", i, test_loss)
                metrics.write(i, "test", {"total": test_loss})

            # Always save at the final step (even step 0 of a 1-step run:
            # save/restore chains rely on every segment ending checkpointed).
            if (i > 0 and i % cfg.save_freq == 0) or i == total - 1:
                ckpt.save(cfg.model_dir, state)
    finally:
        # Flush partial metrics even when a step raises.
        metrics.close()
    return state, aux
