"""Training driver: the loop with eval, checkpoints and metrics.

Reference: train_bundle_nobm.py:199-357 — per-100-iteration loss display
with the data-read vs. train-time split, per-500-iteration held-out eval
over 10 batches, per-5000-iteration checkpoints; the JAX package's
stabnet_tpu/train/loop.py.  The steps are the compiled ones
(`make_train_step`, `make_eval_step`: captured CUDA graphs on the card,
alone or as an NCCL rank; the eager steps on the CPU and under gloo), built
once per run.  In a process group (data parallelism,
parallel/multihost.py) every rank steps, and rank 0 alone logs, writes the
metrics and saves checkpoints while the others wait at a barrier.  With
`debug_vis`, rank 0 also dumps the reference's debug mosaics
(train_bundle_nobm.py:41-94) from a forward in eval mode.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional

import numpy as np

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.parallel.multihost import barrier, process_index_count
from stabnet_tpu_torch.train import checkpoint as ckpt
from stabnet_tpu_torch.train.state import create_train_state
from stabnet_tpu_torch.train.train import make_eval_step, make_train_step
from stabnet_tpu_torch.utils import get_logger
from stabnet_tpu_torch.utils.profiling import StageTimer

logger = get_logger()


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

    def add_image(self, step: int, tag: str, image_bgr: np.ndarray) -> None:
        """Log an (H, W, 3) uint8 BGR image, as RGB (no-op without
        TensorBoard)."""
        if self._tb is not None:
            self._tb.add_image(tag, image_bgr[..., ::-1], step, dataformats="HWC")

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def _debug_dump(state, batch, cfg: StabNetConfig, step: int,
                metrics: MetricsWriter) -> None:
    """Branch 1's forward on `batch["x1"]` with the model in eval mode, its
    mosaics under `<log_dir>/debug` and the first to TensorBoard (reference:
    save_warpped_features, train_bundle_nobm.py:41-94,306,321).

    Eval mode reads BatchNorm's running statistics and changes nothing: in
    training mode the forward would update them, and in a process group
    reduce them over the ranks, which this rank alone would wait for.  It
    draws from no generator, so the training run is bit for bit the same
    with and without the dump.  On CUDA the warp is one K2m launch.  It runs
    eagerly, as the JAX package's dump does (it is not jitted there)."""
    from stabnet_tpu_torch.models.stabnet import forward
    from stabnet_tpu_torch.train.visualize import save_debug_batch

    model = state.model.eval()
    try:
        out1 = forward(model, batch["x1"], cfg)
    finally:
        model.train()
    mosaics = save_debug_batch(os.path.join(cfg.log_dir, "debug"), batch, out1, cfg, step)
    if mosaics:
        metrics.add_image(step, "debug/mosaic", mosaics[0])


def train(cfg: StabNetConfig, train_batches: Iterator,
          test_batches: Optional[Iterator] = None, restore: bool = False,
          num_steps: Optional[int] = None, seed: int = 0,
          tensorboard: bool = False, device=None,
          imagenet_ckpt: Optional[str] = None, debug_vis: bool = False):
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
    (train_bundle_nobm.py:184-191,208).  With `debug_vis`, rank 0 writes
    debug mosaics every `test_freq` steps and at the last (`_debug_dump`).
    `device` defaults to CUDA.
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
    main = process_index_count()[0] == 0
    metrics = MetricsWriter(cfg.log_dir, tensorboard=tensorboard) if main else None
    timers = StageTimer("train.")
    train_step, eval_step = make_train_step(cfg), make_eval_step(cfg)
    total = num_steps if num_steps is not None else cfg.training_iter
    aux = None
    try:
        for i in range(state.step, total):
            with timers.stage("data"):
                batch = next(train_batches)
            with timers.stage("step"):
                state, aux = train_step(state, batch)

            if i % cfg.disp_freq == 0 or i == total - 1:
                if main:
                    vals = {k: float(v) for k, v in aux.items()}
                    s = timers.summary()
                    data_ms, step_ms = s["data"]["mean_ms"], s["step"]["mean_ms"]
                    logger.info(
                        "iter %d total=%.5f img=%.5f temp=%.5f (data %.1fms step %.1fms)",
                        i, vals["total"], vals["img1"], vals["temp"], data_ms, step_ms)
                    metrics.write(i, "train", {**vals, "data_ms": data_ms,
                                               "step_ms": step_ms})
                timers.reset()

            if debug_vis and main and (i % cfg.test_freq == 0 or i == total - 1):
                _debug_dump(state, batch, cfg, i, metrics)

            if test_batches is not None and (i % cfg.test_freq == 0 or i == total - 1):
                test_loss = float(np.mean([
                    float(eval_step(state, next(test_batches))["total"])
                    for _ in range(cfg.test_batches)]))
                if main:
                    logger.info("iter %d test_loss=%.5f", i, test_loss)
                    metrics.write(i, "test", {"total": test_loss})

            # Always save at the final step (even step 0 of a 1-step run:
            # save/restore chains rely on every segment ending checkpointed).
            if (i > 0 and i % cfg.save_freq == 0) or i == total - 1:
                if main:
                    ckpt.save(cfg.model_dir, state)
                barrier()
    finally:
        # Flush partial metrics even when a step raises.
        if metrics is not None:
            metrics.close()
    return state, aux
