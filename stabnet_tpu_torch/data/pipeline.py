"""Host -> device input pipeline (PyTorch port of stabnet_tpu/data/pipeline.py).

  host thread: shard read -> batch raw examples -> upload -> augmentation
               (the augmentation runs on the device, enqueued from the
               thread)
  main thread: train steps

with a small bounded queue between the two, so batch N+1's read, upload and
augmentation overlap step N.  Both threads enqueue on the device's default
stream, so a batch is complete before any step reads it.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.data import augment
from stabnet_tpu_torch.data.records import iterate_examples
from stabnet_tpu_torch.utils import resolve_device


def batch_iterator(path: str, cfg: StabNetConfig,
                   seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yield raw host batches of cfg.batch_size examples, shuffled, epoch
    after epoch."""
    buf = []
    for ex in iterate_examples(path, epochs=10 ** 6, shuffle=True, seed=seed):
        buf.append(ex)
        if len(buf) == cfg.batch_size:
            yield {k: np.stack([e[k] for e in buf]) for k in buf[0]}
            buf = []


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue.  Worker
    exceptions re-raise in the consumer (the worker also enqueues device
    work, so its failures must not turn into a silent StopIteration).
    Closing the returned generator stops the worker and waits for it."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(done)
        except BaseException as e:  # noqa: BLE001 - transported to the consumer
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()


def ensure_flow(raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Check that the raw batch carries its flow field."""
    if "flow" not in raw:
        raise ValueError(
            "record shards have no `flow` field; bake flow into the shards "
            "(on-device TV-L1 flow, `train --compute-flow`, comes with the "
            "port's flow slice)")
    return raw


class InputPipeline:
    """Raw record batches -> augmented batches on `device`, ready for
    `train_step`.  Reading, upload and augmentation run in the prefetch
    thread.  `start_step` (the restored step when resuming) is folded into
    the shuffle order and the augmentation generator's seed, so a resumed
    run continues with a fresh stream rather than replaying its head."""

    def __init__(self, path: str, cfg: StabNetConfig, seed: int = 0,
                 start_step: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed * 1_000_003 + start_step)

        def device_batches():
            for raw in batch_iterator(path, cfg, seed=seed + start_step):
                raw = augment.prepare_raw(ensure_flow(raw))
                batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
                yield augment.augment_batch(gen, batch, cfg)

        self._it = prefetch(device_batches())

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def close(self) -> None:
        """Stop the prefetch thread (it finishes the batch in hand)."""
        self._it.close()
