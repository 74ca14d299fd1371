"""Host -> device input pipeline (PyTorch port of stabnet_tpu/data/pipeline.py).

  host thread: shard read -> batch raw examples -> upload -> augmentation
               [-> TV-L1 flow] (both run on the device, enqueued from the
               thread)
  main thread: train steps

with a small bounded queue between the two, so batch N+1's read, upload and
augmentation overlap step N.  Both threads enqueue on the device's default
stream, so a batch is complete before any step reads it.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.data import augment
from stabnet_tpu_torch.data.records import iterate_examples
from stabnet_tpu_torch.ops import flow as flow_ops
from stabnet_tpu_torch.utils import resolve_device


def batch_iterator(path: str, cfg: StabNetConfig, seed: int = 0,
                   batch_size: Optional[int] = None,
                   shard: Optional[Tuple[int, int]] = None
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield raw host batches of `batch_size` (default cfg.batch_size)
    examples, shuffled, epoch after epoch; `shard` as `iterate_examples`
    takes it."""
    batch_size = batch_size or cfg.batch_size
    buf = []
    for ex in iterate_examples(path, epochs=10 ** 6, shuffle=True, seed=seed, shard=shard):
        buf.append(ex)
        if len(buf) == batch_size:
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


def ensure_flow(raw: Dict[str, np.ndarray], compute_flow: bool = False
                ) -> Dict[str, np.ndarray]:
    """Check the raw batch's flow field ahead of the upload.  With
    `compute_flow` the record flow (if any) is dropped, so the batch never
    pays its upload and augmentation: the TV-L1 estimate replaces it."""
    if compute_flow:
        raw.pop("flow", None)
        return raw
    if "flow" not in raw:
        raise ValueError(
            "record shards have no `flow` field; train with --compute-flow "
            "(on-device TV-L1) or bake flow into the shards")
    return raw


def add_flow(batch: Dict[str, torch.Tensor], want_flow: bool = True
             ) -> Dict[str, torch.Tensor]:
    """Set batch["flow"] to the TV-L1 flow between the augmented stable pair,
    in the records' sampling convention; with `want_flow` False (the
    temporal loss's gate still closed) to the zero-motion sampling map
    instead, without the solve."""
    y1 = batch["y1"][..., 0]
    if want_flow:
        u = flow_ops.tvl1_flow(y1, batch["y2"][..., 0])
    else:
        u = torch.zeros(y1.shape + (2,), dtype=torch.float32, device=y1.device)
    batch["flow"] = flow_ops.flow_to_sampling(u)
    return batch


class InputPipeline:
    """Raw record batches -> augmented batches on `device`, ready for
    `train_step`.  Reading, upload and augmentation run in the prefetch
    thread.  `start_step` (the restored step when resuming) is folded into
    the shuffle order and the augmentation generator's seed, so a resumed
    run continues with a fresh stream rather than replaying its head.

    `compute_flow` replaces (or supplies, for shards without a `flow`
    field) the record flow with TV-L1 flow on the device between the
    AUGMENTED stable pair, computed in the prefetch thread.  Batches
    consumed before step `flow_from_step` (batch n feeds step
    `start_step + n`) carry the zero-motion map instead: the temporal loss
    that reads the flow is gated to zero until `cfg.do_temp_loss_iter`.

    `shard=(rank, world)` makes it one rank's pipeline of data-parallel
    training (parallel/multihost.py): the rank's residue class of the
    records, and its slice of the draws of the global batch of
    `batch_size * world` examples."""

    def __init__(self, path: str, cfg: StabNetConfig, seed: int = 0,
                 start_step: int = 0, device=None, compute_flow: bool = False,
                 flow_from_step: int = 0, batch_size: Optional[int] = None,
                 shard: Tuple[int, int] = (0, 1)):
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed * 1_000_003 + start_step)

        def device_batches():
            for n, raw in enumerate(batch_iterator(path, cfg, seed=seed + start_step,
                                                   batch_size=batch_size, shard=shard)):
                raw = augment.prepare_raw(ensure_flow(raw, compute_flow))
                batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
                batch = augment.augment_batch(gen, batch, cfg, part=shard)
                if compute_flow:
                    batch = add_flow(batch, start_step + n >= flow_from_step)
                yield batch

        self._it = prefetch(device_batches())

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def close(self) -> None:
        """Stop the prefetch thread (it finishes the batch in hand)."""
        self._it.close()
