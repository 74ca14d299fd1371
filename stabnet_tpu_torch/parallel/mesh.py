"""Data parallelism's device layer (the PyTorch port of
stabnet_tpu/parallel/mesh.py).

The JAX package builds a 1-D mesh over every device of one process and lets
XLA shard the batch on axis 0, with the parameters replicated.  Eager
PyTorch has no such single program over several cards, so the port keeps
the two halves apart: training runs one process per card and averages
gradients over `torch.distributed` (parallel/multihost.py), and batch
serving keeps one replica of the model per device and splits the clips
(`StreamEngine.stabilize_clips_sharded`).  The names follow the JAX
package's where they name the same thing.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch


def data_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of the data axis: the given ones (CPU devices too, for
    the tests; one device may be named twice, for two replicas on it), or
    every local CUDA device.  Raises without CUDA when none are given."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("an empty device list")
        return devs
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices=['cpu', ...] to "
                           "shard over CPU replicas")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_batch(batch, devices: Sequence[torch.device]):
    """Split axis 0 of `batch` (an array, a tensor, or a dict of them) into
    len(devices) equal shards, each moved to its device; returns the list
    of shards (of dicts for a dict).  The JAX package's `shard_batch` puts
    one sharded array instead."""
    if isinstance(batch, dict):
        parts = {k: shard_batch(v, devices) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(len(devices))]
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(np.asarray(batch))
    if t.shape[0] % len(devices):
        raise ValueError(f"a batch of {t.shape[0]} does not split over "
                         f"{len(devices)} devices")
    return [part.to(d) for part, d in zip(t.chunk(len(devices)), devices)]


def replicated(module: torch.nn.Module, devices: Sequence[torch.device]
               ) -> List[torch.nn.Module]:
    """One replica of `module` per device (its own copy of the weights,
    made outside inference mode so they stay parameters): the JAX package's
    replicated sharding, for eager serving."""
    with torch.inference_mode(False):
        return [copy.deepcopy(module).to(d) for d in devices]
