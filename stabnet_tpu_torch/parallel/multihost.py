"""Data-parallel training over processes (the PyTorch port of
stabnet_tpu/parallel/multihost.py).

One process per card, launched by `python -m torch.distributed.run`, or
given its rank, world size and rendezvous address.  Each process

  1. reads the DISJOINT residue class `shard=(rank, world)` of the same
     shuffled example stream (`records.iterate_examples(shard=...)`),
  2. builds its local slice of the global batch, global / world examples,
     and augments it on its own device with the draws of the GLOBAL batch
     (one generator, seeded alike on every rank; each rank takes its slice),
  3. runs the train step on it; BatchNorm reduces its statistics over the
     ranks (models/resnet.py) and the gradients are averaged over them
     after the backward (`average_gradients`).

So the ranks together train on exactly what one process trains on with the
merged batch (`form_global_batch`: rank 0's examples first, as JAX's
`make_array_from_process_local_data` lays them out).  Without a process
group every function here is the single-process identity.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.data.pipeline import InputPipeline


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group; returns whether one is active.

    A no-op (False) unless explicit arguments or the environment of
    `torch.distributed.run` (RANK, WORLD_SIZE, MASTER_ADDR) say where to
    meet, so single-process runs never pay a rendezvous; idempotent.
    `backend` defaults to NCCL where CUDA is available and gloo elsewhere.
    `coordinator_address` is "host:port".
    """
    if dist.is_initialized():
        return True
    from_env = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if coordinator_address is None and num_processes is None and not from_env:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is None and num_processes is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("initialize_distributed: give the coordinator address, "
                             "the number of processes and this process's id together")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
    return True


def process_index_count() -> Tuple[int, int]:
    """(rank, world size): (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_size(global_batch_size: int) -> int:
    """This process's share of the global batch."""
    count = process_index_count()[1]
    if global_batch_size % count:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{count} processes")
    return global_batch_size // count


def form_global_batch(local_batches: Sequence[Dict[str, np.ndarray]]
                      ) -> Dict[str, np.ndarray]:
    """The global batch of the ranks' local batches, one process's
    reference for what the ranks train on together: rank 0's examples
    first, then rank 1's, and so on."""
    return {k: np.concatenate([b[k] for b in local_batches]) for k in local_batches[0]}


def average_gradients(params: List[torch.nn.Parameter]) -> None:
    """Replace each gradient by its mean over the ranks: one all-reduce of
    the flattened gradients, divided by the world size (exact for one
    rank).  A no-op without a process group."""
    if not dist.is_available() or not dist.is_initialized():
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    for p, g in zip(params, flat.split([q.numel() for q in params])):
        p.grad = g.view_as(p)


def mean_over_ranks(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalars averaged over the ranks (the global batch's loss terms,
    since each is a batch mean over equal local batches); unchanged without
    a process group."""
    if not dist.is_available() or not dist.is_initialized():
        return values
    keys = sorted(values)
    flat = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    return dict(zip(keys, flat.unbind()))


def barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


class MultiHostPipeline(InputPipeline):
    """`InputPipeline` of one rank: its residue class of the record stream,
    `global_batch_size / world` examples per batch, augmented on `device`
    with its slice of the global batch's draws.

    Every rank must be built with the SAME seed and start_step (the shuffled
    order and the draws are the contract that makes the ranks' batches the
    global batch)."""

    def __init__(self, path: str, cfg: StabNetConfig, seed: int = 0,
                 global_batch_size: Optional[int] = None, start_step: int = 0,
                 device=None, compute_flow: bool = False, flow_from_step: int = 0):
        super().__init__(path, cfg, seed=seed, start_step=start_step, device=device,
                         compute_flow=compute_flow, flow_from_step=flow_from_step,
                         batch_size=local_batch_size(global_batch_size or cfg.batch_size),
                         shard=process_index_count())
