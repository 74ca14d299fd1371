"""Data parallelism over cards: one process per card for training, one
model replica per device for batch serving (the PyTorch port of
stabnet_tpu/parallel)."""

from stabnet_tpu_torch.parallel.mesh import data_devices, replicated, shard_batch
from stabnet_tpu_torch.parallel.multihost import (
    MultiHostPipeline,
    average_gradients,
    barrier,
    form_global_batch,
    initialize_distributed,
    local_batch_size,
    mean_over_ranks,
    process_index_count,
)

__all__ = [
    "MultiHostPipeline",
    "average_gradients",
    "barrier",
    "data_devices",
    "form_global_batch",
    "initialize_distributed",
    "local_batch_size",
    "mean_over_ranks",
    "process_index_count",
    "replicated",
    "shard_batch",
]
