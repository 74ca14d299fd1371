"""Training record format: sharded .npz example archives + index.

The JAX package's format (stabnet_tpu/data/records.py), read and written
with numpy alone, so either package reads the other's shards.  Shard
layout: `shard-NNNNN.npz` with stacked arrays for `SHARD_KEYS` plus an `n`
count; `list.txt` names the shards (the reference's list.txt driver,
get_data_mini_after.py:158-163).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Sequence

import numpy as np

from stabnet_tpu_torch.config import StabNetConfig

SHARD_KEYS = ("stable", "unstable", "flow", "matches1", "mask1", "matches2", "mask2")


def write_shards(path: str, examples: Sequence[Dict[str, np.ndarray]],
                 shard_size: int = 64) -> List[str]:
    """Write `examples` as compressed shards of `shard_size` under `path`;
    returns the shard names.  `flow` is optional, as in the JAX package."""
    os.makedirs(path, exist_ok=True)
    keys = [k for k in SHARD_KEYS if k in examples[0]]
    names = []
    for s in range(0, len(examples), shard_size):
        chunk = examples[s: s + shard_size]
        arrays = {k: np.stack([e[k] for e in chunk]) for k in keys}
        name = f"shard-{s // shard_size:05d}.npz"
        np.savez_compressed(os.path.join(path, name), n=len(chunk), **arrays)
        names.append(name)
    with open(os.path.join(path, "list.txt"), "w") as f:
        f.write(" ".join(names))
    return names


def list_shards(path: str) -> List[str]:
    with open(os.path.join(path, "list.txt")) as f:
        return [os.path.join(path, n.strip()) for n in f.read().split() if n.strip()]


def read_shard(shard_path: str) -> Dict[str, np.ndarray]:
    with np.load(shard_path) as z:
        return {k: z[k] for k in SHARD_KEYS if k in z}


def iterate_examples(path: str, epochs: int = 1, shuffle: bool = True,
                     seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Stream single raw examples across shards, shuffled per epoch (shard
    order, then example order, from one RandomState(seed))."""
    shards = list_shards(path)
    rng = np.random.RandomState(seed)
    for _ in range(epochs):
        order = rng.permutation(len(shards)) if shuffle else np.arange(len(shards))
        for si in order:
            data = read_shard(shards[si])
            n = data["stable"].shape[0]
            for i in (rng.permutation(n) if shuffle else np.arange(n)):
                yield {k: v[i] for k, v in data.items()}


def write_synthetic_dataset(path: str, cfg: StabNetConfig, num_examples: int,
                            seed: int = 0, shard_size: int = 64) -> List[str]:
    """Materialize a synthetic dataset (tests, smoke training): example i
    is `make_raw_example(cfg, seed + i)`."""
    from stabnet_tpu_torch.data.synthetic import make_raw_example

    examples = [make_raw_example(cfg, seed=seed + i) for i in range(num_examples)]
    return write_shards(path, examples, shard_size=shard_size)
