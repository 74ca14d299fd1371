"""Flax variables -> the port's state_dict.

The port's modules carry the Flax module names (models/resnet.py), so a
parameter's key is its Flax path with the collection dropped and the leaf
renamed:

  params/.../kernel  (4-D, HWIO)  -> .../weight  (OIHW)
  params/.../kernel  (2-D, in,out) -> .../weight  (out, in)
  params/.../bias                 -> .../bias
  params/.../scale   (BatchNorm)  -> .../weight
  batch_stats/.../mean            -> .../running_mean
  batch_stats/.../var             -> .../running_var

A checkpoint travels as an .npz whose keys are the Flax paths joined by "/"
("params/resnet_v2_50/conv1/conv/kernel", ...).  Every tensor converts to
fp32, the dtype of all the port's parameters and statistics.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_LEAVES = {
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def convert_flat(flat: Mapping[Tuple[str, ...], np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
    """{(collection, *modules, leaf): array} -> state_dict."""
    state = {}
    for path, value in flat.items():
        collection, modules, leaf = path[0], path[1:-1], path[-1]
        a = np.array(value, dtype=np.float32)  # a writable copy
        if (collection, leaf) == ("params", "kernel"):
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of rank {a.ndim}")
            name = "weight"
        elif (collection, leaf) in _LEAVES:
            name = _LEAVES[(collection, leaf)]
        else:
            raise KeyError(f"unknown variable {'/'.join(path)}")
        state[".".join(modules + (name,))] = torch.from_numpy(
            np.ascontiguousarray(a))
    return state


def convert_flax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Nested Flax {"params": ..., "batch_stats": ...} of arrays -> state_dict."""
    return convert_flat(dict(_flatten(variables)))


def load_flax_npz(path: str) -> Dict[str, torch.Tensor]:
    """state_dict from an .npz keyed by "/"-joined Flax paths."""
    with np.load(path) as data:
        return convert_flat({tuple(k.split("/")): data[k] for k in data.files})
