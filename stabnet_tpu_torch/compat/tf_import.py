"""TF-slim checkpoints -> the port's state_dict.

Two uses, mirroring the reference's restore paths:
  1. the ImageNet `resnet_v2_50.ckpt` for transfer learning
     (train_bundle_nobm.py:184-191,208; `train --imagenet-ckpt`);
  2. trained StabNet checkpoints (`models/v2_93/model-80000`) for serving
     (deploy_bundle.py:45-46; `stabilize --tf-checkpoint`, `convert-ckpt`).

Reading and mapping are apart: `load_tf_checkpoint` reads a checkpoint into
{slim name: np.ndarray}, importing TensorFlow inside the call (the package
needs none otherwise), and the mapping functions take such a dict.  The
mapping builds the Flax variable tree of the JAX package's
`stabnet_tpu/compat/tf_import.py` (the port's own copy) and converts it with
`models/convert.convert_flax_variables`:

  resnet_v2_50/conv1/weights                  -> resnet_v2_50.conv1.conv.weight
  .../block{B}/unit_{U}/bottleneck_v2/preact/{gamma,beta,moving_*}
                                              -> ...block{B}_unit{U}.preact_bn.*
  .../bottleneck_v2/shortcut/{weights,biases} -> ...shortcut_conv.*
  .../bottleneck_v2/conv{1,2}/weights         -> ...conv1.weight, conv2.conv.weight
  .../bottleneck_v2/conv{1,2}/BatchNorm/*     -> ...bn{1,2}.*
  .../bottleneck_v2/conv3/{weights,biases}    -> ...conv3.*
  resnet_v2_50/postnorm/*                     -> resnet_v2_50.postnorm.*
  stable_net/resnet/fc/fc/fc_{1,2,3}/*        -> head.fc{1,2,3}.*
  stable_net/resnet/fc/fc_weights,fc_bias     -> head.out.*

slim conv weights are (kh, kw, cin, cout) and fully-connected ones (in, out),
Flax's layouts, which the converter transposes to the port's.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from stabnet_tpu_torch.models.convert import convert_flax_variables

# Units per block of resnet_v2_50.
_STAGES = (3, 4, 6, 3)
# Scopes inside the checkpoints (s_net_bundle_nobm.py:251-259).
STABNET_TRUNK = "stable_net/resnet/resnet_v2_50"
STABNET_HEAD = "stable_net/resnet/fc"
IMAGENET_TRUNK = "resnet_v2_50"


def load_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read every variable of a TF checkpoint into numpy arrays."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise RuntimeError(
            "TensorFlow is required to read TF checkpoints; install it or "
            "convert the checkpoint offline.") from e
    reader = tf.train.load_checkpoint(path)
    return {name: np.asarray(reader.get_tensor(name))
            for name in reader.get_variable_to_shape_map()}


def _bn_entry(tree_p, tree_s, name: str, tf_vars: Mapping[str, np.ndarray],
              tf_prefix: str) -> None:
    tree_p[name] = {"scale": tf_vars[tf_prefix + "/gamma"],
                    "bias": tf_vars[tf_prefix + "/beta"]}
    tree_s[name] = {"mean": tf_vars[tf_prefix + "/moving_mean"],
                    "var": tf_vars[tf_prefix + "/moving_variance"]}


def _trunk_tree(tf_vars: Mapping[str, np.ndarray], prefix: str
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """slim resnet_v2_50 variables under `prefix` -> Flax (params,
    batch_stats) of the trunk."""
    p: Dict[str, Any] = {"conv1": {"conv": {
        "kernel": tf_vars[f"{prefix}/conv1/weights"],
        "bias": tf_vars[f"{prefix}/conv1/biases"]}}}
    s: Dict[str, Any] = {}
    for b, num_units in enumerate(_STAGES, start=1):
        for u in range(1, num_units + 1):
            src = f"{prefix}/block{b}/unit_{u}/bottleneck_v2"
            unit_p: Dict[str, Any] = {}
            unit_s: Dict[str, Any] = {}
            _bn_entry(unit_p, unit_s, "preact_bn", tf_vars, f"{src}/preact")
            if f"{src}/shortcut/weights" in tf_vars:
                unit_p["shortcut_conv"] = {"kernel": tf_vars[f"{src}/shortcut/weights"],
                                           "bias": tf_vars[f"{src}/shortcut/biases"]}
            unit_p["conv1"] = {"kernel": tf_vars[f"{src}/conv1/weights"]}
            _bn_entry(unit_p, unit_s, "bn1", tf_vars, f"{src}/conv1/BatchNorm")
            unit_p["conv2"] = {"conv": {"kernel": tf_vars[f"{src}/conv2/weights"]}}
            _bn_entry(unit_p, unit_s, "bn2", tf_vars, f"{src}/conv2/BatchNorm")
            unit_p["conv3"] = {"kernel": tf_vars[f"{src}/conv3/weights"],
                               "bias": tf_vars[f"{src}/conv3/biases"]}
            p[f"block{b}_unit{u}"] = unit_p
            s[f"block{b}_unit{u}"] = unit_s
    _bn_entry(p, s, "postnorm", tf_vars, f"{prefix}/postnorm")
    return p, s


def convert_resnet_v2_50(tf_vars: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """slim's ImageNet resnet_v2_50 variables -> the trunk's state_dict,
    keyed `resnet_v2_50.*` as in the port's StabNetRegressor."""
    p, s = _trunk_tree(tf_vars, IMAGENET_TRUNK)
    return convert_flax_variables({"params": {"resnet_v2_50": p},
                                   "batch_stats": {"resnet_v2_50": s}})


def convert_stabnet_variables(tf_vars: Mapping[str, np.ndarray]
                              ) -> Dict[str, torch.Tensor]:
    """Variables of a trained reference checkpoint -> the whole regressor's
    state_dict (the trunk scoped `stable_net/resnet/resnet_v2_50`, the head
    MLP and its output layer, s_net_bundle_nobm.py:251-259)."""
    trunk_p, trunk_s = _trunk_tree(tf_vars, STABNET_TRUNK)
    head = {f"fc{i}": {"kernel": tf_vars[f"{STABNET_HEAD}/fc/fc_{i}/weights"],
                       "bias": tf_vars[f"{STABNET_HEAD}/fc/fc_{i}/biases"]}
            for i in (1, 2, 3)}
    head["out"] = {"kernel": tf_vars[f"{STABNET_HEAD}/fc_weights"],
                   "bias": tf_vars[f"{STABNET_HEAD}/fc_bias"]}
    return convert_flax_variables({"params": {"resnet_v2_50": trunk_p, "head": head},
                                   "batch_stats": {"resnet_v2_50": trunk_s}})


def convert_stabnet_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A trained reference TF checkpoint -> the regressor's state_dict."""
    return convert_stabnet_variables(load_tf_checkpoint(path))


def convert_imagenet_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """slim's ImageNet resnet_v2_50.ckpt -> the trunk's state_dict
    (`train/checkpoint.transfer_from_imagenet` grafts it)."""
    return convert_resnet_v2_50(load_tf_checkpoint(path))


def tensor_name_map() -> Dict[str, str]:
    """Reference deploy tensor names -> the port's equivalents (parity map).

    The reference deploy driver fetches tensors by graph name
    (deploy_bundle.py:48-56).
    """
    return {
        "stable_net/input/x_tensor:0": "stream.assemble_input(...)",
        "stable_net/inference/SpatialTransformer/_transform/output_img:0":
            "StabNetOutput.warp.output",
        "stable_net/inference/SpatialTransformer/_transform/black_pix:0":
            "StabNetOutput.warp.black_pix",
        "stable_net/inference/SpatialTransformer/_transform/get_Hs/Hs:0":
            "StabNetOutput.warp.Hs",
        "stable_net/inference/SpatialTransformer/_transform/x_map:0":
            "StabNetOutput.warp.x_map",
        "stable_net/inference/SpatialTransformer/_transform/y_map:0":
            "StabNetOutput.warp.y_map",
    }
