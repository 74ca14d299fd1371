"""Reference interop: TF-slim checkpoints -> the port's state_dict, and the
reference's TFRecord datasets -> record shards.  TensorFlow is imported
inside the calls that read TF files, never at import time."""

from stabnet_tpu_torch.compat.tf_import import (
    convert_imagenet_checkpoint,
    convert_resnet_v2_50,
    convert_stabnet_checkpoint,
    convert_stabnet_variables,
    load_tf_checkpoint,
    tensor_name_map,
)
from stabnet_tpu_torch.compat.tfrecord import convert_dataset, iterate_reference_examples

__all__ = [
    "convert_dataset",
    "convert_imagenet_checkpoint",
    "convert_resnet_v2_50",
    "convert_stabnet_checkpoint",
    "convert_stabnet_variables",
    "iterate_reference_examples",
    "load_tf_checkpoint",
    "tensor_name_map",
]
