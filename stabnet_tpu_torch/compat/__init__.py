"""Reference interop: TF-slim checkpoints -> the port's state_dict."""

from stabnet_tpu_torch.compat.tf_import import (
    convert_imagenet_checkpoint,
    convert_resnet_v2_50,
    convert_stabnet_checkpoint,
    convert_stabnet_variables,
    load_tf_checkpoint,
    tensor_name_map,
)

__all__ = [
    "convert_imagenet_checkpoint",
    "convert_resnet_v2_50",
    "convert_stabnet_checkpoint",
    "convert_stabnet_variables",
    "load_tf_checkpoint",
    "tensor_name_map",
]
