"""StabNet serving and training on PyTorch and CUDA: a port of the JAX package
`stabnet_tpu`.

Imports torch and numpy only (cv2 lazily, for video files).  The warp kernels
are hand-written CUDA for Hopper (csrc/), built on first use.
"""

from stabnet_tpu_torch.config import StabNetConfig, get_config

__all__ = ["StabNetConfig", "get_config"]
