"""Small shared helpers of the port."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from stabnet_tpu_torch.utils.logging import get_logger


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU.  Raises if CUDA is asked for (or defaulted to) and is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def host_array(a) -> np.ndarray:
    """`a` (a tensor on any device, or array-like) as a numpy array on the
    host."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def device_constant(a: np.ndarray, device: Union[str, torch.device]) -> torch.Tensor:
    """`a` as a tensor on `device`, for the shape-keyed caches of constants
    the steps read every call: made outside inference mode, so a program
    traced later (`torch.export`) can take it as a constant."""
    with torch.inference_mode(False):
        return torch.from_numpy(np.asarray(a)).to(device)
