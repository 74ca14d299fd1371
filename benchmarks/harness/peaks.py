"""The card's published peaks, by the name `torch.cuda.get_device_name()`
gives.  NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
card's 700 W limit: 989.4 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in
float32 outside them, 3.35 TB/s of HBM3."""

from __future__ import annotations

import subprocess
from typing import Optional

CARDS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "f32_flops": 67e12,
                              "hbm_bytes_s": 3.35e12},
}


def card(name: Optional[str]) -> Optional[dict]:
    return CARDS.get(name or "")


def bf16_flops(name: Optional[str]) -> Optional[float]:
    c = card(name)
    return c["bf16_flops"] if c else None


def power_limit_w(index: int = 0) -> Optional[float]:
    """The card's power limit in watts as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index),
                              "--query-gpu=power.limit", "--format=csv,noheader"],
                             check=True, capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0].split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
