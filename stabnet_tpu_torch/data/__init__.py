"""Synthetic data (PyTorch port of stabnet_tpu.data, `make_video` only)."""

from stabnet_tpu_torch.data.synthetic import make_video
