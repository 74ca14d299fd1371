"""Training losses (PyTorch port of stabnet_tpu.losses)."""

from stabnet_tpu_torch.losses.losses import (
    black_pos_loss,
    consistency_loss,
    distortion_loss,
    feature_loss,
    id_loss,
    img_loss,
    l2_regularization,
    masked_mse,
    temporal_loss,
    total_loss,
    warp_pts,
)
