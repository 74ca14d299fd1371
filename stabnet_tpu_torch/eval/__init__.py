"""Stabilization quality metrics (PyTorch port of stabnet_tpu.eval)."""

from stabnet_tpu_torch.eval.metrics import (
    cropping_score,
    distortion_score,
    evaluate_clip,
    fit_homographies,
    score_stabilized_clip,
    stability_score,
)

__all__ = [
    "cropping_score",
    "distortion_score",
    "evaluate_clip",
    "fit_homographies",
    "score_stabilized_clip",
    "stability_score",
]
