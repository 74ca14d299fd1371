"""Offline per-frame SIFT feature-match loader (.mat files).

Reference: feature_fetcher.py:11-17; the JAX package's
stabnet_tpu/data/feature_fetcher.py.  Loads `<dir>/<video>/<frame>.mat`,
which holds an (N, 4) array `res` of pixel-space matches, and maps it to
NDC with the capture resolution (1280x720 in the reference data).  Used by
the data dumps; the training records carry their matches baked in.
"""

from __future__ import annotations

import os

import numpy as np


def fetch(video: str, frame: int, data_dir: str = "data_video/features",
          width: int = 1280, height: int = 720) -> np.ndarray:
    """Load matches for one frame: returns (N, 4) NDC [xs, ys, xu, yu]."""
    from scipy.io import loadmat

    path = os.path.join(data_dir, video, f"{frame}.mat")
    res = loadmat(path)["res"].astype(np.float64)
    return res / [width, height, width, height] * 2.0 - 1.0
