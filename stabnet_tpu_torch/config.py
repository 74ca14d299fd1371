"""Experiment configuration for the PyTorch port.

The port's own copy of `StabNetConfig` and its registry (the JAX package's
`stabnet_tpu/config.py`): field names and defaults mirror the reference v2_93
experiment (reference: configs/v2_93.py) so a user of either package finds
every knob under the same name.  The port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class StabNetConfig:
    """Hyperparameters of one StabNet experiment (reference: configs/v2_93.py)."""

    name: str = "v2_93"

    # --- geometry -----------------------------------------------------------
    height: int = 288            # model input height  (configs/v2_93.py:3)
    width: int = 512             # model input width   (configs/v2_93.py:4)
    grid_h: int = 4              # warp mesh cells, vertical   (configs/v2_93.py:46)
    grid_w: int = 4              # warp mesh cells, horizontal (configs/v2_93.py:47)
    # history offsets; index 0 is the current frame (configs/v2_93.py:42)
    indices: Tuple[int, ...] = (0, 1, 2, 4, 8, 16, 32)
    input_mask: bool = True      # feed black-border masks as channels (configs/v2_93.py:40)

    # --- loss weights (configs/v2_93.py:7-13,44-48) -------------------------
    feature_mul: float = 1.0
    theta_mul: float = 400.0 / 2500.0
    regu_mul: float = 30.0 / 2500.0
    img_mul: float = 50.0
    temp_mul: float = 500.0
    black_mul: float = 300000.0 / 2500.0
    id_mul: float = 10.0 / 2500.0
    distortion_mul: float = 1.0
    consistency_mul: float = 20.0
    grid_theta_mul: float = 0.0

    # --- optimization (configs/v2_93.py:5-6,14-15) --------------------------
    batch_size: int = 10
    initial_learning_rate: float = 2e-5
    training_iter: int = 100000
    step_size: int = 40000        # staircase LR decay interval
    lr_decay_rate: float = 0.1    # train_bundle_nobm.py:158
    weight_decay: float = 1e-4    # slim resnet_v2 arg scope default
    head_weight_decay: float = 2e-4

    # --- loss gating schedule (configs/v2_93.py:28-32) ----------------------
    no_theta_iter: int = 1000000
    do_temp_loss_iter: int = 5000
    do_theta_10_iter: int = -1
    do_black_loss_iter: int = 1000
    do_theta_only_iter: int = 100

    # --- data (configs/v2_93.py:16-25,33-43) --------------------------------
    train_data_size: int = 27000
    test_data_size: int = 2500
    crop_rate: float = 1.0
    random_crop_rate: float = 0.9
    max_crop_rate: float = 0.6
    max_matches: int = 3000
    do_crop_rate: float = 0.8    # mesh-vertex clamp bound is 1/do_crop_rate
    rand_H_change_rate: float = 1.0
    tfrecord_item_num: int = 10
    test_batches: int = 10
    grid_max_move: float = 1.0

    # --- bookkeeping cadence (configs/v2_93.py:25-27) -----------------------
    disp_freq: int = 100
    test_freq: int = 500
    save_freq: int = 5000

    # --- dirs (configs/v2_93.py:34-36) --------------------------------------
    log_dir: str = "log/v2_93/"
    model_dir: str = "models/v2_93/"
    data_dir: str = "data/"

    # --- numerics -----------------------------------------------------------
    compute_dtype: str = "bfloat16"   # backbone conv/matmul dtype
    warp_dtype: str = "float32"       # warp path stays fp32 for parity

    # ------------------------------------------------------------------------
    @property
    def before_ch(self) -> int:
        """Number of historical frames fed to the net (configs/v2_93.py:19)."""
        return sum(1 for i in self.indices if i > 0)

    @property
    def after_ch(self) -> int:
        """Number of lookahead frames (0 in the online model) (configs/v2_93.py:20)."""
        return sum(1 for i in self.indices if i < 0)

    @property
    def tot_ch(self) -> int:
        """History + lookahead + current frame (configs/v2_93.py:21)."""
        return self.before_ch + self.after_ch + 1

    @property
    def in_channels(self) -> int:
        """Model input channel count: masks (if any) + frames
        (reference: s_net_bundle_nobm.py:275-278)."""
        return self.tot_ch + (self.before_ch if self.input_mask else 0)

    @property
    def cur_channel(self) -> int:
        """Channel index of the current unstable frame in the input stack
        (reference: s_net_bundle_nobm.py:280-283)."""
        return self.before_ch * 2 if self.input_mask else self.before_ch

    @property
    def num_mesh_pts(self) -> int:
        return (self.grid_h + 1) * (self.grid_w + 1)

    @property
    def theta_dim(self) -> int:
        """Regressor output size: 2-D offset per mesh vertex (configs/v2_93.py:46-47)."""
        return self.num_mesh_pts * 2

    @property
    def history_len(self) -> int:
        """Ring-buffer length = farthest history offset (deploy_bundle.py:41)."""
        return max(self.indices)

    def rand_h_min(self) -> Tuple[Tuple[float, ...], ...]:
        """Lower bounds of the random homography augmentation (configs/v2_93.py:38)."""
        return ((0.9, -0.1, -0.5), (-0.1, 0.9, -0.5), (-0.1, -0.1, 1.0))

    def rand_h_max(self) -> Tuple[Tuple[float, ...], ...]:
        """Upper bounds of the random homography augmentation (configs/v2_93.py:37)."""
        return ((1.1, 0.1, 0.5), (0.1, 1.1, 0.5), (0.1, 0.1, 1.0))

    def replace(self, **kw) -> "StabNetConfig":
        return dataclasses.replace(self, **kw)


# --- registry of experiment versions (mirrors reference configs/ dir) --------
_REGISTRY = {}


def register(cfg: StabNetConfig) -> StabNetConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


V2_93 = register(StabNetConfig())

# Small config for tests: tiny spatial dims, tiny batch, same structure.
TINY = register(
    StabNetConfig(
        name="tiny",
        height=48,
        width=64,
        batch_size=2,
        max_matches=64,
        indices=(0, 1, 2, 4),
    )
)


def get_config(name: str = "v2_93") -> StabNetConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown config '{name}'; known: {sorted(_REGISTRY)}")


def apply_overrides(cfg: StabNetConfig, assignments) -> StabNetConfig:
    """Apply "key=value" override strings, coerced to each field's type
    (`train --set key=value`).  Booleans accept true/false/1/0/yes/no;
    tuples take comma-separated values."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    kw = {}
    for a in assignments:
        key, eq, raw = a.partition("=")
        if not eq:
            raise ValueError(f"--set expects key=value, got {a!r}")
        if key not in fields:
            raise KeyError(f"unknown config field {key!r}; known: "
                           f"{sorted(fields)}")
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            low = raw.lower()
            if low not in ("true", "false", "1", "0", "yes", "no"):
                raise ValueError(f"--set {key}: not a boolean: {raw!r}")
            kw[key] = low in ("true", "1", "yes")
        elif isinstance(cur, tuple):
            kw[key] = tuple(type(cur[0])(v) if cur else v for v in raw.split(","))
        else:
            kw[key] = type(cur)(raw)
    return cfg.replace(**kw)
