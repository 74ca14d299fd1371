"""The StabNet regressor (PyTorch port of stabnet_tpu.models)."""

from stabnet_tpu_torch.models.convert import convert_flax_variables, load_flax_npz
from stabnet_tpu_torch.models.resnet import (
    BottleneckV2,
    ResNetV2,
    StabNetRegressor,
    ThetaHead,
    cast_weights,
    init_weights,
)
from stabnet_tpu_torch.models.stabnet import (
    StabNetOutput,
    forward,
    forward_train,
    make_model,
    scale_theta_head,
)
