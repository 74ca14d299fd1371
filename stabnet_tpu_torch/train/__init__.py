"""Training (PyTorch port of stabnet_tpu.train)."""

from stabnet_tpu_torch.train.state import (
    Adam,
    TrainState,
    create_train_state,
    learning_rate,
)
from stabnet_tpu_torch.train.train import (
    compute_losses,
    eval_step,
    loss_gates,
    make_eval_step,
    make_train_step,
    train_step,
)
