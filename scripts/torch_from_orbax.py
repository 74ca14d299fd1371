"""Write the newest step of a JAX model directory as the port's checkpoint.

`stabnet_tpu` train writes Orbax checkpoints; `stabnet_tpu_torch` reads its
own `<step>/state.pt` and imports no orbax.  This script runs where JAX
runs and bridges the two:

    python scripts/torch_from_orbax.py --model-dir JAX_DIR --out PORT_DIR \
        [--config v2_93]

after which `python -m stabnet_tpu_torch.cli.main stabilize --model-dir
PORT_DIR` serves the weights and `train --model-dir PORT_DIR --restore`
resumes the run.

The step is restored with `stabnet_tpu.train.checkpoint.restore` against a
target made by `create_train_state` for `--config` (the architecture is
all it reads from the config).  The parameters and BN statistics go through
`stabnet_tpu_torch.models.convert_flax_variables`.  Adam is elementwise, so
its moments `mu` and `nu` take the parameters' layout map and are listed in
`model.parameters()` order, as the port's `Adam` holds them; optax's update
count becomes `Adam.count` and the step stays the step.  The conversion
runs on the host (JAX_PLATFORMS defaults to cpu here).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def port_state(jax_state, config: str):
    """A JAX `TrainState` -> the port's `TrainState` on the CPU."""
    import numpy as np

    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.models import convert_flax_variables
    from stabnet_tpu_torch.train.state import create_train_state

    state = create_train_state(get_config(config), device="cpu")
    state.model.load_state_dict(convert_flax_variables(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats}))
    adam = next(s for s in jax_state.opt_state if hasattr(s, "mu"))
    names = [name for name, _ in state.model.named_parameters()]
    mu = convert_flax_variables({"params": adam.mu})
    nu = convert_flax_variables({"params": adam.nu})
    state.opt.load_state_dict({"count": int(np.asarray(adam.count)),
                               "mu": [mu[n] for n in names],
                               "nu": [nu[n] for n in names]})
    state.step = int(np.asarray(jax_state.step))
    return state


def convert(model_dir: str, out: str, config: str) -> str:
    """Restore the newest step of `model_dir` and save it under `out` as
    `<step>/state.pt`; returns the step directory written."""
    import jax

    from stabnet_tpu.config import get_config
    from stabnet_tpu.models import make_model
    from stabnet_tpu.train import checkpoint as jax_ckpt
    from stabnet_tpu.train.state import create_train_state
    from stabnet_tpu_torch.train import checkpoint as ckpt

    cfg = get_config(config)
    target = create_train_state(make_model(cfg), cfg, jax.random.PRNGKey(0))
    return ckpt.save(out, port_state(jax_ckpt.restore(model_dir, target), config))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model-dir", required=True,
                   help="model directory of `stabnet_tpu.cli.main train` (Orbax)")
    p.add_argument("--out", required=True,
                   help="the port's model directory to write <step>/state.pt into")
    p.add_argument("--config", default="v2_93")
    args = p.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    print(f"converted {args.model_dir} -> {convert(args.model_dir, args.out, args.config)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
