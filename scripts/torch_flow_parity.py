#!/usr/bin/env python3
"""Measure the port's TV-L1 flow and quality scores against the JAX package's
on the CPU, and print the gaps (the numbers behind the tolerances of
tests/test_torch_flow.py and tests/test_torch_metrics.py).

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/torch_flow_parity.py [--model-scale]

Prints one line per comparison: the flow's max, mean and 99.9th-percentile
absolute gap in pixels on two translated smooth images at (2, 96, 128)
(and, with --model-scale, at (2, 288, 512)), the worst gap of each
`evaluate_clip` score on the tests' 16-frame 48x64 shaky clip, and of each
`score_stabilized_clip` score; first, how many of 10^6 random float32
values PyTorch's float32 `sqrt` rounds otherwise than the float64 root
rounded to float32 (why `ops/flow.py` takes the latter).  Needs JAX,
OpenCV and SciPy.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-scale", action="store_true",
                        help="also compare the flow at (2, 288, 512)")
    args = parser.parse_args()

    import jax.numpy as jnp
    import torch

    from stabnet_tpu.eval import metrics as jm
    from stabnet_tpu.ops import flow as jax_flow
    from stabnet_tpu_torch.eval import metrics as tm
    from stabnet_tpu_torch.ops.flow import tvl1_flow
    from tests.test_torch_flow import _pair
    from tests.test_torch_metrics import _record_case, _shaky_pair

    x = torch.rand(10**6, generator=torch.Generator().manual_seed(0)) * 1000
    off = int((torch.sqrt(x) != torch.sqrt(x.double()).float()).sum())
    print(f"float32 sqrt on the CPU (torch {torch.__version__}): {off} of {x.numel()} "
          "values differ from the correctly rounded root")

    shapes = [(96, 128, 3, [(3.6, -2.3), (-1.2, 0.7)])]
    if args.model_scale:
        shapes.append((288, 512, 5, [(2.4, -1.1), (-0.8, 3.1)]))
    for H, W, seed, shifts in shapes:
        a, b = _pair(seed, H, W, shifts)
        want = np.asarray(jax_flow.tvl1_flow(jnp.asarray(a), jnp.asarray(b)))
        got = tvl1_flow(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        d = np.abs(got - want)
        print(f"tvl1_flow (2, {H}, {W}) default iterations: max abs {d.max():.6g} px, "
              f"mean abs {d.mean():.6g} px, 99.9th percentile {np.percentile(d, 99.9):.6g} px, "
              f"pixels above 1e-2 px {int((d > 1e-2).sum())} of {d.size}")

    inp, out = _shaky_pair()
    rect = (4, 5, 42, 58)
    want = jm.evaluate_clip(out, inp, rect=rect)
    got = tm.evaluate_clip(out, inp, rect=rect, device="cpu")
    print("evaluate_clip 16 x 48 x 64, input and rect: "
          + ", ".join(f"{k} {got[k]:.7f} vs {want[k]:.7f} (gap {abs(got[k] - want[k]):.3g})"
                      for k in want))

    out, in_gray, hw, rect = _record_case()
    want = jm.score_stabilized_clip(out, in_gray, hw, crop_rect=rect)
    got = tm.score_stabilized_clip(out, in_gray, hw, crop_rect=rect, device="cpu")
    print("score_stabilized_clip 24 frames 96x128 -> 48x64: "
          + ", ".join(f"{k} {got[k]:.7f} vs {want[k]:.7f} (gap {abs(got[k] - want[k]):.3g})"
                      for k in want))


if __name__ == "__main__":
    main()
