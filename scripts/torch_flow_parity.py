#!/usr/bin/env python3
"""Measure the port's TV-L1 flow and quality scores against the JAX package's
on the CPU, and print the gaps (the numbers behind the tolerances of
tests/test_torch_flow.py and tests/test_torch_metrics.py).

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/torch_flow_parity.py [--model-scale]
        [--gate-clip I]

Prints one line per comparison: the flow's max, mean and 99.9th-percentile
absolute gap in pixels on two translated smooth images at (2, 96, 128)
(and, with --model-scale, at (2, 288, 512)), the worst gap of each
`evaluate_clip` score on the tests' 16-frame 48x64 shaky clip, and of each
`score_stabilized_clip` score; first, how many of 10^6 random float32
values PyTorch's float32 `sqrt` rounds otherwise than the float64 root
rounded to float32 (why `ops/flow.py` takes the latter).  With --gate-clip
I, held-out clip I of scripts/torch_quality_gate.py at its defaults (TINY,
120 frames) instead: the input's stability in both packages, the pairs
whose inter-frame homographies differ most, and for the worst pair its
phase-correlation shift, the flow's gap on it (in its 32-pair call) and
the fit of each package's flow by the other package.  Needs JAX, OpenCV
and SciPy.
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
    parser.add_argument("--gate-clip", type=int, default=None, metavar="I",
                        help="compare the quality gate's held-out clip I instead")
    args = parser.parse_args()
    if args.gate_clip is not None:
        gate_clip(args.gate_clip)
        return

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


def _fit(m, to, u: np.ndarray, shift, size) -> np.ndarray:
    """Package `m`'s normalized homographies of the flow `u` after the
    global `shift` (sx, sy), weighted as its stability chain weights them
    (`_pairs_h_chunk`); `to` makes the package's array from numpy."""
    sx, sy = shift
    src, dst = m._grid_correspondences(to(u))
    dst = dst + to(np.stack([sx, sy], -1)[:, None, :].astype(np.float32))
    x, y = np.asarray(src[:, 0]), np.asarray(src[:, 1])
    H, W = size
    valid = ((x[None, :] + sx[:, None] >= 0) & (x[None, :] + sx[:, None] <= W - 1)
             & (y[None, :] + sy[:, None] >= 0) & (y[None, :] + sy[:, None] <= H - 1))
    return np.asarray(m._normalize_h(m.fit_homographies(src, dst,
                                                        to(valid.astype(np.float32)))))


def gate_clip(i: int) -> None:
    import importlib.util

    import jax.numpy as jnp
    import torch

    from stabnet_tpu.eval import metrics as jm
    from stabnet_tpu.ops import flow as jax_flow
    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.eval import metrics as tm
    from stabnet_tpu_torch.ops.flow import tvl1_flow
    from stabnet_tpu_torch.stream import video_io

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "torch_quality_gate", os.path.join(here, "torch_quality_gate.py"))
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    cfg = get_config("tiny")
    clip = gate.held_out_clips(cfg, i + 1, 120, [1.5, 2.5, 3.5, 5.0], seed=0)[i]
    gray = np.stack([video_io.to_gray_train(f, cfg.height, cfg.width, 1.0) for f in clip])
    hj = np.asarray(jm._interframe_h(jnp.asarray(gray)))
    ht = tm._interframe_h(torch.from_numpy(gray)).numpy()
    print(f"gate clip {i}: input stability JAX {float(jm.stability_score(jnp.asarray(hj))):.7g}, "
          f"port {float(tm.stability_score(torch.from_numpy(ht))):.7g}")
    nj = np.asarray(jm._normalize_h(jnp.asarray(hj)))
    nt = tm._normalize_h(torch.from_numpy(ht)).numpy()
    gap = np.abs(nj - nt).reshape(len(nj), -1).max(1)
    worst = [int(k) for k in np.argsort(-gap)[:3]]
    print("largest normalized-homography gaps (pair: gap): "
          + ", ".join(f"{k}: {gap[k]:.6g}" for k in worst))
    k = worst[0]
    lo = k - k % 32           # the 32-pair call that holds pair k, padded as scored
    a, b = gray[:-1][lo:lo + 32], gray[1:][lo:lo + 32]
    a, b = (np.concatenate([x, np.repeat(x[-1:], 32 - len(x), axis=0)]) for x in (a, b))
    shift = [np.asarray(v) for v in jm._global_shift(jnp.asarray(a), jnp.asarray(b))]
    tshift = [v.numpy() for v in tm._global_shift(torch.from_numpy(a), torch.from_numpy(b))]
    rolled = np.asarray(jm._roll2(jnp.asarray(b), *map(jnp.asarray, shift)))
    uj = np.asarray(jax_flow.tvl1_flow(jnp.asarray(a), jnp.asarray(rolled), **dict(jm._FLOW_KW)))
    ut = tvl1_flow(torch.from_numpy(a), torch.from_numpy(rolled),
                   fine_iters=tm._FINE_ITERS).numpy()
    j = k - lo
    d = np.abs(uj - ut)[j]
    print(f"pair {k}: shift (sx, sy) ({shift[0][j]}, {shift[1][j]}), equal in both "
          f"packages: {all(np.array_equal(x, y) for x, y in zip(shift, tshift))}; flow gap "
          f"max {d.max():.6g} px, mean {d.mean():.6g} px; JAX's flow spans "
          f"[{uj[j].min():.6g}, {uj[j].max():.6g}] px on a {cfg.height}x{cfg.width} frame")
    size = (cfg.height, cfg.width)
    for name, u in (("JAX's flow", uj), ("the port's flow", ut)):
        fj = _fit(jm, jnp.asarray, u, shift, size)[j]
        ft = _fit(tm, torch.from_numpy, u, shift, size)[j]
        print(f"{name} fitted: JAX (tx, ty) ({fj[0, 2]:.6g}, {fj[1, 2]:.6g}), "
              f"port ({ft[0, 2]:.6g}, {ft[1, 2]:.6g})")


if __name__ == "__main__":
    main()
