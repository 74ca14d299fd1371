"""StabNet serving CLI on PyTorch.

Usage:
  python -m stabnet_tpu_torch.cli.main stabilize --config v2_93 \
      --test-list data_video/test_list --prefix data_video \
      --output-dir out [--weights weights.npz] [--refine N] \
      [--output-size H W] [--device-gray] [--device cuda|cpu]

For each video name in the list file(s), reads `<prefix>/unstable/<name>` and
writes `<output-dir>/output/<name>.avi` and `<name>_cut.avi` (reference:
deploy_bundle.py:12-31).  `--weights` is an .npz of Flax variables keyed by
"/"-joined paths (models/convert.py).  Without it the model runs seeded random
weights with the theta head scaled by 0.05.
"""

from __future__ import annotations

import argparse
import os
import sys


def _read_video_lists(paths):
    names = []
    for list_path in paths:
        with open(list_path) as f:
            names.extend(v.strip() for v in f.read().split("\n") if v.strip())
    return names


def build_engine(config: str, weights=None, refine: int = 1, output_size=None,
                 device="cuda"):
    """The StreamEngine the `stabilize` command serves with."""
    import torch

    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.models import load_flax_npz, make_model, scale_theta_head
    from stabnet_tpu_torch.stream import StreamEngine

    cfg = get_config(config)
    model = make_model(cfg, torch.Generator().manual_seed(0))
    if weights:
        model.load_state_dict(load_flax_npz(weights))
    else:
        print("warning: no --weights given; using seeded random weights "
              "(theta head scaled by 0.05)", file=sys.stderr)
        scale_theta_head(model, 0.05)
    return StreamEngine(model, cfg, refine=refine, out_hw=output_size,
                        device=device)


def cmd_stabilize(args):
    from stabnet_tpu_torch.stream import DeployOptions, StreamDriver

    output_size = tuple(args.output_size) if args.output_size else None
    engine = build_engine(args.config, args.weights, args.refine, output_size,
                          args.device)
    driver = StreamDriver(engine, DeployOptions(
        refine=args.refine, output_size=output_size,
        device_gray=args.device_gray))
    failures = 0
    videos = _read_video_lists(args.test_list)
    for name in videos:
        try:
            res = driver.stabilize_file(
                os.path.join(args.prefix, "unstable", name), args.output_dir)
            print(f"{name}: {len(res.frames)} frames, crop={res.crop_rect}, "
                  f"net fps={res.fps_net:.1f}")
        except Exception as e:  # one bad clip must not stop the list
            failures += 1
            print(f"error: {name}: {e}", file=sys.stderr)
    if failures:
        print(f"{failures}/{len(videos)} videos failed", file=sys.stderr)
        sys.exit(1)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="stabnet_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("stabilize", help="streaming deploy (deploy_bundle equivalent)")
    p.add_argument("--config", default="v2_93")
    p.add_argument("--test-list", nargs="+",
                   default=["data_video/test_list"])
    p.add_argument("--prefix", default="data_video")
    p.add_argument("--output-dir", default="data_video_local")
    p.add_argument("--refine", type=int, default=1)
    p.add_argument("--output-size", type=int, nargs=2, default=None,
                   metavar=("H", "W"))
    p.add_argument("--device-gray", action="store_true",
                   help="derive the model-scale gray on the device from the "
                        "uploaded color frame")
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="Flax variables as an .npz keyed by '/'-joined paths "
                        "(omit for seeded random weights)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.set_defaults(fn=cmd_stabilize)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
