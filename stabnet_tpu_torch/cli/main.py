"""StabNet CLI on PyTorch: serving, training and synthetic data.

Usage:
  python -m stabnet_tpu_torch.cli.main stabilize --config v2_93 \
      --test-list data_video/test_list --prefix data_video \
      --output-dir out [--weights weights.npz] [--refine N] \
      [--output-size H W] [--device-gray] [--metrics] [--device cuda|cpu]
  python -m stabnet_tpu_torch.cli.main make-synthetic --out data/train \
      --num 256 [--config tiny] [--seed 0]
  python -m stabnet_tpu_torch.cli.main train --config v2_93 --data data/ \
      [--model-dir DIR] [--log-dir DIR] [--restore] [--steps N] \
      [--set key=value ...] [--seed 0] [--tensorboard] [--compute-flow] \
      [--device cuda|cpu]
  python -m stabnet_tpu_torch.cli.main evaluate --output out.avi \
      [--input in.avi] [--config v2_93] [--max-frames 120] [--device cuda|cpu]

`train` reads record shards from `<data>/train` and, if it exists,
`<data>/test` (reference: train_bundle_nobm.py:34-37); `--compute-flow`
estimates the temporal loss's flow on the device (TV-L1), which shards
without a flow field need.  `stabilize --metrics` prints one JSON line of
quality scores per clip; `evaluate` prints the stability (and, with
`--input`, cropping and distortion) scores of a stabilized video.

For each video name in the list file(s), reads `<prefix>/unstable/<name>` and
writes `<output-dir>/output/<name>.avi` and `<name>_cut.avi` (reference:
deploy_bundle.py:12-31).  `--weights` is an .npz of Flax variables keyed by
"/"-joined paths (models/convert.py).  Without it the model runs seeded random
weights with the theta head scaled by 0.05.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEVICE_HELP = ("torch device (default cuda; cpu runs the plain PyTorch "
               "versions of the kernels)")


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
        device_gray=args.device_gray, collect_input_gray=args.metrics))
    failures = 0
    videos = _read_video_lists(args.test_list)
    for name in videos:
        try:
            res = driver.stabilize_file(
                os.path.join(args.prefix, "unstable", name), args.output_dir)
            print(f"{name}: {len(res.frames)} frames, crop={res.crop_rect}, "
                  f"net fps={res.fps_net:.1f}")
            if args.metrics:
                from stabnet_tpu_torch.eval import score_stabilized_clip

                cfg = driver.cfg
                scores = score_stabilized_clip(
                    res.frames, res.input_gray, (cfg.height, cfg.width),
                    crop_rect=res.crop_rect, device=args.device)
                scores["video"] = name
                print(json.dumps(scores))
        except Exception as e:  # one bad clip must not stop the list
            failures += 1
            print(f"error: {name}: {e}", file=sys.stderr)
    if failures:
        print(f"{failures}/{len(videos)} videos failed", file=sys.stderr)
        sys.exit(1)


def cmd_train(args):
    import logging

    from stabnet_tpu_torch.config import apply_overrides, get_config
    from stabnet_tpu_torch.data.pipeline import InputPipeline
    from stabnet_tpu_torch.train.checkpoint import latest_step
    from stabnet_tpu_torch.train.loop import train

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = apply_overrides(get_config(args.config), args.set)
    if args.model_dir:
        cfg = cfg.replace(model_dir=args.model_dir)
    if args.log_dir:
        cfg = cfg.replace(log_dir=args.log_dir)
    # The resume step decorrelates the shuffle and augmentation streams, so
    # a restored segment continues with fresh batches, and counts the steps
    # before the temporal-loss gate opens, which need no TV-L1 solve.
    resume_step = (latest_step(cfg.model_dir) or 0) if args.restore else 0
    train_it = InputPipeline(os.path.join(args.data, "train"), cfg,
                             seed=args.seed, start_step=resume_step,
                             device=args.device, compute_flow=args.compute_flow,
                             flow_from_step=cfg.do_temp_loss_iter)
    test_dir = os.path.join(args.data, "test")
    test_it = (InputPipeline(test_dir, cfg, seed=args.seed + 1, device=args.device,
                             compute_flow=args.compute_flow)
               if os.path.isdir(test_dir) else None)
    try:
        train(cfg, train_it, test_it, restore=args.restore, num_steps=args.steps,
              seed=args.seed, tensorboard=args.tensorboard, device=args.device)
    finally:
        for it in (train_it, test_it):
            if it is not None:
                it.close()


def cmd_evaluate(args):
    """Stability (and, with --input, cropping and distortion) scores of a
    stabilized video, as one JSON line (stabnet_tpu_torch/eval/metrics.py)."""
    import numpy as np

    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.eval import evaluate_clip
    from stabnet_tpu_torch.stream.video_io import VideoReader, to_gray_train

    cfg = get_config(args.config)

    def read_gray(path):
        frames = []
        reader = VideoReader(path)
        for f in reader:
            frames.append(to_gray_train(f, cfg.height, cfg.width))
            if args.max_frames and len(frames) >= args.max_frames:
                break
        reader.close()
        if not frames:
            raise ValueError(f"no frames decoded from {path}")
        return np.stack(frames)

    out = read_gray(args.output)
    inp = None
    if args.input:
        inp = read_gray(args.input)
        n = min(len(out), len(inp))
        out, inp = out[:n], inp[:n]
    scores = evaluate_clip(out, inp, device=args.device)
    scores["frames"] = int(out.shape[0])
    print(json.dumps(scores))


def cmd_make_synthetic(args):
    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.data.records import write_synthetic_dataset

    write_synthetic_dataset(args.out, get_config(args.config), args.num,
                            seed=args.seed)
    print(f"wrote {args.num} synthetic examples -> {args.out}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="stabnet_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train StabNet (train_bundle_nobm equivalent)")
    p.add_argument("--config", default="v2_93")
    p.add_argument("--data", default="data/")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--restore", action="store_true")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override a config field (repeatable), e.g. "
                        "--set step_size=4000")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tensorboard", action="store_true",
                   help="mirror the metrics to TensorBoard event files under "
                        "<log-dir>/tb")
    p.add_argument("--compute-flow", action="store_true",
                   help="estimate the temporal-loss flow on the device "
                        "(TV-L1, stabnet_tpu_torch.ops.flow) instead of reading "
                        "it from the record shards; required for shards "
                        "without a flow field")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("make-synthetic", help="generate a synthetic dataset")
    p.add_argument("--out", required=True)
    p.add_argument("--num", type=int, default=256)
    p.add_argument("--config", default="tiny")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_make_synthetic)
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
    p.add_argument("--metrics", action="store_true",
                   help="print stability/cropping/distortion scores per clip as "
                        "one JSON line (stabnet_tpu_torch.eval)")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p.set_defaults(fn=cmd_stabilize)

    p = sub.add_parser("evaluate",
                       help="stability/cropping/distortion scores for a "
                            "stabilized clip")
    p.add_argument("--output", required=True, help="stabilized video")
    p.add_argument("--input", default=None,
                   help="original (unstable) video; enables the cropping and "
                        "distortion scores")
    p.add_argument("--config", default="v2_93")
    p.add_argument("--max-frames", type=int, default=120)
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p.set_defaults(fn=cmd_evaluate)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
