"""StabNet CLI on PyTorch: serving, training, synthetic data, checkpoints.

Usage:
  python -m stabnet_tpu_torch.cli.main stabilize --config v2_93 \
      --test-list data_video/test_list --prefix data_video \
      --output-dir out [--model-dir DIR | --tf-checkpoint CKPT | --weights NPZ] \
      [--refine N] [--output-size H W] [--device-gray] [--metrics] \
      [--infer-with-stable] [--infer-with-last] [--max-span N] \
      [--random-black SPEED] [--start-with-stable] [--deploy-vis] \
      [--batch S [--batch-chunk T]] [--stream-chunk K] [--no-pipeline] \
      [--device cuda|cpu]
  python -m stabnet_tpu_torch.cli.main make-synthetic --out data/train \
      --num 256 [--config tiny] [--seed 0]
  python -m stabnet_tpu_torch.cli.main train --config v2_93 --data data/ \
      [--model-dir DIR] [--log-dir DIR] [--restore] [--imagenet-ckpt CKPT] \
      [--steps N] [--set key=value ...] [--seed 0] [--tensorboard] \
      [--compute-flow] [--device cuda|cpu]
  python -m stabnet_tpu_torch.cli.main evaluate --output out.avi \
      [--input in.avi] [--config v2_93] [--max-frames 120] [--device cuda|cpu]
  python -m stabnet_tpu_torch.cli.main convert-ckpt --tf-checkpoint model-80000 \
      --out DIR [--config v2_93]

`train` reads record shards from `<data>/train` and, if it exists,
`<data>/test` (reference: train_bundle_nobm.py:34-37); `--compute-flow`
estimates the temporal loss's flow on the device (TV-L1), which shards
without a flow field need; `--imagenet-ckpt` grafts slim's ImageNet
resnet_v2_50 trunk onto a fresh model.  `stabilize --metrics` prints one
JSON line of quality scores per clip; `evaluate` prints the stability (and,
with `--input`, cropping and distortion) scores of a stabilized video.

For each video name in the list file(s) (missing list files are skipped),
`stabilize` reads `<prefix>/unstable/<name>` and, where it exists, the stable
ground truth `<prefix>/stable/<name>`, and writes
`<output-dir>/output/<name>.avi` and `<name>_cut.avi`, with `--deploy-vis`
also `<output-dir>/output-vis/<name>.avi` (reference: deploy_bundle.py:12-31).
Weights come from `--tf-checkpoint` (a reference TF checkpoint, converted on
the fly; needs TensorFlow), else `--model-dir` (the newest `state.pt` that
`train` or `convert-ckpt` wrote), else `--weights` (an .npz of Flax
variables keyed by "/"-joined paths, models/convert.py), else seeded random
weights with the theta head scaled by 0.05.  `convert-ckpt` writes a TF
checkpoint as `<out>/0/state.pt`, a fresh training state at step 0 that
`stabilize --model-dir` and `train --restore` read.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEVICE_HELP = ("torch device (default cuda; cpu runs the plain PyTorch "
               "versions of the kernels)")


def _read_video_lists(paths):
    """Video names from the list files that exist (reference --test-list
    semantics: the default names two lists, either may be absent)."""
    names = []
    for list_path in paths:
        if os.path.isfile(list_path):
            with open(list_path) as f:
                names.extend(v.strip() for v in f.read().split("\n") if v.strip())
    return names


def build_engine(config: str, weights=None, refine: int = 1, output_size=None,
                 device="cuda", model_dir=None, tf_checkpoint=None):
    """The StreamEngine the `stabilize` command serves with.  Weights, in
    this order: `tf_checkpoint`, `model_dir`, `weights`, seeded random."""
    import torch

    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.models import load_flax_npz, make_model, scale_theta_head
    from stabnet_tpu_torch.stream import StreamEngine

    cfg = get_config(config)
    model = make_model(cfg, torch.Generator().manual_seed(0))
    if tf_checkpoint:
        from stabnet_tpu_torch.compat import convert_stabnet_checkpoint

        model.load_state_dict(convert_stabnet_checkpoint(tf_checkpoint))
    elif model_dir:
        from stabnet_tpu_torch.train.checkpoint import load_model_state

        model.load_state_dict(load_model_state(model_dir))
    elif weights:
        model.load_state_dict(load_flax_npz(weights))
    else:
        print("warning: no checkpoint given; using seeded random weights "
              "(theta head scaled by 0.05)", file=sys.stderr)
        scale_theta_head(model, 0.05)
    return StreamEngine(model, cfg, refine=refine, out_hw=output_size,
                        device=device)


def _print_scores(res, name, cfg, device):
    from stabnet_tpu_torch.eval import score_stabilized_clip

    scores = score_stabilized_clip(res.frames, res.input_gray, (cfg.height, cfg.width),
                                   crop_rect=res.crop_rect, device=device)
    scores["video"] = name
    print(json.dumps(scores))


def cmd_stabilize(args):
    from stabnet_tpu_torch.stream import DeployOptions, StreamDriver

    output_size = tuple(args.output_size) if args.output_size else None
    if args.stream_chunk is not None and (args.batch > 1 or args.metrics):
        raise SystemExit("--stream-chunk is the single-clip constant-memory "
                         "path; it keeps no frames in host RAM, so --batch "
                         "and --metrics are incompatible with it")
    engine = build_engine(args.config, args.weights, args.refine, output_size,
                          args.device, model_dir=args.model_dir,
                          tf_checkpoint=args.tf_checkpoint)
    driver = StreamDriver(engine, DeployOptions(
        refine=args.refine, max_span=args.max_span,
        infer_with_stable=args.infer_with_stable,
        infer_with_last=args.infer_with_last,
        start_with_stable=args.start_with_stable,
        random_black=args.random_black, deploy_vis=args.deploy_vis,
        output_size=output_size, device_gray=args.device_gray,
        collect_input_gray=args.metrics,
        pipelined=False if args.no_pipeline else None))
    if args.stream_chunk is not None:
        # Fail fast on a conflict, before any clip is decoded or any output
        # file created (stabilize_file checks again per call).
        try:
            driver.reconcile_chunk(args.stream_chunk)
        except ValueError as e:
            raise SystemExit(f"--stream-chunk: {e}")
    videos = _read_video_lists(args.test_list)
    if args.batch > 1:
        _stabilize_batched(args, driver, videos)
        return
    failures = 0
    for name in videos:
        try:
            res = driver.stabilize_file(
                os.path.join(args.prefix, "unstable", name), args.output_dir,
                stable_path=os.path.join(args.prefix, "stable", name),
                stream_chunk=args.stream_chunk)
            print(f"{name}: {res.num_frames} frames, crop={res.crop_rect}, "
                  f"net fps={res.fps_net:.1f}")
            if args.metrics:
                _print_scores(res, name, driver.cfg, args.device)
        except Exception as e:  # one bad clip must not stop the list
            failures += 1
            print(f"error: {name}: {e}", file=sys.stderr)
    if failures:
        print(f"{failures}/{len(videos)} videos failed", file=sys.stderr)
        sys.exit(1)


def _stabilize_batched(args, driver, videos):
    """--batch S: stabilize groups of S clips as the lock-step streams of
    the engine's scan.  Groups are padded to S streams with dummy all-invalid
    streams and the time axis is scanned in chunks (by default
    min(64, T - 1) of the first group's longest clip, then fixed), so every
    group has the same shapes."""
    import numpy as np

    from stabnet_tpu_torch.stream import video_io

    try:
        chunk = driver.reconcile_chunk(args.batch_chunk)
    except ValueError as e:
        raise SystemExit(f"--batch-chunk: {e}")
    auto_chunk = chunk is None
    failures = 0
    for lo in range(0, len(videos), args.batch):
        group = videos[lo: lo + args.batch]
        clips, fps_list, names = [], [], []
        for name in group:
            try:
                reader = video_io.VideoReader(os.path.join(args.prefix, "unstable", name))
                clip = np.stack(list(reader))
                reader.close()
                if len(clip) < 2:
                    raise ValueError(f"{len(clip)} frames (need at least 2)")
                clips.append(clip)
                fps_list.append(reader.fps)
                names.append(name)
            except Exception as e:
                failures += 1
                print(f"error: {name}: {e}", file=sys.stderr)
        if not clips:
            continue
        if auto_chunk:
            # 64 bounds device memory for long clips without padding short
            # ones to many times their length.
            chunk = min(64, max(len(c) for c in clips) - 1)
            auto_chunk = False
        try:
            results = driver.stabilize_batch(clips, chunk=chunk, pad_streams=args.batch)
        except Exception as e:
            failures += len(clips)
            print(f"error: batch {names}: {e}", file=sys.stderr)
            continue
        prod = os.path.join(args.output_dir, "output")
        os.makedirs(prod, exist_ok=True)
        for name, fps, res in zip(names, fps_list, results):
            base = os.path.basename(name)  # the layout of stabilize_file
            driver._write_video(os.path.join(prod, base + ".avi"), res.frames, fps)
            driver._write_video(os.path.join(prod, base + "_cut.avi"), res.cropped, fps)
            print(f"{name}: {len(res.frames)} frames, batch fps={res.fps_net:.1f}, "
                  f"crop={res.crop_rect}")
            if args.metrics:
                _print_scores(res, name, driver.cfg, args.device)
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
              seed=args.seed, tensorboard=args.tensorboard, device=args.device,
              imagenet_ckpt=args.imagenet_ckpt)
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


def cmd_convert_ckpt(args):
    """A reference TF checkpoint -> `<out>/0/state.pt`: a fresh training
    state at step 0 holding the converted weights (built on the CPU; the
    conversion launches nothing)."""
    from stabnet_tpu_torch.compat import convert_stabnet_checkpoint
    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.train import checkpoint as ckpt
    from stabnet_tpu_torch.train.state import create_train_state

    state = create_train_state(get_config(args.config), device="cpu")
    state.model.load_state_dict(convert_stabnet_checkpoint(args.tf_checkpoint))
    ckpt.save(args.out, state)
    print(f"converted {args.tf_checkpoint} -> {args.out}")


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
    p.add_argument("--imagenet-ckpt", default=None,
                   help="slim ImageNet resnet_v2_50.ckpt to graft onto the "
                        "fresh trunk (conv1 and the head kept; ignored with "
                        "--restore; needs TensorFlow)")
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
    # Reference flags: deploy_bundle.py:12-31.
    p.add_argument("--config", default="v2_93")
    p.add_argument("--model-dir", default=None,
                   help="checkpoint directory of `train` or `convert-ckpt` "
                        "(the newest <step>/state.pt)")
    p.add_argument("--tf-checkpoint", default=None,
                   help="reference TF checkpoint, converted on the fly (needs "
                        "TensorFlow)")
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="Flax variables as an .npz keyed by '/'-joined paths")
    p.add_argument("--test-list", nargs="+",
                   default=["data_video/test_list", "data_video/train_list_deploy"])
    p.add_argument("--prefix", default="data_video")
    p.add_argument("--output-dir", default="data_video_local")
    p.add_argument("--infer-with-stable", action="store_true")
    p.add_argument("--infer-with-last", action="store_true")
    p.add_argument("--max-span", type=int, default=1)
    p.add_argument("--random-black", type=int, default=None)
    p.add_argument("--start-with-stable", action="store_true")
    p.add_argument("--refine", type=int, default=1)
    p.add_argument("--deploy-vis", action="store_true",
                   help="write 2x2 diagnostic mosaics to output-vis/<name>.avi")
    p.add_argument("--output-size", type=int, nargs=2, default=None,
                   metavar=("H", "W"))
    p.add_argument("--device-gray", action="store_true",
                   help="derive the model-scale gray on the device from the "
                        "uploaded color frame")
    p.add_argument("--metrics", action="store_true",
                   help="print stability/cropping/distortion scores per clip as "
                        "one JSON line (stabnet_tpu_torch.eval)")
    p.add_argument("--batch", type=int, default=1, metavar="S",
                   help="stabilize S clips concurrently as lock-step streams "
                        "(throughput mode; production path only)")
    p.add_argument("--batch-chunk", type=int, default=None, metavar="T",
                   help="scan the time axis in T-frame segments (bounded "
                        "device memory for long clips)")
    p.add_argument("--stream-chunk", type=int, default=None, metavar="K",
                   help="constant-host-memory file serving: read, stabilize "
                        "and write K frames at a time (production path only)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="read each frame back before sending the next "
                        "(pipelining is on by default in production mode; "
                        "results are identical either way)")
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

    p = sub.add_parser("convert-ckpt",
                       help="reference TF checkpoint -> <out>/0/state.pt")
    p.add_argument("--tf-checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--config", default="v2_93")
    p.set_defaults(fn=cmd_convert_ckpt)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
