"""StabNet CLI on PyTorch: serving, training, synthetic data, checkpoints.

Usage:
  python -m stabnet_tpu_torch.cli.main stabilize --config v2_93 \
      --test-list data_video/test_list --prefix data_video \
      --output-dir out [--model-dir DIR | --tf-checkpoint CKPT | --weights NPZ] \
      [--refine N] [--output-size H W] [--device-gray] [--metrics] \
      [--infer-with-stable] [--infer-with-last] [--max-span N] \
      [--random-black SPEED] [--start-with-stable] [--deploy-vis] \
      [--batch S [--batch-chunk T | --batch-sharded]] [--stream-chunk K] \
      [--no-pipeline] [--from-export ARTIFACT] [--device cuda|cpu]
  python -m stabnet_tpu_torch.cli.main export --out ARTIFACT --config v2_93 \
      [--model-dir DIR | --tf-checkpoint CKPT | --weights NPZ] [--streams S] \
      [--refine N] [--segment K] [--output-size H W] [--device cuda|cpu] \
      [--selftest]
  python -m stabnet_tpu_torch.cli.main make-synthetic --out data/train \
      --num 256 [--config tiny] [--seed 0]
  python -m stabnet_tpu_torch.cli.main train --config v2_93 --data data/ \
      [--model-dir DIR] [--log-dir DIR] [--restore] [--imagenet-ckpt CKPT] \
      [--steps N] [--set key=value ...] [--seed 0] [--tensorboard] \
      [--compute-flow] [--data-parallel] [--debug-vis] \
      [--device cuda|cpu]
  python -m torch.distributed.run --nproc-per-node N \
      -m stabnet_tpu_torch.cli.main train --data-parallel ...
  python -m stabnet_tpu_torch.cli.main evaluate --output out.avi \
      [--input in.avi] [--config v2_93] [--max-frames 120] [--device cuda|cpu]
  python -m stabnet_tpu_torch.cli.main convert-ckpt --tf-checkpoint model-80000 \
      --out DIR [--config v2_93]
  python -m stabnet_tpu_torch.cli.main make-dataset --prefix data_video \
      --list LIST|NAME ... --out data/train [--stride 4] [--max-per-video N]
  python -m stabnet_tpu_torch.cli.main convert-data --records data/train \
      --out shards/train [--limit N]
  python -m stabnet_tpu_torch.cli.main inspect-data --records shards/train \
      --out dumps/ [--num 2] [--device cuda|cpu]
  python -m stabnet_tpu_torch.cli.main doctor [--timeout 120] \
      [--only host backend kernels mesh] [--compact] [--device cuda|cpu]
  python -m stabnet_tpu_torch.cli.main bench [--device cuda|cpu]

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

`train --data-parallel` is one process per card under
`torch.distributed.run` (without a launcher, one process is a world of
one): each rank trains on its share of the global batch `batch_size`, with
BatchNorm's statistics and the gradients reduced over the ranks (NCCL
where each rank has a card of its own, gloo where ranks share a card and on
the CPU).  `stabilize --batch S --batch-sharded` splits the S clips over every
local card, one model replica each.  `export` writes the serving step, its
weights baked in, as a `torch.export` artifact for the device it was traced
on (with `--segment K` also K steps unrolled); `stabilize --from-export`
serves from it.

`make-dataset` builds shards from stable/unstable video pairs (ORB matches
through OpenCV; no flow, so train them with `--compute-flow`),
`convert-data` from the reference's TFRecords (needs TensorFlow), and
`inspect-data` dumps examples as images; `train --debug-vis` writes the
reference's debug mosaics.  `doctor` probes the card in bounded
subprocesses: liveness, every kernel against its plain version, and the
host side of data parallelism; it exits 1 when a check fails.  `bench` runs
the headline benchmark (`stabnet_tpu_torch/bench.py`, configured by its
STABNET_BENCH_* variables): JSON headline lines on stdout, stats on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEVICE_HELP = ("torch device (default cuda; cpu runs the plain PyTorch "
               "versions of the kernels)")


def _read_video_lists(paths, allow_names=False):
    """Video names from the list files that exist (reference --test-list
    semantics: the default names two lists, either may be absent); with
    `allow_names`, a path that is not a file passes through as a name."""
    names = []
    for list_path in paths:
        if os.path.isfile(list_path):
            with open(list_path) as f:
                names.extend(v.strip() for v in f.read().split("\n") if v.strip())
        elif allow_names:
            names.append(list_path)
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


def build_exported_engine(args, output_size):
    """The engine of `stabilize --from-export`, with the JAX package's
    checks of the flags against the artifact's header
    (stabnet_tpu/cli/main.py:204-258)."""
    import torch

    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.stream.export import ExportedEngine, load_artifact

    if (args.infer_with_stable or args.infer_with_last or args.max_span > 1
            or args.random_black is not None):
        raise SystemExit(
            "--from-export serves the production path; the history ablations "
            "need a live engine (--model-dir/--tf-checkpoint/--weights)")
    if args.device_gray:
        raise SystemExit("--device-gray needs a live engine: export artifacts bake "
                         "the (state, gray, color) step signature")
    try:
        data, meta = load_artifact(args.from_export)
    except ValueError as e:
        raise SystemExit(f"--from-export: {e}")
    if meta["device"] != torch.device(args.device).type:
        raise SystemExit(f"the artifact was traced for {meta['device']}; a "
                         f"torch.export program runs on the device it was traced "
                         f"on: pass --device {meta['device']} or re-export")
    if output_size and tuple(meta["out_hw"]) != output_size:
        raise SystemExit(f"--output-size {output_size} conflicts with the artifact's "
                         f"baked {tuple(meta['out_hw'])}; re-export for a different "
                         f"size or drop the flag")
    if args.refine is not None and meta["refine"] != args.refine:
        raise SystemExit(f"--refine {args.refine} conflicts with the artifact's "
                         f"baked refine={meta['refine']}; re-export or drop the flag")
    streams = meta["streams"]
    if args.batch > 1 and streams != args.batch:
        raise SystemExit(f"artifact baked for {streams} streams; use --batch {streams}")
    if args.batch <= 1 and streams != 1:
        raise SystemExit(f"artifact baked for {streams} streams; pass --batch "
                         f"{streams} to serve it, or export with --streams 1")
    step_len = meta.get("step_len")
    engine = ExportedEngine(data[:step_len], get_config(meta["config"]), meta["out_hw"],
                            streams=streams,
                            scan_data=data[step_len:] if step_len is not None else None,
                            segment=meta.get("segment"), device=args.device)
    return engine, meta


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
    if args.batch_sharded and args.batch <= 1:
        raise SystemExit("--batch-sharded splits a --batch of S clips over the cards")
    refine = args.refine if args.refine is not None else 1
    if args.from_export:
        engine, meta = build_exported_engine(args, output_size)
        output_size, refine = tuple(meta["out_hw"]), meta["refine"]
    else:
        engine = build_engine(args.config, args.weights, refine, output_size,
                              args.device, model_dir=args.model_dir,
                              tf_checkpoint=args.tf_checkpoint)
    driver = StreamDriver(engine, DeployOptions(
        refine=refine, max_span=args.max_span,
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
    auto_chunk = (chunk is None and not args.batch_sharded
                  and hasattr(driver.engine, "continue_clip"))
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
            results = driver.stabilize_batch(clips, chunk=chunk, sharded=args.batch_sharded,
                                             pad_streams=args.batch)
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


def _rank_device(device: str):
    """A data-parallel rank's device and process-group backend: its local
    rank's card for "cuda" (ranks past the card count share cards) and
    NCCL, or gloo where ranks share a card, which NCCL refuses; the CPU
    with gloo otherwise."""
    import torch

    from stabnet_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    cards = torch.cuda.device_count()
    if dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % cards)
    torch.cuda.set_device(dev)
    shared = int(os.environ.get("LOCAL_WORLD_SIZE", 1)) > cards
    return dev, "gloo" if shared else "nccl"


def cmd_train(args):
    import logging

    from stabnet_tpu_torch.config import apply_overrides, get_config
    from stabnet_tpu_torch.data.pipeline import InputPipeline
    from stabnet_tpu_torch.parallel import (MultiHostPipeline, initialize_distributed,
                                            process_index_count)
    from stabnet_tpu_torch.train.checkpoint import latest_step
    from stabnet_tpu_torch.train.loop import train
    from stabnet_tpu_torch.utils import get_logger

    device = args.device
    if args.data_parallel:
        # Under torch.distributed.run; a world of one without a launcher.
        device, backend = _rank_device(args.device)
        initialize_distributed(backend=backend)
    # Rank 0 alone logs the loop's INFO lines; the others keep warnings.
    main_rank = process_index_count()[0] == 0
    get_logger().setLevel(logging.INFO if main_rank else logging.WARNING)
    cfg = apply_overrides(get_config(args.config), args.set)
    if args.model_dir:
        cfg = cfg.replace(model_dir=args.model_dir)
    if args.log_dir:
        cfg = cfg.replace(log_dir=args.log_dir)
    # The resume step decorrelates the shuffle and augmentation streams, so
    # a restored segment continues with fresh batches, and counts the steps
    # before the temporal-loss gate opens, which need no TV-L1 solve.
    resume_step = (latest_step(cfg.model_dir) or 0) if args.restore else 0
    # Each rank of --data-parallel reads its residue class of the records
    # and augments its share of the global batch (parallel/multihost.py).
    pipeline = MultiHostPipeline if args.data_parallel else InputPipeline
    train_it = pipeline(os.path.join(args.data, "train"), cfg,
                        seed=args.seed, start_step=resume_step,
                        device=device, compute_flow=args.compute_flow,
                        flow_from_step=cfg.do_temp_loss_iter)
    test_dir = os.path.join(args.data, "test")
    test_it = (pipeline(test_dir, cfg, seed=args.seed + 1, device=device,
                        compute_flow=args.compute_flow)
               if os.path.isdir(test_dir) else None)
    try:
        train(cfg, train_it, test_it, restore=args.restore, num_steps=args.steps,
              seed=args.seed, tensorboard=args.tensorboard, device=device,
              imagenet_ckpt=args.imagenet_ckpt, debug_vis=args.debug_vis)
    finally:
        for it in (train_it, test_it):
            if it is not None:
                it.close()
        if args.data_parallel:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


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


def cmd_export(args):
    """The serving step (and with --segment, K steps unrolled), weights
    baked in, as a self-describing `torch.export` artifact."""
    import time

    import numpy as np

    from stabnet_tpu_torch.stream.export import (ExportedEngine, export_scan_segment,
                                                 export_stream_step, load_artifact,
                                                 save_artifact)

    out_hw = tuple(args.output_size)
    engine = build_engine(args.config, args.weights, args.refine, out_hw, args.device,
                          model_dir=args.model_dir, tf_checkpoint=args.tf_checkpoint)
    t0 = time.perf_counter()
    data = export_stream_step(engine, out_hw, streams=args.streams)
    scan_data = (export_scan_segment(engine, out_hw, args.streams, args.segment)
                 if args.segment else None)
    save_artifact(args.out, data, engine.cfg, out_hw, args.streams, args.refine,
                  engine.device, scan_data=scan_data, segment=args.segment)
    total = len(data) + (len(scan_data) if scan_data else 0)
    print(f"exported {total / 1e6:.1f} MB -> {args.out} in "
          f"{time.perf_counter() - t0:.1f} s (device {engine.device.type})"
          + (f" (+{args.segment}-frame segment)" if scan_data else ""))
    if args.selftest:
        blob, meta = load_artifact(args.out)
        step_len = meta.get("step_len")
        served = ExportedEngine(blob[:step_len], engine.cfg, out_hw, streams=args.streams,
                                device=args.device)
        S, (Ho, Wo) = args.streams, out_hw
        gray = np.zeros((S, engine.cfg.height, engine.cfg.width), np.float32)
        _, out = served.step(served.init(gray), gray, np.zeros((S, Ho, Wo, 3), np.uint8))
        if tuple(out.warped_color.shape) != (S, Ho, Wo, 3):
            raise SystemExit(f"selftest: warped_color {tuple(out.warped_color.shape)}")
        print("selftest: the loaded artifact ran one step")


def cmd_make_dataset(args):
    """Raw stable/unstable video pairs -> training shards: ORB matches on
    the host (data/ingest.py); the flow is estimated at training time
    (`train --compute-flow`)."""
    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.data.ingest import build_dataset

    names = _read_video_lists(args.list, allow_names=True)
    n = build_dataset(args.prefix, names, args.out, get_config(args.config),
                      stride=args.stride, max_per_video=args.max_per_video)
    print(f"wrote {n} examples -> {args.out}")
    print("note: shards carry no flow field; train with --compute-flow")


def cmd_convert_data(args):
    from stabnet_tpu_torch.compat.tfrecord import convert_dataset
    from stabnet_tpu_torch.config import get_config

    n = convert_dataset(args.records, args.out, get_config(args.config), limit=args.limit)
    print(f"converted {n} examples -> {args.out}")


def cmd_inspect_data(args):
    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.data.visualize import inspect_dataset

    inspect_dataset(args.records, args.out, get_config(args.config), num=args.num,
                    device=args.device)
    print(f"wrote inspection dumps -> {args.out}")


def cmd_bench(args):
    """The headline benchmark through its retry wrapper, as `python -m
    stabnet_tpu_torch.bench` runs it (stabnet_tpu/cli/main.py:449-459)."""
    from stabnet_tpu_torch import bench

    bench._main_with_retries(args.device)


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
                   help="mirror the metrics (and --debug-vis mosaics) to "
                        "TensorBoard event files under <log-dir>/tb")
    p.add_argument("--debug-vis", action="store_true",
                   help="every test_freq steps and at the last, write debug "
                        "mosaics of the batch under <log-dir>/debug "
                        "(save_warpped_features equivalent; needs OpenCV)")
    p.add_argument("--compute-flow", action="store_true",
                   help="estimate the temporal-loss flow on the device "
                        "(TV-L1, stabnet_tpu_torch.ops.flow) instead of reading "
                        "it from the record shards; required for shards "
                        "without a flow field")
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank of data-parallel training: run under "
                        "`python -m torch.distributed.run --nproc-per-node N`; "
                        "each rank takes batch_size / N examples")
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
    # Default None (= 1), so an explicit --refine can be checked against an
    # artifact's baked value.
    p.add_argument("--refine", type=int, default=None)
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
    p.add_argument("--batch-sharded", action="store_true",
                   help="split the batch over every local card, one model "
                        "replica each (S divisible by the card count)")
    p.add_argument("--from-export", default=None, metavar="ARTIFACT",
                   help="serve from an `export` artifact (production path only)")
    p.add_argument("--stream-chunk", type=int, default=None, metavar="K",
                   help="constant-host-memory file serving: read, stabilize "
                        "and write K frames at a time (production path only)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="read each frame back before sending the next "
                        "(pipelining is on by default in production mode; "
                        "results are identical either way)")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p.set_defaults(fn=cmd_stabilize)

    p = sub.add_parser("export",
                       help="the serving step, weights baked in, as a "
                            "torch.export artifact")
    p.add_argument("--out", required=True)
    p.add_argument("--config", default="v2_93")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--tf-checkpoint", default=None)
    p.add_argument("--weights", default=None, metavar="NPZ")
    p.add_argument("--streams", type=int, default=1)
    p.add_argument("--refine", type=int, default=1)
    p.add_argument("--segment", type=int, default=None, metavar="K",
                   help="also bake K steps unrolled into the artifact: batch "
                        "and chunked serving then run K frames per call")
    p.add_argument("--output-size", type=int, nargs=2, default=[720, 1280],
                   metavar=("H", "W"))
    p.add_argument("--device", default="cuda",
                   help="the device to trace on, which the artifact then runs "
                        "on (cuda or cpu)")
    p.add_argument("--selftest", action="store_true",
                   help="load the artifact and run one step on zeros")
    p.set_defaults(fn=cmd_export)

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

    p = sub.add_parser("make-dataset",
                       help="raw stable/unstable video pairs -> training shards "
                            "(ORB matches; the flow at training time)")
    p.add_argument("--prefix", default="data_video",
                   help="directory with stable/ and unstable/ subdirectories")
    p.add_argument("--list", nargs="+", required=True,
                   help="video list file(s), or video names directly")
    p.add_argument("--out", required=True)
    p.add_argument("--stride", type=int, default=4,
                   help="frames between consecutive example positions")
    p.add_argument("--max-per-video", type=int, default=None)
    p.add_argument("--config", default="v2_93")
    p.set_defaults(fn=cmd_make_dataset)

    p = sub.add_parser("convert-data",
                       help="reference TFRecords -> record shards (needs TensorFlow)")
    p.add_argument("--records", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--config", default="v2_93")
    p.set_defaults(fn=cmd_convert_data)

    p = sub.add_parser("inspect-data",
                       help="dump raw and augmented examples as images "
                            "(get_data_mini_after run()/test() equivalent)")
    p.add_argument("--records", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num", type=int, default=2)
    p.add_argument("--config", default="v2_93")
    p.add_argument("--device", default="cuda",
                   help="the device that augments (default cuda)")
    p.set_defaults(fn=cmd_inspect_data)

    from stabnet_tpu_torch import bench
    from stabnet_tpu_torch.cli import doctor

    p = sub.add_parser("bench", help="run the headline benchmark")
    bench.add_arguments(p)
    p.set_defaults(fn=cmd_bench)

    doctor.add_parser(sub)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
