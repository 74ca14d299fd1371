"""Quality gate of the PyTorch port: train -> stabilize -> score, in one run.

The port of scripts/quality_gate.py, which calls itself the one capability
the reference exists for: a trained model steadies video.  It imports only
`stabnet_tpu_torch`, so it runs on the card, and it keeps every default,
flag and check of the JAX script:

  1. synthetic training shards (`data/records.write_synthetic_dataset`);
  2. TINY trained through the full gate schedule (theta-only, then the
     black loss, then the temporal loss, phased in within the run) by the
     production loop (`train/loop.train` on `data/pipeline.InputPipeline`),
     with the rigidity weights distortion_mul=10 and consistency_mul=40;
  3. held-out clips of mixed shake (`data/synthetic.make_video`, jitters
     cycled) stabilized by the production batch path
     (`StreamDriver.stabilize_batch`, the input grays kept);
  4. each clip scored by `eval.score_stabilized_clip` (what `stabilize
     --metrics` prints), for the trained model and for a random-weights
     control (`make_model` at seed + 7), and the checks: steadier than the
     input on the mean; beats the control on a majority of clips (60 %)
     and by a mean margin (0.02); mean cropping and distortion at least
     0.55; every clip's distortion at least 0.7.

Prints the JSON report (the JAX script's keys) as the last line of stdout
and the seconds of each part on stderr; exit 0 only on a pass.  It runs on
`--device` (cuda by default; it never falls back to the CPU), scoring
included, where the JAX gate pins its metric chain to the CPU.

Run:  python scripts/torch_quality_gate.py [--steps 2500] [--workdir DIR]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def build_config(args):
    from stabnet_tpu_torch.config import apply_overrides, get_config

    cfg = get_config("tiny").replace(
        name="quality",
        batch_size=args.batch_size,
        # A high learning rate for the small geometry (production is 2e-5
        # for 100k steps at 288x512), decayed once near the end.
        initial_learning_rate=args.lr,
        # The rigidity weights hold the distortion-stability trade: the JAX
        # gate's tuning pins every clip's distortion at or above 0.92 with
        # them (reference losses: s_net_bundle_nobm.py:148-210).
        distortion_mul=10.0,
        consistency_mul=40.0,
        step_size=max(2 * args.steps // 3, 1),
        lr_decay_rate=0.3,
        # The full gate schedule, scaled into the run (reference:
        # train_bundle_nobm.py:219-236, configs/v2_93.py:28-32).
        do_theta_only_iter=min(50, args.steps // 10),
        do_black_loss_iter=min(150, args.steps // 4),
        do_temp_loss_iter=min(300, args.steps // 3),
        disp_freq=100,
        test_freq=10 ** 9,
        save_freq=10 ** 9,  # the loop always saves at the final step
        model_dir=os.path.join(args.workdir, "model"),
        log_dir=os.path.join(args.workdir, "log"),
    )
    # Last: the run's own overrides, so its log shows what deviated.
    return apply_overrides(cfg, args.set)


def ensure_dataset(path: str, cfg, num: int, seed: int) -> None:
    from stabnet_tpu_torch.data.records import write_synthetic_dataset

    if os.path.exists(os.path.join(path, "list.txt")):
        return
    write_synthetic_dataset(path, cfg, num, seed=seed)


def train_model(cfg, data_dir: str, steps: int, seed: int, device):
    from stabnet_tpu_torch.data.pipeline import InputPipeline
    from stabnet_tpu_torch.train.loop import train

    pipe = InputPipeline(data_dir, cfg, seed=seed, device=device,
                         flow_from_step=cfg.do_temp_loss_iter)
    try:
        state, aux = train(cfg, pipe, None, num_steps=steps, seed=seed, device=device)
    finally:
        pipe.close()
    return state.model, aux


def held_out_clips(cfg, n_clips: int, frames: int, jitters, seed: int):
    """n_clips held-out clips of mixed shake (the jitters cycled)."""
    from stabnet_tpu_torch.data.synthetic import make_video

    return [np.stack(make_video(frames, cfg.height, cfg.width,
                                seed=seed + 1000 + i,
                                jitter=jitters[i % len(jitters)]))
            for i in range(n_clips)]


def stabilize_and_score(cfg, model, clips, device):
    """The clips through the production batch path; each clip's
    `score_stabilized_clip` record."""
    from stabnet_tpu_torch.eval import score_stabilized_clip
    from stabnet_tpu_torch.stream import DeployOptions, StreamDriver, StreamEngine

    hw = (cfg.height, cfg.width)
    engine = StreamEngine(model, cfg, out_hw=hw, device=device)
    driver = StreamDriver(engine, DeployOptions(output_size=hw, collect_input_gray=True))
    return [score_stabilized_clip(res.frames, res.input_gray, hw,
                                  crop_rect=res.crop_rect, device=device)
            for res in driver.stabilize_batch(clips)]


def mean(xs):
    return float(np.mean(xs))


def run_gate(args) -> dict:
    import torch

    from stabnet_tpu_torch.models import make_model
    from stabnet_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    cfg = build_config(args)
    os.makedirs(args.workdir, exist_ok=True)
    data_dir = os.path.join(args.workdir, "data", "train")
    seconds = {}
    t0 = time.perf_counter()
    ensure_dataset(data_dir, cfg, args.examples, seed=args.seed)
    seconds["data"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    model, aux = train_model(cfg, data_dir, args.steps, args.seed, device)
    seconds["train"] = time.perf_counter() - t0
    rand_model = make_model(cfg, torch.Generator().manual_seed(args.seed + 7))

    jitters = [float(j) for j in args.jitters.split(",")]
    clips = held_out_clips(cfg, args.clips, args.frames, jitters, args.seed)
    t0 = time.perf_counter()
    trained = stabilize_and_score(cfg, model, clips, device)
    seconds["stabilize_and_score_trained"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    random_w = stabilize_and_score(cfg, rand_model, clips, device)
    seconds["stabilize_and_score_random"] = time.perf_counter() - t0
    print(f"quality gate on {device}: seconds {json.dumps(seconds)}", file=sys.stderr)

    stab_in = [s["stability_input"] for s in trained]
    stab_tr = [s["stability"] for s in trained]
    stab_rd = [s["stability"] for s in random_w]
    dist_tr = [s["distortion"] for s in trained]
    dist_rd = [s["distortion"] for s in random_w]
    wins = int(sum(t > r for t, r in zip(stab_tr, stab_rd)))
    margin = mean(stab_tr) - mean(stab_rd)

    report = {
        "steps": args.steps,
        "examples": args.examples,
        "batch_size": args.batch_size,
        "lr": args.lr,
        "clips": args.clips,
        "frames": args.frames,
        "jitters": jitters,
        "overrides": list(args.set),
        "final_train_loss": float(aux["total"]) if aux else None,
        "stability_input": stab_in,
        "stability_trained": stab_tr,
        "stability_random": stab_rd,
        "cropping_trained": [s["cropping"] for s in trained],
        "distortion_trained": dist_tr,
        "crop_area_trained": [s["crop_area"] for s in trained],
        "mean_stability_input": mean(stab_in),
        "mean_stability_trained": mean(stab_tr),
        "mean_stability_random": mean(stab_rd),
        # The control's geometry cost: stability alone rewards any warp,
        # crop and zoom (resampling low-passes the measured flow).
        "distortion_random": dist_rd,
        "mean_distortion_random": mean(dist_rd),
        "min_distortion_random": float(np.min(dist_rd)),
        "mean_cropping_trained": mean([s["cropping"] for s in trained]),
        "mean_distortion_trained": mean(dist_tr),
        "min_distortion_trained": float(np.min(dist_tr)),
        "wins_vs_random": wins,
        "margin_vs_random": margin,
    }

    majority = math.ceil(args.majority * args.clips)
    checks = {
        "stabilizes_vs_input": (report["mean_stability_trained"]
                                > report["mean_stability_input"]),
        # On a majority of the clips, not just on the mean, and by a margin.
        "beats_random_majority": wins >= majority,
        "beats_random_margin": margin >= args.min_margin,
        "cropping_sane": report["mean_cropping_trained"] >= args.min_cropping,
        "distortion_sane": (report["mean_distortion_trained"]
                            >= args.min_distortion),
        # One clip that trades its geometry away fails the gate.
        "per_clip_distortion_floor": (report["min_distortion_trained"]
                                      >= args.min_clip_distortion),
    }
    report["majority_needed"] = majority
    report["checks"] = checks
    report["pass"] = all(checks.values())
    return report


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--examples", type=int, default=256,
                   help="synthetic training examples to materialize")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--clips", type=int, default=16, help="held-out evaluation clips")
    p.add_argument("--frames", type=int, default=120,
                   help="frames per held-out clip (stability needs T >~ 15)")
    p.add_argument("--jitters", default="1.5,2.5,3.5,5.0",
                   help="comma list of shake magnitudes cycled across clips")
    p.add_argument("--majority", type=float, default=0.6,
                   help="fraction of clips on which trained must beat the "
                        "random-weights control")
    p.add_argument("--min-margin", type=float, default=0.02,
                   help="floor on mean stability(trained) - mean stability(random)")
    p.add_argument("--min-cropping", type=float, default=0.55)
    p.add_argument("--min-distortion", type=float, default=0.55,
                   help="floor on the MEAN distortion score")
    p.add_argument("--min-clip-distortion", type=float, default=0.7,
                   help="floor on the WORST single clip's distortion score")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override (repeatable), e.g. --set consistency_mul=40")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir",
                   default=os.path.join(tempfile.gettempdir(), "stabnet_torch_quality_gate"))
    p.add_argument("--device", default="cuda",
                   help="torch device of training, serving and scoring (cuda, "
                        "or cpu for the plain versions of the kernels)")
    return p


def main(argv=None) -> int:
    report = run_gate(parser().parse_args(argv))
    print(json.dumps(report))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
