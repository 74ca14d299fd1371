"""Endurance of the PyTorch port: a long chained training run, scored as it goes.

The port of scripts/endurance.py over the port's CLI (`python -m
stabnet_tpu_torch.cli.main`).  The reference trains 100k steps
(configs/v2_93.py:5-15) with the learning rate decayed at 40k
(train_bundle_nobm.py:155-160).  This script:

  1. materializes synthetic shards at `--config` (`make-synthetic`);
  2. chains `train --steps N --restore` segments, each in a fresh process
     (so every segment goes through `--restore`), with the reference's
     schedule scaled into the run by `--set`: the decay at `--decay-frac`
     of `--target`, the theta-only, black and temporal gates at 0.1 %, 1 %
     and 5 % of it;
  3. every `--score-every` steps, stabilizes the held-out clips of mixed
     shake through `stabilize --batch --metrics` and appends their scores
     to `<workdir>/scores.jsonl`;
  4. prints the verdict as its last line: stability at the end at least
     that of the first scored checkpoint, above the input's, no regression
     across the decay, and a distortion floor; exit 0 only if it passes.

Every command runs on `--device` (cuda by default).

Run:  python scripts/torch_endurance.py [--target 10000] [--workdir DIR]
Artifacts: <workdir>/scores.jsonl, <workdir>/endurance.log (every command's
output) and the training metrics under <workdir>/log.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _REPO)
_CLI = [sys.executable, "-m", "stabnet_tpu_torch.cli.main"]


def run(args_list, log_path: str) -> str:
    """Run one CLI command, its output appended to the log; returns its
    stdout and raises if it fails."""
    with open(log_path, "a") as log:
        log.write(f"\n== {time.strftime('%F %T')} $ {' '.join(args_list)}\n")
    proc = subprocess.run(args_list, capture_output=True, text=True, cwd=_REPO)
    with open(log_path, "a") as log:
        log.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"step failed rc={proc.returncode}: "
                           f"{' '.join(args_list)} (see {log_path})")
    return proc.stdout


def ensure_eval_clips(cfg, clip_dir: str, n_clips: int, frames: int, jitters) -> None:
    from stabnet_tpu_torch.data.synthetic import make_video
    from stabnet_tpu_torch.stream import video_io

    if os.path.exists(os.path.join(clip_dir, "list.txt")):
        return
    names = []
    for i in range(n_clips):
        name = f"endur{i}.avi"
        names.append(name)
        for sub, jit in (("unstable", jitters[i % len(jitters)]), ("stable", 0.0)):
            os.makedirs(os.path.join(clip_dir, sub), exist_ok=True)
            w = video_io.VideoWriter(os.path.join(clip_dir, sub, name), 30.0,
                                     (cfg.height, cfg.width))
            for f in make_video(frames, cfg.height, cfg.width, seed=5000 + i, jitter=jit):
                w.write(f)
            w.close()
    with open(os.path.join(clip_dir, "list.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def score(args, it: int, clip_dir: str, log_path: str) -> dict:
    """The held-out clips stabilized from the newest checkpoint; their
    `--metrics` records (the ones the quality gate scores)."""
    from stabnet_tpu_torch.config import get_config

    cfg = get_config(args.config)
    out = run(_CLI + ["stabilize", "--config", args.config,
                      "--model-dir", os.path.join(args.workdir, "model"),
                      "--test-list", os.path.join(clip_dir, "list.txt"),
                      "--prefix", clip_dir,
                      "--output-dir", os.path.join(args.workdir, "eval_out"),
                      "--output-size", str(cfg.height), str(cfg.width),
                      "--batch", str(args.clips), "--metrics", "--device", args.device],
              log_path)
    clips = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith("{") and "stability" in ln]
    if len(clips) != args.clips:
        raise RuntimeError(f"{len(clips)} scored clips, expected {args.clips}: {out[-500:]}")
    rec = {
        "iter": it,
        "mean_stability": sum(c["stability"] for c in clips) / len(clips),
        "mean_stability_input": sum(c["stability_input"] for c in clips) / len(clips),
        "mean_distortion": sum(c["distortion"] for c in clips) / len(clips),
        "min_distortion": min(c["distortion"] for c in clips),
        "mean_cropping": sum(c["cropping"] for c in clips) / len(clips),
        "clips": clips,
    }
    with open(os.path.join(args.workdir, "scores.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"iter {it}: stability {rec['mean_stability']:.4f} "
          f"(input {rec['mean_stability_input']:.4f}), "
          f"distortion {rec['mean_distortion']:.4f} "
          f"(min {rec['min_distortion']:.4f})", flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--target", type=int, default=10000)
    p.add_argument("--segment", type=int, default=2000,
                   help="steps per fresh-process training segment")
    p.add_argument("--score-every", type=int, default=2000)
    p.add_argument("--config", default="v2_93")
    p.add_argument("--examples", type=int, default=256)
    p.add_argument("--clips", type=int, default=4)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--jitters", default="1.5,2.5,3.5,5.0")
    p.add_argument("--decay-frac", type=float, default=0.4,
                   help="LR decay boundary as a fraction of --target "
                        "(reference: 40k of 100k)")
    p.add_argument("--set", action="append", default=[],
                   help="extra config overrides forwarded to train")
    p.add_argument("--workdir",
                   default=os.path.join(tempfile.gettempdir(), "stabnet_torch_endurance"))
    p.add_argument("--device", default="cuda",
                   help="torch device of every command (cuda, or cpu)")
    args = p.parse_args(argv)

    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.train.checkpoint import latest_step

    cfg = get_config(args.config)
    os.makedirs(args.workdir, exist_ok=True)
    log_path = os.path.join(args.workdir, "endurance.log")
    data_dir = os.path.join(args.workdir, "data")
    clip_dir = os.path.join(args.workdir, "clips")
    model_dir = os.path.join(args.workdir, "model")

    if not os.path.exists(os.path.join(data_dir, "train", "list.txt")):
        run(_CLI + ["make-synthetic", "--out", os.path.join(data_dir, "train"),
                    "--num", str(args.examples), "--config", args.config], log_path)
    jitters = [float(j) for j in args.jitters.split(",")]
    ensure_eval_clips(cfg, clip_dir, args.clips, args.frames, jitters)

    # The whole reference schedule scaled into the run, not the decay
    # alone: the reference opens theta-only, black and temporal at 0.1 %,
    # 1 % and 5 % of its 100k steps and decays at 40 %
    # (configs/v2_93.py:5-15,28-32, train_bundle_nobm.py:155-160,219-236),
    # so the temporal loss, which trains stability itself, opens at full
    # learning rate at any --target.
    step_size = int(args.target * args.decay_frac)
    overrides = [
        f"step_size={step_size}",
        f"do_theta_only_iter={max(10, args.target // 1000)}",
        f"do_black_loss_iter={max(50, args.target // 100)}",
        f"do_temp_loss_iter={max(100, args.target // 20)}",
    ] + args.set

    start = latest_step(model_dir) or 0
    if start:
        print(f"resuming endurance chain from step {start}", flush=True)
    records = []
    scores_path = os.path.join(args.workdir, "scores.jsonl")
    if os.path.exists(scores_path):
        with open(scores_path) as f:
            records = [json.loads(ln) for ln in f if ln.strip()]
            records = [r for r in records if r["iter"] <= start]

    step = start
    while step < args.target:
        nxt = min(step + args.segment, args.target)
        cmd = _CLI + ["train", "--config", args.config, "--data", data_dir,
                      "--model-dir", model_dir, "--log-dir", os.path.join(args.workdir, "log"),
                      "--steps", str(nxt), "--device", args.device]
        for o in overrides:
            cmd += ["--set", o]
        if step > 0:
            cmd.append("--restore")
        print(f"segment: {step} -> {nxt} / {args.target}", flush=True)
        t0 = time.perf_counter()
        run(cmd, log_path)
        print(f"segment: {nxt - step} steps in {time.perf_counter() - t0:.1f} s", flush=True)
        step = nxt
        if step % args.score_every == 0 or step == args.target:
            records.append(score(args, step, clip_dir, log_path))

    # ---- Verdict ---------------------------------------------------------
    by_iter = {r["iter"]: r for r in records}
    iters = sorted(by_iter)
    first, last = by_iter[iters[0]], by_iter[iters[-1]]
    pre_decay = [by_iter[i] for i in iters if i <= step_size]
    post_decay = [by_iter[i] for i in iters if i > step_size]
    checks = {
        "trend_up": last["mean_stability"] >= first["mean_stability"],
        "beats_input_at_end": last["mean_stability"] > last["mean_stability_input"],
        # The decay must not regress quality: the worst score after it stays
        # above the best before it, less a small tolerance.
        "no_post_decay_regression": (
            not pre_decay or not post_decay
            or min(r["mean_stability"] for r in post_decay)
            >= max(r["mean_stability"] for r in pre_decay) - 0.02),
        "distortion_floor": last["min_distortion"] >= 0.5,
    }
    summary = {
        "target": args.target,
        "step_size": step_size,
        "scores": [{k: r[k] for k in ("iter", "mean_stability", "mean_distortion",
                                      "min_distortion")}
                   for r in (by_iter[i] for i in iters)],
        "checks": checks,
        "pass": all(checks.values()),
    }
    print(json.dumps(summary))
    return 0 if summary["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
