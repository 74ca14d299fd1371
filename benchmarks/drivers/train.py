"""Training: v2_93's Siamese step fed by its input pipeline, closed loop.

The program's training path as `train/loop.py` `train()` drives it: a
`TrainState` (the model, Adam, the step counters and the captured graphs),
`make_train_step`'s compiled step (on the card one captured CUDA graph of
forward, backward and Adam, captured at its first call), and an
`InputPipeline` over compressed record shards (read, batched and uploaded,
then augmented by its own captured graph, in its prefetch thread), each step
after the last, with the loop's `StageTimer("train.")` stages "data" and
"step" and its read of the losses every `disp_freq` steps.  The corpus is
written at set-up from the seed, the model takes the seed's weights, and the
step counter starts at the configuration's `start_step`.  No checkpoint is
written.

Correct: set-up drives the same state through its first `checked_steps`
steps, through the window's own call and feed, on rows that all differ, and
keeps their batches, their losses, the first gradient as Adam got it (its
first moment after one update over 1 - b1) and each parameter's change after
the last of them.  After the window, with the program's state freed, the
plain reference (`reference/train.py`) follows those steps from the same
weights on the same batches; the gaps are `reference.train.gaps`'.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from benchmarks.drivers import serving
from benchmarks.harness import checks
from benchmarks.reference import train as ref_train
from benchmarks.traffic.corpus import write_corpus
from benchmarks.traffic.video import sub_seed
from benchmarks.traffic.weights import make_weights

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")

# Fields of the program's configuration that the configuration file fixes,
# besides serving's.
FIXED = ("batch_size", "max_matches", "random_crop_rate", "rand_H_change_rate",
         "initial_learning_rate", "step_size", "lr_decay_rate", "weight_decay",
         "head_weight_decay", "no_theta_iter", "do_temp_loss_iter", "do_theta_10_iter",
         "do_black_loss_iter", "do_theta_only_iter")


def program_config(cfg: dict):
    """The program's configuration named by the file, refused where it
    differs from the file's numbers."""
    prog = serving.program_config(cfg, more=FIXED)
    for k, v in cfg["loss_mul"].items():
        if getattr(prog, f"{k}_mul") != v:
            raise SystemExit(f"benchmark: the program's {k}_mul is "
                             f"{getattr(prog, f'{k}_mul')!r}, the configuration file says {v!r}")
    return prog


def flops_per_step(cfg: dict) -> int:
    """Forward and backward FLOPs of one step's regressor over both halves
    of the Siamese pair (2 x batch frames), as `FlopCounterMode` counts them
    on the plain model on the meta device: the input stack is data, so its
    gradient is not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmarks.reference import model as ref_model

    with torch.device("meta"):
        W = {n: torch.zeros(s, requires_grad=ref_train.is_param(n))
             for n, s, _ in ref_model.param_spec(cfg)}
        x = torch.zeros((2 * cfg["batch_size"], cfg["height"], cfg["width"],
                         ref_model.in_channels(cfg)))
        counter = FlopCounterMode(display=False)
        with counter:
            ref_train.regressor(W, x, cfg).sum().backward()
    return int(counter.get_total_flops())


class Cell:
    def __init__(self, ctx):
        from stabnet_tpu_torch.train.state import Adam, TrainState
        from stabnet_tpu_torch.train.train import make_train_step
        from stabnet_tpu_torch.utils.profiling import StageTimer

        self.ctx = ctx
        cfg = ctx.cfg
        self.prog = program_config(cfg)
        model, W = serving.make_model(ctx, self.prog, ctx.seed)
        self.state = TrainState(cfg["start_step"], model.train(),
                                Adam(list(model.parameters())))
        opt = self.state.opt
        if (opt.b1, opt.b2, opt.eps) != tuple(cfg["adam"][k] for k in ("b1", "b2", "eps")):
            raise SystemExit(f"benchmark: the program's Adam is {(opt.b1, opt.b2, opt.eps)}, "
                             f"the configuration file says {cfg['adam']}")
        self.names = [n for n, _ in model.named_parameters()]
        self.train_step = make_train_step(self.prog)
        self.timers = StageTimer("train.")
        self.feed = self.corpus = None
        self.first = self.start(ctx.seed, W)
        B, H, Wd = cfg["batch_size"], cfg["height"], cfg["width"]
        # Only `mfu.train` reads the count, in a traced run.
        self.counters = {"steps": 0,
                         "flops_per_step": flops_per_step(cfg) if ctx.tracing else None,
                         "k4_shape": [B, H, Wd, 2, H, Wd],
                         "k6b_shape": [2 * B, H, Wd, 1, H, Wd]}
        self.attempted = self.failed = 0

    def start(self, seed: int, W) -> dict:
        """`seed`'s weights `W` and corpus in the program, Adam's moments at
        zero and the step counter at `start_step`; then the first
        `checked_steps` steps.  Returns the program's reading of them and
        their batches (host copies)."""
        ctx, cfg, wl = self.ctx, self.ctx.cfg, self.ctx.wl
        from stabnet_tpu_torch.data.pipeline import InputPipeline

        self.close()
        state = self.state
        state.model.load_state_dict(W)
        with torch.no_grad():
            for t in state.opt.mu + state.opt.nu:
                t.zero_()
        state.opt.count = 0
        state.step = cfg["start_step"]
        os.makedirs(CACHE, exist_ok=True)
        self.corpus = tempfile.mkdtemp(prefix="corpus-", dir=CACHE)
        write_corpus(self.corpus, cfg, sub_seed(seed, 9), wl["shards"], wl["per_shard"],
                     ctx.device)
        self.feed = InputPipeline(self.corpus, self.prog, seed=sub_seed(seed, 10) % (1 << 31),
                                  start_step=cfg["start_step"], device=ctx.device)
        params = list(state.model.parameters())
        batches, losses, grad = [], [], None
        for k in range(wl["checked_steps"]):
            batch, aux = self.one()
            batches.append({n: v.cpu() for n, v in batch.items()})
            losses.append(float(aux["total"]))
            if grad is None:
                grad = torch.stack(torch._foreach_norm(state.opt.mu)).cpu() / (1.0 - state.opt.b1)
        change = torch.stack(torch._foreach_norm(
            torch._foreach_sub(params, [W[n] for n in self.names]))).cpu()
        return {"losses": losses, "grad": dict(zip(self.names, grad.tolist())),
                "change": dict(zip(self.names, change.tolist())), "batches": batches}

    def one(self):
        """One step of the loop: the next batch, then the compiled step."""
        with self.timers.stage("data"):
            batch = next(self.feed)
        with self.timers.stage("step"):
            self.state, aux = self.train_step(self.state, batch)
        return batch, aux

    def window(self, seconds: float) -> None:
        every = self.prog.disp_freq
        totals = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with self.ctx.span("train_step"):
                _, aux = self.one()
            totals.append(aux["total"])
            if len(totals) % every == 0:          # the loop's log of the losses
                self.logged = {k: float(v) for k, v in aux.items()}
                self.timers.reset()
        self.counters["steps"] = len(totals)
        self.attempted = len(totals)
        self.failed = int((~torch.stack(totals).isfinite()).sum()) if totals else 0

    def end_to_end(self) -> dict:
        return {}

    def close(self) -> None:
        """Stop the feed's thread and remove its corpus."""
        if self.feed is not None:
            self.feed.close()
            self.feed = None
        if self.corpus is not None:
            import shutil

            shutil.rmtree(self.corpus, ignore_errors=True)
            self.corpus = None

    def check(self):
        """The first steps against the reference, the program's state freed
        first."""
        self.close()
        self.state = self.train_step = None
        serving.free_cuda()
        first, self.first = self.first, None
        return checks.compare(self.gaps(self.ctx.seed, first), self.ctx.wl["limits"])

    def gaps(self, seed: int, prog: dict, quant=None) -> dict:
        """The compared numbers of the program's reading `prog`, or, with
        `quant`, of the reference at that precision in the program's place,
        against the reference, from `seed`'s weights on `prog`'s batches."""
        ctx = self.ctx
        batches = [{k: v.to(ctx.device) for k, v in b.items()} for b in prog["batches"]]
        W0 = make_weights(ctx.cfg, seed, ctx.device)
        ref = ref_train.follow(W0, batches, ctx.cfg)
        if quant is not None:
            prog = ref_train.follow(W0, batches, ctx.cfg, quant=quant)
        return ref_train.gaps(prog, ref, ctx.wl["nought"])

    def reading(self, seed: int, control=None) -> dict:
        """The compared numbers of `seed`'s first steps in the same program,
        without a window (`benchmarks/limits.py`); with `control`, of the
        reference at that precision in the program's place."""
        prog = self.start(seed, make_weights(self.ctx.cfg, seed, self.ctx.device))
        self.close()
        return self.gaps(seed, prog, quant=control)
