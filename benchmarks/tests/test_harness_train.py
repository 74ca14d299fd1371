"""The training cell: its plain reference against the port, its metric
readers on synthetic records, and its runs with the timed path broken.

    python -m pytest benchmarks/tests/test_harness_train.py -q
    python -m pytest benchmarks/tests/test_harness_train.py -q -m cuda -s   # on the card

The faults, each planted in the program under a whole run at the tiny size
on the CPU (and, marked `cuda`, under readings at the cell's own size on the
card): a step that returns its state unchanged (the parameters put back
after Adam's update); half of the batch left out, the loss the mean over the
rest; an answer altered where it is produced (the image term counted twice).
The cell runs on one card, so it has no exchange between chips to leave out.
"""

import importlib
import io
import json
import time
import types
from contextlib import redirect_stdout

import pytest
import torch

from benchmarks.harness import checks
from benchmarks.harness.main import Context, cell_files, load_metric, sized
from benchmarks.harness.record import Record
from benchmarks.roofline import k4, k6b
from stabnet_tpu_torch.utils import profiling

CELL = "train-b10"
T0 = 1_800_000_000.0          # a window's start, host seconds
CARD = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"}


def make_cell(size="tiny", seed=5, device="cpu", fp32=False):
    wl, cfg = cell_files(CELL)
    wl, cfg = sized(wl, size), sized(cfg, size)
    if fp32:
        cfg = dict(cfg, compute_dtype="float32")
    ctx = Context(CELL, wl, cfg, seed, torch.device(device), False, size)
    return importlib.import_module(f"benchmarks.drivers.{wl['driver']}").Cell(ctx)


@pytest.fixture
def fp32_tiny(monkeypatch):
    import stabnet_tpu_torch.config as C

    monkeypatch.setitem(C._REGISTRY, "tiny", C.TINY.replace(compute_dtype="float32"))


@pytest.mark.parametrize("seed", [5, 6])
def test_reference_follows_the_port(fp32_tiny, seed):
    """With the port's trunk in float32 the two sides differ by summation
    order alone: the first step's loss and gradients agree closely; the
    later steps drift a little, since Adam's first update moves every
    element by the learning rate whatever the sign of a gradient at
    rounding level."""
    from benchmarks.reference import train as ref_train
    from benchmarks.traffic.weights import make_weights

    cell = make_cell(seed=seed, fp32=True)
    cfg = cell.ctx.cfg
    prog = cell.start(seed, make_weights(cfg, seed, cell.ctx.device))
    cell.close()
    ref = ref_train.follow(make_weights(cfg, seed, cell.ctx.device), prog["batches"], cfg)
    assert abs(prog["losses"][0] - ref["losses"][0]) <= 1e-5 * abs(ref["losses"][0])
    gaps = ref_train.gaps(prog, ref, cell.ctx.wl["nought"])
    assert gaps["grad_worst"] < 0.01 and gaps["grad_gap"] < 1e-3, gaps
    assert gaps["loss_gap"] < 0.01 and gaps["change_gap"] < 0.05, gaps


def test_flops_per_step():
    """Forward and backward of 20 frames: 2.87 times 20 forward passes of
    22,780,889,088 FLOPs (no gradient of the input stack)."""
    from benchmarks.drivers.train import flops_per_step

    wl, cfg = cell_files(CELL)
    assert flops_per_step(cfg) == 1_306_738_483_200


def record(counters, ops=None, window_s=10.0):
    """A run's record; `ops` are (name, start, seconds after T0) device
    operations, None for no trace."""
    reduced = None
    if ops is not None:
        reduced = {"ops": [(n, T0 + a, d) for n, a, d in ops],
                   "busy_s": sum(d for _, _, d in ops), "window_s": window_s,
                   "device_ops": [], "idle_gaps": []}
    ctx = types.SimpleNamespace(wl={}, cfg={})
    return Record([], counters, reduced, dict(CARD), ctx, (T0, T0 + window_s))


SHAPES = {"steps": 4, "flops_per_step": 1_306_738_483_200,
          "k4_shape": [10, 288, 512, 2, 288, 512], "k6b_shape": [20, 288, 512, 1, 288, 512]}


def test_device_readers():
    ops = [("void splat_max_kernel(float const*)", 0.0, 10e-6),
           ("splat_scatter_kernel", 0.1, 10e-6), ("splat_convert_kernel", 0.2, 10e-6),
           ("splat_max_kernel", 1.0, 10e-6), ("splat_scatter_kernel", 1.1, 10e-6),
           ("splat_convert_kernel", 1.2, 10e-6),
           ("sample_map_grad_kernel", 2.0, 40e-6), ("sample_map_grad_kernel", 3.0, 40e-6),
           ("Memcpy HtoD (Pinned -> Device)", 4.0, 0.19986)]
    rec = record(dict(SHAPES), ops)
    # K4 at (10, 288, 512, 2): 35,389,440 bytes, 10.564 us at 3.35 TB/s, over 30 us a call.
    least = k4.nbytes(*SHAPES["k4_shape"]) / 3.35e12
    assert load_metric("k4_roofline").read(rec) == pytest.approx(100 * least / 30e-6)
    # K6b at (20, 288, 512, 1): 70,778,880 bytes, 21.128 us, over 40 us a launch.
    least = k6b.nbytes(*SHAPES["k6b_shape"]) / 3.35e12
    assert load_metric("k6b_roofline").read(rec) == pytest.approx(100 * least / 40e-6)
    assert load_metric("device_ms_per_step.train").read(rec) == pytest.approx(0.2 / 4 * 1e3)
    assert load_metric("idle.train").read(rec) == pytest.approx(98.0)
    mfu = 4 * 1_306_738_483_200 / (10.0 * 989.4e12) * 100
    assert load_metric("mfu.train").read(rec) == pytest.approx(mfu)


@pytest.mark.parametrize("name", ["k4_roofline", "k6b_roofline", "device_ms_per_step.train",
                                  "idle.train", "mfu.train"])
def test_device_readers_without_a_trace(name):
    """The CPU has no timeline and no peak: nothing to read."""
    assert load_metric(name).read(record(dict(SHAPES), None)) is None


def test_rooflines_without_their_kernels():
    rec = record(dict(SHAPES), [("Memcpy HtoD (Pinned -> Device)", 0.0, 1e-3)])
    assert load_metric("k4_roofline").read(rec) is None
    assert load_metric("k6b_roofline").read(rec) is None
    assert load_metric("device_ms_per_step.train").read(record({"steps": 0}, [])) is None


@pytest.fixture
def kept(monkeypatch):
    """The program's tracer, emptied; the test fills its buffer."""
    tracer = profiling.Tracer()
    monkeypatch.setattr(profiling, "TRACER", tracer)
    return tracer


def span(name, a, b, index, parent=-1):
    s = profiling.Span(name, index, parent)
    s.start_ns, s.end_ns = int((T0 + a) * 1e9), int((T0 + b) * 1e9)
    return s


def test_data_wait(kept):
    kept.buffer.extend([span("train.data", 0.0, 0.1, 0), span("train.step", 0.1, 0.13, 1),
                        span("train.data", 0.13, 0.33, 2), span("train.step", 0.33, 0.36, 3),
                        span("train.data", 9.99, 10.2, 4)])      # ends after the window
    assert load_metric("data_wait_ms.train").read(record({"steps": 2})) == pytest.approx(150.0)


def test_data_wait_without_spans(kept):
    rec = record({"steps": 2})
    assert load_metric("data_wait_ms.train").read(rec) is None
    kept.buffer.append(span("train.step", 0.1, 0.13, 0))
    assert load_metric("data_wait_ms.train").read(rec) is None
    kept.dropped = 1
    kept.buffer.append(span("train.data", 0.2, 0.3, 1))
    assert load_metric("data_wait_ms.train").read(rec) is None


def unchanged_state(monkeypatch):
    """The step puts the parameters back after Adam's update."""
    from stabnet_tpu_torch.train import train

    orig = train._train_body

    def body(state, batch, cfg):
        kept = [p.detach().clone() for p in state.model.parameters()]
        out = orig(state, batch, cfg)
        with torch.no_grad():
            for p, k in zip(state.model.parameters(), kept):
                p.copy_(k)
        return out

    monkeypatch.setattr(train, "_train_body", body)


def half_batch(monkeypatch):
    """The step's loss is that of the first half of the batch's rows."""
    from stabnet_tpu_torch.train import train

    orig = train.compute_losses

    def losses(model, batch, cfg, gates):
        h = max(batch["x1"].shape[0] // 2, 1)
        return orig(model, {k: v[:h] for k, v in batch.items()}, cfg, gates)

    monkeypatch.setattr(train, "compute_losses", losses)


def altered_term(monkeypatch):
    """The image term is counted twice where it is produced."""
    from stabnet_tpu_torch import losses

    orig = losses.img_loss
    monkeypatch.setattr(losses, "img_loss", lambda *a: orig(*a) * 2.0)


def run_tiny(seed="3000000077"):
    from benchmarks.harness.main import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["--workload", CELL, "--seed", seed, "--seconds", "1", "--trace", "0",
                   "--device", "cpu", "--size", "tiny"], time.time())
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_term],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = run_tiny()
    assert line["correct"] is False, line["checks"]


def test_sound_run_is_correct():
    assert run_tiny()["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [half_batch, altered_term], ids=lambda f: f.__name__)
def test_fault_on_card(monkeypatch, fault):
    """Each fault at the cell's own size, on three seeds, fails the limits;
    its readings go to standard output (the upper readings of PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size")
    fault(monkeypatch)
    cell = make_cell("full", 3000000201, "cuda")
    for seed in (3000000202, 3000000203, 3000000204):
        r = cell.reading(seed)
        print(json.dumps({"fault": fault.__name__, "seed": seed, **r}), flush=True)
        assert not checks.passed(checks.compare(r, cell.ctx.wl["limits"])), (seed, r)
    cell.close()
