"""The port's data parallelism against the JAX package and against one
process: record shards, BatchNorm across ranks, data-parallel training
through the CLI under `torch.distributed.run`, and sharded batch serving.

Ranks are worker processes on the CPU with the gloo backend, each with a
free port for its rendezvous and a timeout of its own.  Bounds:

- record shards: the JAX package's residue classes, in the same order;
- BatchNorm over two ranks of half a batch against Flax's BatchNorm over
  the whole batch: running statistics within 1.2e-7 (the bound the port's
  BN statistics are held to against Flax, ROADMAP.md Queue 3), outputs and
  gradients within 1.5e-6 of their largest value (3x the gap measured,
  which is the one-rank port's own);
- two ranks of `train --data-parallel` against one process on the merged
  batch, in f32: losses within rtol 3.4e-3, 3x the gap measured on an x86
  CPU with one thread per rank (6.7e-6 at step 0, 1.11e-3 at step 1: the first Adam
  update divides by near-zero second moments, which amplifies the
  reduction order's last bits, as the JAX package's two-process test
  notes), under that test's rtol 2e-2 (tests/test_multihost.py:158-160).
  In bf16 the two runs' roundings part at the first ulp and the random
  net's loss amplifies that to percents, so the comparison of the
  algorithm runs in f32.  One rank is the plain run bit for bit (bf16);
- sharded serving: bit for bit each shard's own run at the shard's stream
  count, and within 1 uint8 LSB of the JAX package's sharded scan on a
  2-device mesh, black maps and crops equal (the stream bound).
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from stabnet_tpu.config import get_config as jax_config
from stabnet_tpu.data.records import iterate_examples as jax_iterate_examples
from stabnet_tpu.models import init_variables, make_model as jax_make_model
from stabnet_tpu.models import scale_theta_head as jax_scale_theta_head
from stabnet_tpu.parallel import data_mesh
from stabnet_tpu.stream import StreamEngine as JaxStreamEngine
from stabnet_tpu.stream.engine import crop_rectangle as jax_crop_rectangle
from stabnet_tpu_torch.config import apply_overrides, get_config
from stabnet_tpu_torch.data import augment
from stabnet_tpu_torch.data.pipeline import batch_iterator, ensure_flow
from stabnet_tpu_torch.data.records import iterate_examples, write_synthetic_dataset
from stabnet_tpu_torch.data.synthetic import make_video
from stabnet_tpu_torch.models import convert_flax_variables, make_model
from stabnet_tpu_torch.parallel import form_global_batch
from stabnet_tpu_torch.stream import DeployOptions, StreamDriver, StreamEngine, crop_rectangle
from stabnet_tpu_torch.stream.video_io import to_gray_train
from stabnet_tpu_torch.train.state import create_train_state
from stabnet_tpu_torch.train.train import train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIVE = ["--set", "do_temp_loss_iter=0", "--set", "do_black_loss_iter=0",
        "--set", "do_theta_only_iter=-1", "--set", "batch_size=4"]
F32 = ["--set", "compute_dtype=float32"]
TIMEOUT = 300   # seconds for one group of worker processes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_on_a_free_port(start, tries: int = 3):
    """Run the workers that `start(port)` launches on a port picked free;
    pick again if another process bound the port between the pick and the
    workers' own bind (EADDRINUSE).  Each worker is polled and all are
    killed once one fails: its peers would wait for it until the timeout."""
    for attempt in range(tries):
        procs = start(str(_free_port()))
        deadline = time.monotonic() + TIMEOUT
        try:
            while (any(p.poll() is None for p in procs)
                   and not any(p.returncode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        outs = [p.communicate()[0] for p in procs]
        if attempt + 1 < tries and any("EADDRINUSE" in out for out in outs):
            continue
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-4000:]
        return outs


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _run(procs):
    """Wait for each worker within TIMEOUT; kill them all on a hang."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


# --- record shards ------------------------------------------------------------

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shards"))
    write_synthetic_dataset(d, get_config("tiny"), 12, seed=0, shard_size=5)
    return d


@pytest.mark.parametrize("index", range(4))
def test_record_shards_are_the_jax_residue_classes(shards, index):
    """`iterate_examples(shard=(i, 4))` yields the JAX package's residue
    class i of the same shuffled stream, in the same order; the classes
    together are the stream."""
    def ids(fn, shard):
        return [ex["stable"].tobytes() for ex in fn(shards, epochs=2, seed=3, shard=shard)]

    full = ids(iterate_examples, None)
    got = ids(iterate_examples, (index, 4))
    assert len(full) == 24 and got == full[index::4]
    assert got == ids(jax_iterate_examples, (index, 4))


# --- BatchNorm across ranks ---------------------------------------------------

_BN_WORKER = """
import sys
import numpy as np, torch
from stabnet_tpu_torch.models.resnet import BatchNorm
from stabnet_tpu_torch.parallel import initialize_distributed

rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
z = np.load(path)
half = z["x"].shape[0] // 2
mine = slice(rank * half, (rank + 1) * half)
bn = BatchNorm(z["x"].shape[-1]).train()
with torch.no_grad():
    for k in ("weight", "bias", "running_mean", "running_var"):
        getattr(bn, k).copy_(torch.from_numpy(z[k]))
x = torch.from_numpy(z["x"][mine]).permute(0, 3, 1, 2).requires_grad_()
y = bn(x)
(y * torch.from_numpy(z["g"][mine]).permute(0, 3, 1, 2)).sum().backward()
np.savez(path[:-4] + f"_rank{rank}.npz", y=y.detach().permute(0, 2, 3, 1).numpy(),
         dx=x.grad.permute(0, 2, 3, 1).numpy(), dw=bn.weight.grad.numpy(),
         db=bn.bias.grad.numpy(), rm=bn.running_mean.numpy(), rv=bn.running_var.numpy())
"""


def test_batchnorm_across_two_ranks_matches_flax_over_the_batch(tmp_path):
    import flax.linen as nn
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    C = 6
    z = {"x": rng.uniform(-1, 2, (4, 7, 9, C)).astype(np.float32),
         "g": rng.uniform(-1, 1, (4, 7, 9, C)).astype(np.float32),
         "weight": rng.uniform(0.5, 1.5, C).astype(np.float32),
         "bias": rng.uniform(-0.5, 0.5, C).astype(np.float32),
         "running_mean": rng.uniform(-0.5, 0.5, C).astype(np.float32),
         "running_var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    path = str(tmp_path / "bn.npz")
    np.savez(path, **z)
    _run_on_a_free_port(lambda port: [
        subprocess.Popen([sys.executable, "-c", _BN_WORKER, str(r), port, path],
                         cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True) for r in range(2)])
    ranks = [np.load(path[:-4] + f"_rank{r}.npz") for r in range(2)]

    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.997, epsilon=1e-5,
                           dtype=jnp.float32, param_dtype=jnp.float32)
    variables = {"params": {"scale": z["weight"], "bias": z["bias"]},
                 "batch_stats": {"mean": z["running_mean"], "var": z["running_var"]}}

    def loss(x, params):
        y, new = flax_bn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               x, mutable=["batch_stats"])
        return jnp.sum(y * z["g"]), (y, new)

    (_, (y, new)), (dx, dp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z["x"]), variables["params"])
    # Outputs and gradients: the sums of 378 values per channel round in
    # another order than XLA's, so each is within a few ulp of its largest
    # value (measured 4.8e-7 relative at most, the one-rank port's own gap
    # to Flax on this batch too); held to 3x that.
    for got, want in ((np.concatenate([r["y"] for r in ranks]), y),
                      (np.concatenate([r["dx"] for r in ranks]), dx),
                      (ranks[0]["dw"] + ranks[1]["dw"], dp["scale"]),
                      (ranks[0]["db"] + ranks[1]["db"], dp["bias"])):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1.5e-6 * np.abs(want).max()
    for r in ranks:
        np.testing.assert_allclose(r["rm"], np.asarray(new["batch_stats"]["mean"]),
                                   rtol=0, atol=1.2e-7)
        np.testing.assert_allclose(r["rv"], np.asarray(new["batch_stats"]["var"]),
                                   rtol=0, atol=1.2e-7)


# --- data-parallel training through the CLI ------------------------------------

@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    write_synthetic_dataset(str(d / "train"), get_config("tiny"), 16, seed=1, shard_size=8)
    return d


def _train_args(data, out, steps=2):
    return ["train", "--config", "tiny", "--data", str(data),
            "--model-dir", str(out / "models"), "--log-dir", str(out / "log"),
            "--steps", str(steps), "--device", "cpu", *LIVE]


def _launch(nproc, args):
    # --standalone: the launcher's store binds a port the OS picks, so no
    # other process can take it between a pick and the bind.
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "-m", "stabnet_tpu_torch.cli.main", *args]
    return _run([subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)])[0]


def _logged(out):
    with open(out / "log" / "metrics.jsonl") as f:
        return [json.loads(ln) for ln in f if '"train"' in ln]


def test_two_ranks_train_as_one_process_on_the_merged_batch(train_data, tmp_path):
    """Two gloo ranks each take half of the global batch of 4 from their
    residue class and their slice of the global draws; one process trains
    on `form_global_batch` of the same local batches with the global draws.
    Rank 0 alone writes the metrics."""
    out = tmp_path / "dp2"
    _launch(2, _train_args(train_data, out) + F32 + ["--data-parallel"])
    got = [rec["total"] for rec in _logged(out)]

    cfg = apply_overrides(get_config("tiny"), [a for a in LIVE + F32 if a != "--set"])
    state = create_train_state(cfg, device="cpu", seed=0)
    its = [batch_iterator(str(train_data / "train"), cfg, seed=0, batch_size=2,
                          shard=(r, 2)) for r in range(2)]
    gen = torch.Generator().manual_seed(0)
    want = []
    for _ in range(2):
        raw = augment.prepare_raw(ensure_flow(form_global_batch([next(it) for it in its])))
        batch = augment.augment_batch(gen, {k: torch.from_numpy(v) for k, v in raw.items()},
                                      cfg)
        state, aux = train_step(state, batch, cfg)
        want.append(float(aux["total"]))
    assert len(got) == 2 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=3.4e-3, atol=0)


def test_one_rank_is_the_plain_run_bit_for_bit(train_data, tmp_path):
    """`--data-parallel` under a launcher with one rank (a process group of
    one: its all-reduces and barriers run) logs the plain run's losses and
    saves its parameters, bit for bit."""
    _launch(1, _train_args(train_data, tmp_path / "dp1") + ["--data-parallel"])
    # A process of its own with the launcher's thread count: CPU reductions
    # round by the number of threads.
    _run([subprocess.Popen([sys.executable, "-m", "stabnet_tpu_torch.cli.main",
                            *_train_args(train_data, tmp_path / "plain")],
                           cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)])
    dp, plain = _logged(tmp_path / "dp1"), _logged(tmp_path / "plain")
    keys = [k for k in plain[0] if not k.endswith("_ms")]
    assert [[r[k] for k in keys] for r in dp] == [[r[k] for k in keys] for r in plain]
    a = torch.load(tmp_path / "dp1" / "models" / "2" / "state.pt", weights_only=False)
    b = torch.load(tmp_path / "plain" / "models" / "2" / "state.pt", weights_only=False)
    ma, mb = a["model"], b["model"]
    assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)


# --- sharded batch serving ----------------------------------------------------

S, T, HF, WF = 4, 12, 96, 128
LENGTHS = (12, 9, 12, 5)


@pytest.fixture(scope="module")
def serving():
    """JAX and port engines on the same TINY f32 weights, and a batch of
    four clips of unequal length laid out as the driver lays them out."""
    jcfg = jax_config("tiny").replace(compute_dtype="float32")
    jmodel = jax_make_model(jcfg)
    variables = jax_scale_theta_head(init_variables(jmodel, jcfg, jax.random.PRNGKey(0)),
                                     0.05)
    cfg = get_config("tiny").replace(compute_dtype="float32")
    model = make_model(cfg)
    model.load_state_dict(convert_flax_variables(variables))
    clips = [np.stack(make_video(n, HF, WF, seed=s, jitter=4.0))
             for s, n in enumerate(LENGTHS)]
    grays = np.zeros((S, T, cfg.height, cfg.width), np.float32)
    colors = np.zeros((S, T, HF, WF, 3), np.uint8)
    valid = np.zeros((S, T - 1), bool)
    for s, clip in enumerate(clips):
        for t in range(T):
            f = clip[min(t, len(clip) - 1)]
            grays[s, t] = to_gray_train(f, cfg.height, cfg.width,
                                        cfg.crop_rate if t == 0 else 1.0)
            colors[s, t] = f
        valid[s, : len(clip) - 1] = True
    return (JaxStreamEngine(jmodel, variables, jcfg, use_pallas=False),
            StreamEngine(model, cfg, device="cpu"), clips, grays, colors, valid)


def test_sharded_serving_matches_each_shard_alone_and_jax(serving):
    jax_engine, engine, clips, grays, colors, valid = serving
    warped, state = engine.stabilize_clips_sharded(grays, colors, devices=["cpu", "cpu"],
                                                   valid=valid)
    assert tuple(warped.shape) == (S, T - 1, HF, WF, 3)
    assert len(engine._replicas[(torch.device("cpu"),) * 2]) == 2
    for lo in (0, 2):
        alone, st = engine.stabilize_clip(grays[lo: lo + 2], colors[lo: lo + 2],
                                          valid=valid[lo: lo + 2])
        assert torch.equal(warped[lo: lo + 2], alone)
        assert torch.equal(state.all_black[lo: lo + 2], st.all_black)
        assert torch.equal(state.frames[lo: lo + 2], st.frames)

    want, jstate = jax_engine.stabilize_clips_sharded(
        grays, colors, mesh=data_mesh(jax.devices()[:2]), valid=valid)
    diff = np.abs(warped.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff[valid].max() <= 1, diff[valid].max()
    black, jblack = state.all_black.numpy(), np.asarray(jstate.all_black)
    np.testing.assert_array_equal(black, jblack)
    assert ([crop_rectangle(b) for b in black]
            == [tuple(jax_crop_rectangle(b)) for b in jblack])


def test_sharded_serving_takes_shards_placed_beforehand(serving):
    """The clips split beforehand, one shard per device (the bench places
    them before its timed window), give what the whole arrays give."""
    _, engine, _, grays, colors, valid = serving
    want, wstate = engine.stabilize_clips_sharded(grays, colors, devices=["cpu", "cpu"],
                                                  valid=valid)
    halves = [torch.from_numpy(a[lo: lo + 2]) for a in (grays, colors) for lo in (0, 2)]
    got, state = engine.stabilize_clips_sharded(halves[:2], halves[2:],
                                                devices=["cpu", "cpu"], valid=valid)
    assert torch.equal(got, want)
    assert torch.equal(state.all_black, wstate.all_black)
    assert torch.equal(state.frames, wstate.frames)
    with pytest.raises(ValueError, match="shards"):
        engine.stabilize_clips_sharded(halves[:1], halves[2:3], devices=["cpu", "cpu"])


def test_sharded_serving_refusals(serving):
    _, engine, clips, grays, colors, valid = serving
    with pytest.raises(ValueError, match="not divisible"):
        engine.stabilize_clips_sharded(grays[:3], colors[:3], devices=["cpu", "cpu"])
    driver = StreamDriver(engine, DeployOptions())
    with pytest.raises(ValueError, match="one of chunk/sharded"):
        driver.stabilize_batch(clips[:2], sharded=True, chunk=16)


def test_stabilize_batch_sharded_is_the_unsharded_batch(serving):
    """The driver's sharded batch on a CPU engine (one replica on its CPU
    device by default) equals the unsharded batch bit for bit."""
    _, engine, clips, *_ = serving
    driver = StreamDriver(engine, DeployOptions())
    for a, b in zip(driver.stabilize_batch(clips[:2], sharded=True),
                    driver.stabilize_batch(clips[:2])):
        np.testing.assert_array_equal(a.frames, b.frames)
        np.testing.assert_array_equal(a.all_black, b.all_black)
        assert a.crop_rect == b.crop_rect


def test_cli_batch_sharded_is_the_batch(tmp_path):
    """`stabilize --batch 2 --batch-sharded` writes the videos `--batch 2`
    writes (on the CPU the batch shards over its one CPU replica), and
    sharding needs a batch."""
    from stabnet_tpu_torch.cli.main import main
    from stabnet_tpu_torch.stream import video_io

    if video_io.optional_cv2() is None:
        pytest.skip("needs OpenCV file I/O")
    os.makedirs(tmp_path / "unstable")
    for s, n in enumerate((6, 4)):
        w = video_io.VideoWriter(str(tmp_path / "unstable" / f"c{s}.avi"), 30.0, (HF, WF))
        for f in make_video(n, HF, WF, seed=s, jitter=3.0):
            w.write(f)
        w.close()
    (tmp_path / "list.txt").write_text("c0.avi\nc1.avi\n")
    common = ["stabilize", "--config", "tiny", "--test-list", str(tmp_path / "list.txt"),
              "--prefix", str(tmp_path), "--batch", "2", "--device", "cpu"]
    main(common + ["--output-dir", str(tmp_path / "plain")])
    main(common + ["--output-dir", str(tmp_path / "sharded"), "--batch-sharded"])
    for name in ("c0.avi.avi", "c1.avi.avi", "c0.avi_cut.avi", "c1.avi_cut.avi"):
        a, b = (np.stack(list(video_io.VideoReader(str(tmp_path / d / "output" / name),
                                                   allow_half_rate=False)))
                for d in ("plain", "sharded"))
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit, match="needs a batch|a --batch"):
        main(common[:-4] + ["--device", "cpu", "--output-dir", str(tmp_path / "x"),
                            "--batch-sharded"])
