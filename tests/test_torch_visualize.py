"""The port's visual checks against the JAX package, on the CPU (needs
OpenCV), and `train --debug-vis`.

  * `dump_example`, raw and augmented at fixed `AugParams` and fixed
    history homographies (the random draws of the two packages cannot
    agree; tests/test_torch_data.py holds the augmentation the same way):
    the same JPEG files, byte for byte;
  * `save_debug_batch` on equal numpy inputs: equal mosaics and equal
    JPEG and `-Hs.txt` files;
  * `train --debug-vis --device cpu` at TINY: the dumps at step 0 (every
    `test_freq`) and at the last step, the first mosaic in TensorBoard as
    `debug/mosaic`, and the losses and the checkpoint (BatchNorm's running
    statistics included) bit for bit those of the run without it;
  * two gloo ranks under `train --data-parallel --debug-vis`: they finish,
    rank 0 alone writes (its local batch), and the losses and checkpoint
    equal the two ranks' run without it.  A forward in training mode on
    rank 0 alone would wait forever for rank 1's BatchNorm all-reduce.
"""

import filecmp
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax
import jax.numpy as jnp

from stabnet_tpu.config import get_config as jax_config
from stabnet_tpu.data import augment as jax_augment
from stabnet_tpu.data import visualize as jax_data_vis
from stabnet_tpu.train import visualize as jax_train_vis
from stabnet_tpu_torch.cli.main import main as cli
from stabnet_tpu_torch.config import apply_overrides, get_config
from stabnet_tpu_torch.data import augment, visualize as data_vis
from stabnet_tpu_torch.data.pipeline import batch_iterator, ensure_flow
from stabnet_tpu_torch.data.records import write_synthetic_dataset
from stabnet_tpu_torch.data.synthetic import make_raw_example
from stabnet_tpu_torch.parallel import form_global_batch
from stabnet_tpu_torch.train import visualize as train_vis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_config("tiny")
JCFG = jax_config("tiny")
# crop_h, crop_w, flip, contrast, brightness: inside the ranges, flipped.
PARAMS = (4, 6, True, 0.61, 0.1)


def _fixed_homography():
    rng = np.random.RandomState(2)
    lo, hi = np.array(CFG.rand_h_min()), np.array(CFG.rand_h_max())
    return (lo + rng.rand(3, 3) * (hi - lo)).astype(np.float32)


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    assert [n for n in names if not filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                                                shallow=False)] == []
    return names


def test_dump_example_raw_and_augmented_equal_jax(tmp_path, monkeypatch):
    raw = make_raw_example(CFG, seed=2)
    H = _fixed_homography()
    ch, cw, flip, contrast, bright = PARAMS
    monkeypatch.setattr(jax_augment, "draw_params", lambda key, cfg: jax_augment.AugParams(
        jnp.asarray(ch, jnp.int32), jnp.asarray(cw, jnp.int32), jnp.asarray(flip),
        jnp.asarray(contrast, jnp.float32), jnp.asarray(bright, jnp.float32)))
    monkeypatch.setattr(jax_augment, "rand_homography", lambda key, cfg: jnp.asarray(H))
    monkeypatch.setattr(augment, "draw_params", lambda gen, cfg, b: augment.AugParams(
        torch.full((b,), ch), torch.full((b,), cw), torch.full((b,), flip),
        torch.full((b,), contrast), torch.full((b,), bright)))
    monkeypatch.setattr(augment, "rand_homography",
                        lambda gen, cfg, shape: torch.from_numpy(H).expand(*shape, 3, 3))

    want = jax_augment.augment_example(jax.random.PRNGKey(0),
                                       {k: jnp.asarray(v) for k, v in raw.items()}, JCFG)
    got = augment.augment_example(
        torch.Generator().manual_seed(0),
        {k: torch.from_numpy(v) for k, v in augment.prepare_raw(raw).items()}, CFG)
    assert np.asarray(want["mask1"]).any()
    for name, example, augmented in (("raw", raw, False), ("aug", None, True)):
        jax_data_vis.dump_example(str(tmp_path / "jax"), want if augmented else example,
                                  JCFG, name=name, augmented=augmented)
        data_vis.dump_example(str(tmp_path / "port"), got if augmented else example,
                              CFG, name=name, augmented=augmented)
    names = _same_files(tmp_path / "jax", tmp_path / "port")
    assert f"aug-x1-ch{CFG.in_channels - 1}.jpg" in names and "raw-matches.jpg" in names


def test_inspect_data_cli_dumps_raw_and_augmented(tmp_path):
    write_synthetic_dataset(str(tmp_path / "rec"), CFG, 3, seed=0)
    cli(["inspect-data", "--records", str(tmp_path / "rec"), "--out", str(tmp_path / "out"),
         "--num", "2", "--config", "tiny", "--device", "cpu"])
    names = set(os.listdir(tmp_path / "out"))
    assert {"raw0-matches.jpg", "raw1-matches.jpg", "aug0-matches.jpg",
            "aug1-matches.jpg"} <= names and not any(n.startswith("raw2") for n in names)
    # The augmented frames come from uint8 records scaled to [-0.5, 0.5]: a
    # dump of unscaled values would be white.
    img = cv2.imread(str(tmp_path / "out" / "aug0-y1.jpg"))
    assert 20 < img.mean() < 235 and img.std() > 5


def _debug_inputs():
    rng = np.random.RandomState(3)
    B, H, W = 5, CFG.height, CFG.width
    batch = {"x1": rng.uniform(-0.5, 0.5, (B, H, W, CFG.in_channels)).astype(np.float32),
             "y1": rng.uniform(-0.5, 0.5, (B, H, W, 1)).astype(np.float32),
             "matches1": rng.uniform(-1, 1, (B, CFG.max_matches, 4)).astype(np.float32),
             "mask1": (rng.rand(B, CFG.max_matches) > 0.5).astype(np.float32)}
    warp = types.SimpleNamespace(
        output=rng.uniform(-0.6, 0.6, (B, H, W, 1)).astype(np.float32),
        Hs=rng.uniform(-1, 1, (B, CFG.grid_h, CFG.grid_w, 3, 3)).astype(np.float32))
    return batch, types.SimpleNamespace(warp=warp)


def test_save_debug_batch_equals_jax(tmp_path):
    batch, outputs = _debug_inputs()
    want = jax_train_vis.save_debug_batch(str(tmp_path / "jax"), batch, outputs, JCFG, 7)
    got = train_vis.save_debug_batch(str(tmp_path / "port"), batch, outputs, CFG, 7)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint8 and a.shape == (2 * CFG.height, 2 * CFG.width, 3)
        assert np.array_equal(a, b)
    names = _same_files(tmp_path / "jax", tmp_path / "port")
    assert "step000007-ex3-Hs.txt" in names and "step000007-ex4.jpg" not in names
    # Tensors (as the training loop passes them) give the same mosaics.
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    warp = types.SimpleNamespace(output=torch.from_numpy(outputs.warp.output),
                                 Hs=torch.from_numpy(outputs.warp.Hs))
    again = train_vis.save_debug_batch(str(tmp_path / "t"), tensors,
                                       types.SimpleNamespace(warp=warp), CFG, 7)
    assert all(np.array_equal(a, b) for a, b in zip(again, got))


def test_save_debug_batch_without_opencv_warns(tmp_path, monkeypatch):
    from stabnet_tpu_torch.utils import get_logger

    batch, outputs = _debug_inputs()
    monkeypatch.setitem(sys.modules, "cv2", None)
    records = []
    handler = types.SimpleNamespace(level=0, handle=records.append)
    logger = get_logger()
    monkeypatch.setattr(logger, "handlers", logger.handlers + [handler])
    assert train_vis.save_debug_batch(str(tmp_path / "d"), batch, outputs, CFG, 0) == []
    assert not (tmp_path / "d").exists()
    assert any("cv2 unavailable" in r.getMessage() for r in records)


# --- train --debug-vis --------------------------------------------------------

LIVE = ["--set", "do_temp_loss_iter=0", "--set", "do_black_loss_iter=0",
        "--set", "do_theta_only_iter=-1", "--set", "batch_size=4",
        "--set", "compute_dtype=float32"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("vis")
    write_synthetic_dataset(str(d / "train"), CFG, 12, seed=1, shard_size=6)
    return d


def _train_args(data, out, steps, *extra):
    return ["train", "--config", "tiny", "--data", str(data), "--model-dir", str(out / "m"),
            "--log-dir", str(out / "log"), "--steps", str(steps), "--device", "cpu",
            *LIVE, *extra]


def _losses(out):
    with open(out / "log" / "metrics.jsonl") as f:
        rows = [json.loads(ln) for ln in f]
    return [{k: v for k, v in r.items() if not k.endswith("_ms")} for r in rows]


def _same_checkpoint(a, b, step):
    sa, sb = (torch.load(p / "m" / str(step) / "state.pt", weights_only=False)["model"]
              for p in (a, b))
    assert sa.keys() == sb.keys()
    assert [k for k in sa if not torch.equal(sa[k], sb[k])] == []
    assert any(k.endswith("running_var") for k in sa)


def test_train_debug_vis_changes_nothing_of_the_run(data, tmp_path):
    tb = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    # Steps 0-2 at test_freq 3: a dump at step 0 and one at the last step.
    extra = ["--set", "test_freq=3", "--set", "batch_size=2"]
    cli(_train_args(data, tmp_path / "vis", 3, "--debug-vis", "--tensorboard", *extra))
    cli(_train_args(data, tmp_path / "plain", 3, *extra))
    debug = tmp_path / "vis" / "log" / "debug"
    steps = sorted({n[:10] for n in os.listdir(debug)})
    assert steps == ["step000000", "step000002"]
    assert {f"step000002-ex{b}.jpg" for b in range(2)} <= set(os.listdir(debug))
    assert not (tmp_path / "plain" / "log" / "debug").exists()
    acc = tb.EventAccumulator(str(tmp_path / "vis" / "log" / "tb"))
    acc.Reload()
    assert [e.step for e in acc.Images("debug/mosaic")] == [0, 2]
    assert _losses(tmp_path / "vis") == _losses(tmp_path / "plain")
    _same_checkpoint(tmp_path / "vis", tmp_path / "plain", 3)


def _launch_two_ranks(args):
    # --standalone: the launcher's store binds a port the OS picks, so no
    # other process can take it between a pick and the bind.
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "stabnet_tpu_torch.cli.main", *args]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]


def test_two_ranks_train_debug_vis(data, tmp_path):
    # One step: the dump comes after it and before the checkpoint, which a
    # forward in training mode would change (or never reach).
    _launch_two_ranks(_train_args(data, tmp_path / "vis", 1, "--data-parallel",
                                  "--debug-vis"))
    _launch_two_ranks(_train_args(data, tmp_path / "plain", 1, "--data-parallel"))
    assert _losses(tmp_path / "vis") == _losses(tmp_path / "plain")
    _same_checkpoint(tmp_path / "vis", tmp_path / "plain", 1)

    # Rank 0's local batch (examples 0 and 1 of the global batch of 4) and
    # no other: the dumped current frame is global example 0's, not 2's.
    debug = tmp_path / "vis" / "log" / "debug"
    assert {n for n in os.listdir(debug) if n.endswith("-Hs.txt")} == {
        f"step000000-ex{b}-Hs.txt" for b in (0, 1)}
    cfg = apply_overrides(CFG, [a for a in LIVE if a != "--set"])
    its = [batch_iterator(str(data / "train"), cfg, seed=0, batch_size=2, shard=(r, 2))
           for r in range(2)]
    raw = augment.prepare_raw(ensure_flow(form_global_batch([next(it) for it in its])))
    x1 = augment.augment_batch(torch.Generator().manual_seed(0),
                               {k: torch.from_numpy(v) for k, v in raw.items()}, cfg)["x1"]
    c = CFG.cur_channel
    dumped = cv2.imread(str(debug / f"step000000-x1-ch{c}.jpg"))[..., 0].astype(np.float32)
    dist = [np.abs(dumped - train_vis._to_u8(x1[b, :, :, c].numpy())[..., 0]).mean()
            for b in (0, 2)]
    assert dist[0] < 3.0 < dist[1], dist
