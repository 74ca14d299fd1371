"""The port's ingestion of raw video pairs and its .mat match loader
against the JAX package, on the CPU (needs OpenCV).

  * `match_frames` and `clips_to_examples` at v2_93's full width, 288x512
    with 3000 matches, on a shaky synthetic pair long enough for two
    examples at its 32-frame span: equal to the JAX functions bit for bit
    (both call the same OpenCV ORB, matcher and RANSAC on the same frames);
  * `make-dataset` through both CLIs on .avi pairs: shards with equal keys
    and arrays, then one TINY-width training step of the port on them with
    the flow estimated on the device;
  * `feature_fetcher.fetch` on a .mat written by scipy: equal to JAX's.
"""

import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from stabnet_tpu.cli.main import main as jax_cli
from stabnet_tpu.config import TINY as JAX_TINY
from stabnet_tpu.config import get_config as jax_config
from stabnet_tpu.config import register as jax_register
from stabnet_tpu.data import feature_fetcher as jax_fetcher
from stabnet_tpu.data import ingest as jax_ingest
from stabnet_tpu_torch.cli.main import main as cli
from stabnet_tpu_torch.config import TINY, get_config, register
from stabnet_tpu_torch.data import feature_fetcher, ingest
from stabnet_tpu_torch.data.records import list_shards, read_shard
from stabnet_tpu_torch.data.synthetic import make_video

# ORB's FAST circle needs more room than TINY's 48x64: a 96x128 sibling,
# registered under one name in both packages, as the JAX package's own
# make-dataset test does.
register(TINY.replace(name="tiny96", height=96, width=128))
jax_register(JAX_TINY.replace(name="tiny96", height=96, width=128))


@pytest.fixture(scope="module")
def shaky_pair():
    """Stable and jittered model-scale uint8 grays of one synthetic scene
    at v2_93's width: 38 frames, two example positions at stride 4."""
    cfg = get_config("v2_93")
    st = make_video(38, cfg.height, cfg.width, seed=5)
    un = make_video(38, cfg.height, cfg.width, seed=5, jitter=4.0)
    gray = [np.stack([ingest._to_u8_gray(f, cfg) for f in clip]) for clip in (st, un)]
    jcfg = jax_config("v2_93")
    assert np.array_equal(gray[0], np.stack([jax_ingest._to_u8_gray(f, jcfg) for f in st]))
    return gray


def test_match_frames_equals_jax_at_full_width(shaky_pair):
    stable, unstable = shaky_pair
    cfg, jcfg = get_config("v2_93"), jax_config("v2_93")
    assert cfg.max_matches == 3000
    for t in (33, 37):
        m, k = ingest.match_frames(stable[t], unstable[t], cfg)
        jm, jk = jax_ingest.match_frames(stable[t], unstable[t], jcfg)
        assert m.shape == (3000, 4) and k.dtype == np.bool_
        assert np.array_equal(m, jm) and np.array_equal(k, jk)
        assert k.sum() >= 8 and np.all(np.abs(m[k]) <= 1.0)


def test_clips_to_examples_equals_jax_at_full_width(shaky_pair):
    stable, unstable = shaky_pair
    got = ingest.clips_to_examples(stable, unstable, get_config("v2_93"))
    want = jax_ingest.clips_to_examples(stable, unstable, jax_config("v2_93"))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.keys() == b.keys() and "flow" not in a
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
        assert a["mask1"].any() and a["mask2"].any()


def test_match_frames_without_opencv_raises(monkeypatch):
    from stabnet_tpu_torch.stream import video_io

    monkeypatch.setattr(video_io, "optional_cv2", lambda: None)
    frame = np.zeros((96, 128), np.uint8)
    with pytest.raises(RuntimeError, match="OpenCV"):
        ingest.match_frames(frame, frame, get_config("tiny96"))


def _textured_clips(H, W, T, seed):
    """Stable and shaken uint8 gray clips (T, H, W) of one blurred noise
    texture that drifts: ORB finds plenty of corners on it, where the
    smooth synthetic scene at 96x128 gives too few."""
    from scipy.ndimage import map_coordinates

    rng = np.random.RandomState(seed)
    big = rng.randint(0, 256, (H + 64, W + 64)).astype(np.float32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, -1, 0)
           + np.roll(big, 1, 1) + np.roll(big, -1, 1)) / 5.0
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    drift = np.cumsum(rng.uniform(-1.0, 1.0, (T, 2)), axis=0)
    shake = rng.uniform(-3.0, 3.0, (T, 2))

    def render(off):
        return np.clip(map_coordinates(big, [ys + 32 + off[1], xs + 32 + off[0]],
                                       order=1, mode="nearest"), 0, 255).astype(np.uint8)

    return (np.stack([render(d) for d in drift]),
            np.stack([render(d + s) for d, s in zip(drift, shake)]))


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """A DeepStab-layout directory with one .avi pair at 96x128, 14 frames
    of a noise texture, on which ORB finds corners."""
    prefix = tmp_path_factory.mktemp("videos")
    clips = _textured_clips(96, 128, 14, seed=4)
    for sub, clip in zip(("stable", "unstable"), clips):
        os.makedirs(prefix / sub)
        w = cv2.VideoWriter(str(prefix / sub / "demo.avi"), cv2.VideoWriter_fourcc(*"MJPG"),
                            30, (128, 96))
        for f in clip:
            w.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
        w.release()
    return prefix


def test_make_dataset_cli_equals_jax(videos, tmp_path, capsys):
    """Both CLIs on the same .avi pair (a bare video name in --list, and a
    missing one skipped) write the same shards."""
    args = ["make-dataset", "--prefix", str(videos), "--list", "demo.avi", "missing.avi",
            "--config", "tiny96", "--stride", "3"]
    cli(args + ["--out", str(tmp_path / "port" / "train")])
    out = capsys.readouterr().out
    assert "wrote 3 examples" in out and "--compute-flow" in out
    jax_cli(args + ["--out", str(tmp_path / "jax" / "train")])
    got, want = (list_shards(str(tmp_path / p / "train")) for p in ("port", "jax"))
    assert [os.path.basename(s) for s in got] == [os.path.basename(s) for s in want]
    for a, b in zip(got, want):
        sa, sb = read_shard(a), read_shard(b)
        assert sa.keys() == sb.keys() and "flow" not in sa
        for key in sa:
            assert sa[key].dtype == sb[key].dtype and np.array_equal(sa[key], sb[key]), key
        assert sa["mask1"].any()

    # One step of the port on the ingested shards, the flow estimated on the
    # device (the shards carry none).
    cli(["train", "--config", "tiny96", "--data", str(tmp_path / "port"),
         "--model-dir", str(tmp_path / "m"), "--log-dir", str(tmp_path / "log"),
         "--steps", "1", "--compute-flow", "--device", "cpu",
         "--set", "batch_size=2", "--set", "do_temp_loss_iter=0"])
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["step"] for r in rows] == [0]
    assert all(np.isfinite(v) for k, v in rows[0].items() if k not in ("step", "tag"))
    assert rows[0]["temp"] != 0.0 and rows[0]["feature1"] != 0.0


def test_feature_fetcher_equals_jax(tmp_path):
    from scipy.io import savemat

    rng = np.random.RandomState(0)
    res = rng.uniform(0, [1280, 720, 1280, 720], (57, 4))
    os.makedirs(tmp_path / "clip7")
    savemat(str(tmp_path / "clip7" / "12.mat"), {"res": res})
    got = feature_fetcher.fetch("clip7", 12, data_dir=str(tmp_path))
    want = jax_fetcher.fetch("clip7", 12, data_dir=str(tmp_path))
    assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
    np.testing.assert_allclose(got, res / [1280, 720, 1280, 720] * 2 - 1, rtol=0, atol=1e-15)
