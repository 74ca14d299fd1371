"""The port's data layer against the JAX package, on the CPU.

  * synthetic raw examples: equal to the JAX package's, bit for bit (the
    same numpy RandomState draws);
  * the augmentation at fixed `AugParams` (and fixed homographies): the JAX
    functions' results within 1e-5 absolute (the same f32 formulas, the
    resize as a matrix product in another library); the random draws
    cannot equal `jax.random`'s, so their ranges are property tests;
  * record shards: each package reads the other's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from stabnet_tpu.config import get_config as jax_config
from stabnet_tpu.data import augment as jax_augment
from stabnet_tpu.data import records as jax_records
from stabnet_tpu.data.synthetic import make_raw_batch as jax_make_raw_batch
from stabnet_tpu.ops.resize import resize_bilinear_hwc as jax_resize_bilinear_hwc
from stabnet_tpu.ops.resize import resize_crop_hwc as jax_resize_crop_hwc
from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.data import augment, records
from stabnet_tpu_torch.data.pipeline import InputPipeline, ensure_flow, prefetch
from stabnet_tpu_torch.data.synthetic import make_raw_batch
from stabnet_tpu_torch.ops.resize import resize_bilinear_hwc, resize_crop_hwc

torch.set_num_threads(1)

CFG = get_config("tiny")
JCFG = jax_config("tiny")
# (crop_h, crop_w, flip, contrast, brightness) per example, inside the ranges.
PARAMS = [(0, 0, False, 1.0, 0.0), (4, 6, True, 0.61, 0.1), (5, 1, True, 1.43, -0.12)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_params():
    cols = list(zip(*PARAMS))
    return augment.AugParams(torch.tensor(cols[0]), torch.tensor(cols[1]),
                             torch.tensor(cols[2]), torch.tensor(cols[3], dtype=torch.float32),
                             torch.tensor(cols[4], dtype=torch.float32))


def _jax_params(b):
    ch, cw, flip, c, br = PARAMS[b]
    return jax_augment.AugParams(jnp.asarray(ch, jnp.int32), jnp.asarray(cw, jnp.int32),
                                 jnp.asarray(flip), jnp.asarray(c, jnp.float32),
                                 jnp.asarray(br, jnp.float32))


def test_make_raw_batch_equals_jax_bit_for_bit():
    got = make_raw_batch(CFG, 2, seed=3)
    want = jax_make_raw_batch(JCFG, 2, seed=3)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_resize_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.uniform(-0.5, 0.5, (3, CFG.height, CFG.width, 5)).astype(np.float32)
    big = augment.big_size(CFG)
    got = resize_crop_hwc(_t(img), big, torch.tensor([0, 4, 5]), torch.tensor([0, 6, 1]),
                          (CFG.height, CFG.width)).numpy()
    for b, (ch, cw) in enumerate([(0, 0), (4, 6), (5, 1)]):
        want = np.asarray(jax_resize_crop_hwc(jnp.asarray(img[b]), big, jnp.asarray(ch),
                                              jnp.asarray(cw), (CFG.height, CFG.width)))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(resize_bilinear_hwc(_t(img[0]), (30, 41)).numpy(),
                               np.asarray(jax_resize_bilinear_hwc(jnp.asarray(img[0]), (30, 41))),
                               rtol=0, atol=1e-5)


def test_warp_img_flow_points_match_jax():
    raw = make_raw_batch(CFG, 3, seed=1)
    stable = raw["stable"].astype(np.float32) / 255.0 - 0.5
    p = _port_params()
    img = augment.warp_img(_t(stable), p, CFG).numpy()
    flow = augment.warp_flow(_t(raw["flow"]), p, CFG).numpy()
    pts, mask = augment.warp_points(_t(raw["matches1"]), _t(raw["mask1"]), p, CFG)
    for b in range(3):
        jp = _jax_params(b)
        np.testing.assert_allclose(
            img[b], np.asarray(jax_augment.warp_img(jnp.asarray(stable[b]), jp, JCFG)),
            rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            flow[b], np.asarray(jax_augment.warp_flow(jnp.asarray(raw["flow"][b]), jp, JCFG)),
            rtol=0, atol=1e-5)
        wp, wm = jax_augment.warp_points(jnp.asarray(raw["matches1"][b]),
                                         jnp.asarray(raw["mask1"][b]), jp, JCFG)
        np.testing.assert_allclose(pts[b].numpy(), np.asarray(wp), rtol=0, atol=1e-5)
        assert np.array_equal(mask[b].numpy(), np.asarray(wm))
    assert not mask.all() and mask.any()          # some points leave the frame


def test_homography_oob_mask_matches_jax():
    rng = np.random.RandomState(2)
    lo, hi = np.array(CFG.rand_h_min()), np.array(CFG.rand_h_max())
    Hs = (lo + rng.rand(4, 3, 3) * (hi - lo)).astype(np.float32)
    got = augment.homography_oob_mask(_t(Hs), CFG.height, CFG.width).numpy()
    for b in range(4):
        want = np.asarray(jax_augment.homography_oob_mask(jnp.asarray(Hs[b]), CFG.height,
                                                          CFG.width))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-5)
    assert 0 < got.mean() < 1


def test_history_masks_paint_minus_one():
    gen = torch.Generator().manual_seed(3)
    Hs = augment.rand_homography(gen, CFG, (2, CFG.before_ch))
    hist = torch.zeros((2, CFG.height, CFG.width, CFG.before_ch))
    frames, masks = augment.add_history_masks(Hs, hist, CFG)
    assert frames.shape == masks.shape == hist.shape
    assert set(np.unique(masks.numpy())) <= {0.0, 1.0}
    assert torch.all(frames[masks == 1] == -1) and torch.all(frames[masks == 0] == 0)
    expect = augment.homography_oob_mask(Hs, CFG.height, CFG.width).permute(0, 2, 3, 1)
    assert torch.equal(masks, expect)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), batch=st.integers(1, 8))
def test_draw_params_ranges(seed, batch):
    p = augment.draw_params(torch.Generator().manual_seed(seed), CFG, batch)
    bh, bw = augment.big_size(CFG)
    assert p.crop_h.shape == (batch,)
    assert bool(((p.crop_h >= 0) & (p.crop_h < bh - CFG.height)).all())
    assert bool(((p.crop_w >= 0) & (p.crop_w < bw - CFG.width)).all())
    assert torch.equal(p.flip, (p.crop_h + p.crop_w) % 2 == 1)
    assert bool(((p.contrast >= 0.5) & (p.contrast <= 1.5)).all())
    assert bool((p.brightness.abs() <= 32.0 / 255.0).all())


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_rand_homography_ranges(seed):
    H = augment.rand_homography(torch.Generator().manual_seed(seed), CFG, (3, 5))
    lo = torch.tensor(CFG.rand_h_min(), dtype=torch.float32)
    hi = torch.tensor(CFG.rand_h_max(), dtype=torch.float32)
    assert H.shape == (3, 5, 3, 3)
    assert bool(((H >= lo) & (H <= hi)).all())
    assert bool((H[..., 2, 2] == 1).all())


def test_augment_batch_shapes_and_ranges():
    raw = augment.prepare_raw(make_raw_batch(CFG, 2, seed=7))
    out = augment.augment_batch(torch.Generator().manual_seed(0),
                                {k: _t(v) for k, v in raw.items()}, CFG)
    assert out["x1"].shape == (2, CFG.height, CFG.width, CFG.in_channels)
    assert out["y2"].shape == (2, CFG.height, CFG.width, 1)
    assert out["flow"].shape == (2, CFG.height, CFG.width, 2)
    assert out["mask1"].dtype == torch.float32
    frames = out["x1"][..., CFG.before_ch:]
    assert frames.max() <= 0.5 + 1e-6 and frames.min() >= -1.0 - 1e-6
    assert not torch.allclose(out["x1"][0], out["x1"][1])
    one = augment.augment_example(torch.Generator().manual_seed(0),
                                  {k: _t(v)[0] for k, v in raw.items()}, CFG)
    assert one["x1"].shape == (CFG.height, CFG.width, CFG.in_channels)


def test_augment_geometry_consistency():
    """A bright dot lands where the point transform says (the reference
    couples image and point augmentation through shared draws)."""
    for trial in range(4):
        img = np.full((1, CFG.height, CFG.width, 1), -0.5, np.float32)
        py, px = CFG.height // 2 + trial * 2, CFG.width // 2 - trial * 3
        img[0, py - 1: py + 2, px - 1: px + 2] = 0.5
        nx = px / CFG.width * 2 - 1 + 1.0 / CFG.width
        ny = py / CFG.height * 2 - 1 + 1.0 / CFG.height
        p = augment.draw_params(torch.Generator().manual_seed(trial), CFG, 1)
        warped = augment.warp_img(_t(img), p, CFG)[0, ..., 0].numpy()
        pts, mask = augment.warp_points(torch.tensor([[[nx, ny, nx, ny]]]),
                                        torch.tensor([[True]]), p, CFG)
        if not bool(mask[0, 0]):
            continue
        ax = int(np.clip(round((float(pts[0, 0, 0]) + 1) / 2 * CFG.width), 1, CFG.width - 2))
        ay = int(np.clip(round((float(pts[0, 0, 1]) + 1) / 2 * CFG.height), 1, CFG.height - 2))
        # The dot (the brightest pixels, whatever the photometry) is there.
        assert warped[ay - 3: ay + 4, ax - 3: ax + 4].max() == warped.max() > warped.min(), trial


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_round_trip_between_packages(tmp_path, writer):
    path = str(tmp_path / "ds")
    write = records.write_synthetic_dataset if writer == "port" else \
        jax_records.write_synthetic_dataset
    write(path, CFG if writer == "port" else JCFG, num_examples=5, seed=2, shard_size=2)
    port = list(records.iterate_examples(path, shuffle=False))
    jax_side = list(jax_records.iterate_examples(path, shuffle=False))
    assert len(port) == len(jax_side) == 5
    for a, b in zip(port, jax_side):
        assert set(a) == set(b) == set(records.SHARD_KEYS)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    # Shuffled streams walk the same order in both packages.
    order = [e["flow"][0, 0, 0] for e in records.iterate_examples(path, seed=4)]
    jorder = [e["flow"][0, 0, 0] for e in jax_records.iterate_examples(path, seed=4)]
    assert order == jorder


def test_pipeline_batches_and_start_step(tmp_path):
    path = str(tmp_path / "train")
    records.write_synthetic_dataset(path, CFG, num_examples=6, shard_size=3)

    def first(start_step):
        pipe = InputPipeline(path, CFG, seed=0, start_step=start_step, device="cpu")
        try:
            return next(pipe)["x1"]
        finally:
            pipe.close()

    a, b, c = first(0), first(100), first(0)
    assert a.shape == (CFG.batch_size, CFG.height, CFG.width, CFG.in_channels)
    assert torch.equal(a, c) and not torch.equal(a, b)


def test_pipeline_errors_reach_the_consumer():
    def broken():
        yield 1
        raise RuntimeError("worker died")

    it = prefetch(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="worker died"):
        next(it)
    with pytest.raises(ValueError, match="--compute-flow"):
        ensure_flow({"stable": np.zeros(1)})


def _flowless_shards(path, n=4):
    from stabnet_tpu_torch.data.synthetic import make_raw_example

    path = str(path)
    records.write_shards(path, [{k: v for k, v in make_raw_example(CFG, seed=i).items()
                                 if k != "flow"} for i in range(n)], shard_size=n)
    return path


def _batches(path, k, **kw):
    pipe = InputPipeline(path, CFG, seed=5, device="cpu", **kw)
    try:
        return [next(pipe) for _ in range(k)]
    finally:
        pipe.close()


def test_pipeline_computes_flow_for_flowless_shards(tmp_path):
    """tests/test_flow.py:89 on the port: shards without a flow field train
    with `compute_flow`; the batch's flow is the TV-L1 flow of its own
    augmented stable pair in the sampling convention.  Without it, the
    error stays."""
    from stabnet_tpu_torch.ops.flow import flow_to_sampling, tvl1_flow

    path = _flowless_shards(tmp_path / "flowless")
    with pytest.raises(ValueError, match="--compute-flow"):
        _batches(path, 1)
    (b,) = _batches(path, 1, compute_flow=True)
    assert b["flow"].shape == (CFG.batch_size, CFG.height, CFG.width, 2)
    want = flow_to_sampling(tvl1_flow(b["y1"][..., 0], b["y2"][..., 0]))
    assert torch.equal(b["flow"], want)
    # The same augmented batches as a pipeline over shards with flow: the
    # record flow is dropped before the upload, the rest is unchanged.
    full = str(tmp_path / "full")
    records.write_synthetic_dataset(full, CFG, num_examples=4, shard_size=4)
    (ref,) = _batches(full, 1)
    (got,) = _batches(full, 1, compute_flow=True)
    assert torch.equal(ref["y1"], got["y1"]) and torch.equal(got["flow"], b["flow"])


def test_pipeline_skips_flow_until_gate_step(tmp_path):
    """tests/test_flow.py:133 on the port: batches before `flow_from_step`
    carry the zero-motion map; from it on, the TV-L1 flow (counted from
    `start_step`)."""
    from stabnet_tpu_torch.ops.flow import flow_to_sampling

    path = _flowless_shards(tmp_path / "flowless")
    b0, b1 = _batches(path, 2, compute_flow=True, flow_from_step=1)
    ident = flow_to_sampling(torch.zeros((CFG.batch_size, CFG.height, CFG.width, 2)))
    assert torch.equal(b0["flow"], ident)
    _, r1 = _batches(path, 2, compute_flow=True)
    assert torch.equal(b1["flow"], r1["flow"]) and not torch.equal(b1["flow"], ident)
    (late,) = _batches(path, 1, compute_flow=True, flow_from_step=1, start_step=1)
    assert not torch.equal(late["flow"], ident)


def test_cli_train_compute_flow_on_flowless_shards(tmp_path):
    """`train --compute-flow --steps 2` on shards without a flow field, with
    the temporal loss live from step 0."""
    import json

    from stabnet_tpu_torch.cli.main import main

    data = tmp_path / "data"
    _flowless_shards(data / "train")
    base = ["train", "--config", "tiny", "--data", str(data), "--model-dir",
            str(tmp_path / "models"), "--log-dir", str(tmp_path / "log"), "--device", "cpu",
            "--set", "compute_dtype=float32", "--set", "do_temp_loss_iter=0", "--steps", "2"]
    with pytest.raises(ValueError, match="--compute-flow"):
        main(base)
    main(base + ["--compute-flow"])
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if r["tag"] == "train"] == [0, 1]
    assert all(np.isfinite(r["total"]) and r["temp"] > 0 for r in rows)
