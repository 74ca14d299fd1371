"""The port's quality metrics (stabnet_tpu_torch/eval/metrics.py) against the
JAX package's (stabnet_tpu/eval/metrics.py), on the CPU.

Tolerances: the homography fit 1e-4 relative (an 8x8 f32 solve); the phase
correlation's integer shifts and the circular shifts exactly; the Hann
window 1e-6 (the two libraries' cosines may differ in the last bit); the
three scores on the same homographies 1e-6; `evaluate_clip` on the same gray
frames 1e-3 per score (the two flows differ by up to ~5e-3 px at a few
pixels, tests/test_torch_flow.py); `score_stabilized_clip` 1e-2 per score
(the JAX package's gray comes from OpenCV in uint8, the port's from
`gray_from_color` in float, within 1/255).
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stabnet_tpu.eval import metrics as jm
from stabnet_tpu_torch.eval import metrics as tm
from stabnet_tpu_torch.data.synthetic import make_video
from stabnet_tpu_torch.stream import video_io
from tests.test_metrics import _clip_with_offsets

torch.set_num_threads(1)

HM = np.array([[1.02, 0.01, 3.0], [-0.02, 0.98, -2.0], [1e-4, -1e-4, 1.0]], np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _points(seed=1, n=40):
    src = np.random.RandomState(seed).rand(n, 2).astype(np.float32) * 100
    pts = np.concatenate([src, np.ones((n, 1), np.float32)], axis=-1) @ HM.T
    return src, (pts[:, :2] / pts[:, 2:]).astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", ["exact", "masked", "fallback"])
def test_fit_homographies_matches_jax(case):
    src, dst = _points()
    dst = np.stack([dst, dst + np.float32(0.3)])
    w = None
    if case != "exact":
        dst[:, :10] = 0.0                       # corrupted points (a static border)
        w = np.ones((2, 40), np.float32)
        w[:, :10] = 0.0
        if case == "fallback":                  # too few active points: all of them
            w[1] = 0.0
            w[1, :4] = 1.0
    want = np.asarray(jm.fit_homographies(jnp.asarray(src), jnp.asarray(dst),
                                          None if w is None else jnp.asarray(w)))
    got = tm.fit_homographies(_t(src), _t(dst), None if w is None else _t(w)).numpy()
    assert got.shape == (2, 3, 3)
    assert _rel(got, want) <= 1e-4
    if case != "fallback":
        np.testing.assert_allclose(got[0] / got[0, 2, 2], HM, atol=1e-3)


def test_scores_match_jax_on_the_same_homographies():
    rng = np.random.RandomState(4)
    Hs = np.tile(np.eye(3, dtype=np.float32), (31, 1, 1))
    Hs[:, :2, :2] += rng.uniform(-0.03, 0.03, (31, 2, 2)).astype(np.float32)
    Hs[:, :2, 2] = rng.uniform(-2, 2, (31, 2))
    Hs[:, 2, :2] = rng.uniform(-1e-4, 1e-4, (31, 2))
    Hs *= rng.uniform(0.9, 1.1, (31, 1, 1)).astype(np.float32)   # scale-unnormalized
    for port, jax_fn in ((tm.stability_score, jm.stability_score),
                         (tm.distortion_score, jm.distortion_score),
                         (tm.cropping_score, jm.cropping_score)):
        got, want = float(port(_t(Hs))), float(jax_fn(jnp.asarray(Hs)))
        assert abs(got - want) <= 1e-6, (port.__name__, got, want)


def test_hann_window_is_jnp_hanning():
    for n in (1, 2, 48, 64, 144, 256):
        np.testing.assert_allclose(tm._hann(n), np.asarray(jnp.hanning(n)), rtol=0, atol=1e-6)


def test_global_shift_and_roll_match_jax():
    frames = _clip_with_offsets([(0, 0), (3, -2), (-7, 5), (1, 1)], h=48, w=64)
    a, b = frames[:3], frames[1:]
    sx, sy = tm._global_shift(_t(a), _t(b))
    jsx, jsy = jm._global_shift(jnp.asarray(a), jnp.asarray(b))
    assert sx.dtype == torch.int32
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(sy.numpy(), np.asarray(jsy))
    # Content at p in frame t sits at p + (offset t - offset t+1) in frame t+1.
    np.testing.assert_array_equal(sx.numpy(), [-3, 10, -8])
    np.testing.assert_array_equal(sy.numpy(), [2, -7, 4])
    np.testing.assert_array_equal(
        tm._roll2(_t(b), sx, sy).numpy(),
        np.asarray(jm._roll2(jnp.asarray(b), jsx, jsy)))


def test_grid_rect_helpers_match_jax():
    u = np.random.RandomState(5).randn(3, 48, 64, 2).astype(np.float32)
    src, dst = tm._grid_correspondences(_t(u))
    jsrc, jdst = jm._grid_correspondences(jnp.asarray(u))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
    rect = (5, 7, 40, 55)
    frames = u[..., 0]
    np.testing.assert_array_equal(tm._rect_fill(_t(frames), rect).numpy(),
                                  jm._rect_fill(frames, rect))
    shrink = tm._rect_shrink(48, 64)
    assert shrink == jm._rect_shrink(48, 64)
    np.testing.assert_array_equal(
        tm._rect_mask(dst, torch.tensor(rect, dtype=torch.float32), shrink).numpy(),
        np.asarray(jm._rect_mask(jdst, jnp.asarray(rect, jnp.float32), shrink)))
    for h, w in ((48, 64), (288, 512), (720, 1280), (1080, 1920)):
        assert tm._eval_downscale(h, w) == jm._eval_downscale(h, w)


def _shaky_pair(T=16, h=48, w=64):
    """A shaky input clip and a steadier output of the same scene (motion
    between the two within the flow's tracking range)."""
    path = np.random.RandomState(0).uniform(-1.5, 1.5, (T, 2))
    return (_clip_with_offsets([tuple(p) for p in path], h=h, w=w),
            _clip_with_offsets([tuple(p) for p in 0.3 * path], h=h, w=w))


def test_evaluate_clip_matches_jax():
    inp, out = _shaky_pair()
    rect = (4, 5, 42, 58)
    want = jm.evaluate_clip(out, inp, rect=rect)
    got = tm.evaluate_clip(out, inp, rect=rect, device="cpu")
    assert set(got) == {"stability", "cropping", "distortion"}
    for k in want:
        assert 0.0 < got[k] <= 1.0 + 1e-6
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_area_downscale_is_opencv_inter_area():
    cv2 = pytest.importorskip("cv2")
    frames = np.random.RandomState(6).rand(2, 36, 52).astype(np.float32) - 0.5
    for hw in ((18, 26), (9, 13), (24, 40)):
        got = tm._area_downscale(_t(frames), hw).numpy()
        want = np.stack([cv2.resize(f, hw[::-1], interpolation=cv2.INTER_AREA)
                         for f in frames])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _record_case(T=24, H=48, W=64):
    """(stabilized color frames, model-scale input grays, model size, crop
    rect): a 96x128 clip of one scene, its shakier version as the input."""
    inp = make_video(T, 2 * H, 2 * W, seed=4, jitter=2.0)
    out = make_video(T, 2 * H, 2 * W, seed=4, jitter=0.5)
    in_gray = np.stack([video_io.to_gray_train(f, H, W) for f in inp])
    return out, in_gray, (H, W), (3, 4, 44, 60)


def test_score_stabilized_clip_matches_jax():
    """The JAX package's record (OpenCV gray) against the port's (device
    gray, area down-scale), at the tiny model scale."""
    pytest.importorskip("cv2")
    out, in_gray, hw, rect = _record_case()
    want = jm.score_stabilized_clip(out, in_gray, hw, crop_rect=rect)
    got = tm.score_stabilized_clip(out, in_gray, hw, crop_rect=rect, device="cpu")
    assert set(got) == set(want) == {"stability", "cropping", "distortion",
                                     "stability_input", "crop_area"}
    for k in want:
        assert 0.0 < got[k] <= 1.0 + 1e-6, (k, got[k])
        assert abs(got[k] - want[k]) <= 1e-2, (k, got[k], want[k])


def test_cli_evaluate(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    from stabnet_tpu_torch.cli.main import main

    paths = {}
    for name, jitter in (("in", 2.0), ("out", 0.5)):
        paths[name] = str(tmp_path / f"{name}.avi")
        writer = cv2.VideoWriter(paths[name], cv2.VideoWriter_fourcc(*"MJPG"), 30, (128, 96))
        for f in make_video(10, 96, 128, seed=4, jitter=jitter):
            writer.write(f)
        writer.release()
    main(["evaluate", "--output", paths["out"], "--input", paths["in"], "--config", "tiny",
          "--max-frames", "8", "--device", "cpu"])
    scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(scores) == {"stability", "cropping", "distortion", "frames"}
    assert scores["frames"] == 8
    for k in ("stability", "cropping", "distortion"):
        assert 0.0 < scores[k] <= 1.0 + 1e-6
