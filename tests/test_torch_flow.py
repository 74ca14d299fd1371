"""The port's TV-L1 flow (stabnet_tpu_torch/ops/flow.py) against the JAX
package's (stabnet_tpu/ops/flow.py), on the CPU.

The JAX side runs its XLA path (the strict XLA sampler at coordinates
clipped inside the frame, where it equals the edge-inclusive Pallas
sampler); the port runs K2's plain version in its edge-inclusive mode.
Tolerances: the finite differences and one primal-dual iteration 1e-5
absolute (the same f32 operations; the warp's samples differ in the last
bits); the whole solve at (2, 96, 128) with the default iterations max abs
1e-2 px and mean abs 1e-4 px (measured 4.2e-3 and 4.5e-6: a few pixels
where the data term's thresholding takes the other case after a last-bit
difference, and the iterations carry it on).  The port also passes the JAX
package's own accuracy checks (tests/test_flow.py).
"""

import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stabnet_tpu.ops import flow as jax_flow
from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.ops import flow
from stabnet_tpu_torch.ops.flow import flow_to_sampling, tvl1_flow
from tests.test_flow import _smooth_image, _translate

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_finite_differences_match_jax():
    rng = np.random.RandomState(0)
    im = rng.rand(2, 12, 16).astype(np.float32) * 255
    px, py = (rng.randn(2, 12, 16).astype(np.float32) for _ in range(2))
    for got, want in ((flow._grad_central(_t(im)), jax_flow._grad_central(jnp.asarray(im))),
                      (flow._grad_forward(_t(im)), jax_flow._grad_forward(jnp.asarray(im))),
                      ((flow._divergence(_t(px), _t(py)),),
                       (jax_flow._divergence(jnp.asarray(px), jnp.asarray(py)),))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    # The port's batched layout (B, 2, H, W) gives each component's values.
    u = rng.randn(2, 2, 12, 16).astype(np.float32)
    gx, gy = flow._grad_forward(_t(u))
    for c in range(2):
        wx, wy = jax_flow._grad_forward(jnp.asarray(u[:, c]))
        np.testing.assert_array_equal(gx[:, c].numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy[:, c].numpy(), np.asarray(wy))


def test_one_level_iteration_matches_jax():
    rng = np.random.RandomState(1)
    i0 = _smooth_image(rng, 24, 32) * 255
    i1 = _translate(i0, 1.3, -0.6)
    u0 = rng.uniform(-1, 1, (1, 24, 32, 2)).astype(np.float32)
    kw = dict(num_warps=1, num_iters=1, tau=0.25, lam=0.15, theta=0.3)
    want = np.asarray(jax_flow._tvl1_level(jnp.asarray(i0)[None], jnp.asarray(i1)[None],
                                           jnp.asarray(u0), **kw))
    got = flow._tvl1_level(_t(i0)[None], _t(i1)[None], _t(u0).permute(0, 3, 1, 2), **kw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


def _pair(seed, H, W, shifts):
    rng = np.random.RandomState(seed)
    a = np.stack([_smooth_image(rng, H, W) for _ in shifts])
    b = np.stack([_translate(img, dx, dy) for img, (dx, dy) in zip(a, shifts)])
    return a, b


def test_tvl1_flow_matches_jax_at_default_iterations():
    a, b = _pair(3, 96, 128, [(3.6, -2.3), (-1.2, 0.7)])
    want = np.asarray(jax_flow.tvl1_flow(jnp.asarray(a), jnp.asarray(b)))
    got = tvl1_flow(_t(a), _t(b))
    assert got.shape == (2, 96, 128, 2) and got.dtype == torch.float32
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= 1e-2 and diff.mean() <= 1e-4, (diff.max(), diff.mean())


def test_every_warp_samples_through_k2_edge_inclusive(monkeypatch):
    """One K2 call per level and warp, edge-inclusive, on (B, H, W, 3)
    fields: 20 at the defaults (on CUDA tensors, 20 launches)."""
    calls = []
    original = cuda_warp.bilinear_sample

    def spy(im, x, y, strict_edge=True):
        calls.append((tuple(im.shape), strict_edge))
        return original(im, x, y, strict_edge=strict_edge)

    monkeypatch.setattr(cuda_warp, "bilinear_sample", spy)
    a, b = _pair(0, 40, 72, [(0.5, 0.5)])
    tvl1_flow(_t(a), _t(b), num_iters=2, fine_iters=2)
    shapes = [(1, 40, 72, 3), (1, 16, 32, 3), (1, 16, 16, 3), (1, 16, 16, 3)]
    assert calls == [(s, False) for s in shapes[::-1] for _ in range(5)]


def test_recovers_translation():
    """tests/test_flow.py:36-46 on the port."""
    a, b = _pair(3, 96, 128, [(3.6, -2.3)])
    inner = tvl1_flow(_t(a), _t(b))[0, 16:-16, 16:-16].numpy()
    assert abs(inner[..., 0].mean() - 3.6) < 0.2
    assert abs(inner[..., 1].mean() + 2.3) < 0.2
    assert np.percentile(np.abs(inner[..., 0] - 3.6), 90) < 0.5


def test_zero_motion_gives_zero_flow():
    """tests/test_flow.py:49-54 on the port."""
    i0 = _smooth_image(np.random.RandomState(0), 64, 64)
    u = tvl1_flow(_t(i0)[None], _t(i0)[None], num_warps=2, num_iters=30)
    assert float(u.abs().max()) < 0.05


def test_warp_error_reduction_and_convention():
    """tests/test_flow.py:57-72 on the port: sampling i1 at the flow's
    sampling map reconstructs i0, as the temporal loss consumes it."""
    rng = np.random.RandomState(7)
    i0 = _smooth_image(rng, 96, 128)
    i1 = _translate(i0, -2.2, 1.4)
    samp = flow_to_sampling(tvl1_flow(_t(i0)[None], _t(i1)[None]))
    i1w = cuda_warp.bilinear_sample(_t(i1)[None, ..., None], samp[..., 0].contiguous(),
                                    samp[..., 1].contiguous())[0, ..., 0].numpy()
    c = np.s_[16:-16, 16:-16]
    assert np.abs(i1w - i0)[c].mean() < 0.3 * np.abs(i1 - i0)[c].mean()


def test_flow_to_sampling_matches_record_convention_and_jax():
    """tests/test_flow.py:75-85 on the port, and equal to the JAX function."""
    H, W = 24, 32
    d = np.array([1.5, -0.75], np.float32)
    u = np.broadcast_to(d, (1, H, W, 2))
    got = flow_to_sampling(_t(u)).numpy()[0]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    want = np.stack([2.0 * (xs + d[0]) / W - 1.0, 2.0 * (ys + d[1]) / H - 1.0], axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-6)
    r = np.random.RandomState(2).randn(2, H, W, 2).astype(np.float32)
    np.testing.assert_array_equal(flow_to_sampling(_t(r)).numpy(),
                                  np.asarray(jax_flow.flow_to_sampling(jnp.asarray(r))))


@pytest.mark.slow
def test_tvl1_flow_matches_jax_at_model_scale():
    """The training shape's width: (2, 288, 512), fine_iters 40.  With 12x
    the pixels, more of them take the other thresholding case, and in the
    smooth images' flat regions the flow carries such a flip further: the
    gap is heavy-tailed, max abs 0.298 px at 107 of 589,824 values above
    1e-2, mean 1.24e-5, 99.9th percentile 1.7e-3 (measured by
    scripts/torch_flow_parity.py --model-scale)."""
    a, b = _pair(5, 288, 512, [(2.4, -1.1), (-0.8, 3.1)])
    want = np.asarray(jax_flow.tvl1_flow(jnp.asarray(a), jnp.asarray(b)))
    diff = np.abs(tvl1_flow(_t(a), _t(b)).numpy() - want)
    assert diff.max() <= 0.5 and diff.mean() <= 1e-4, (diff.max(), diff.mean())
    assert np.percentile(diff, 99.9) <= 5e-3


# --- K7: one primal-dual iteration (torch.ops.stabnet.tvl1_iterate) ---------

TAU, LAM, THETA = 0.25, 0.15, 0.3


def _inline_iteration(u, p, rho_c, gx, gy, tau=TAU, lam=LAM, theta=THETA):
    """The body of `_tvl1_level`'s inner loop before it became an op, frozen
    as it was (its warp-invariant set-up included): the arithmetic K7 and
    `tvl1_iterate_plain` are held to."""
    w1 = torch.stack([gx, gy])                        # w[1:] of the warp
    grad_sq = gx * gx + gy * gy
    l_t = lam * theta
    sigma = tau / theta
    eps = 1e-9
    g = w1
    lo_thr, hi_thr = -l_t * grad_sq, l_t * grad_sq
    step_lo, step_hi = (l_t * g).transpose(0, 1), (-l_t * g).transpose(0, 1)
    g_b = g.transpose(0, 1)
    den_sq = grad_sq.clamp_min(eps)[:, None]
    rho = rho_c + gx * u[:, 0] + gy * u[:, 1]
    case_lo = (rho < lo_thr)[:, None]
    case_hi = (rho > hi_thr)[:, None]
    d = torch.where(case_lo, step_lo,
                    torch.where(case_hi, step_hi, -rho[:, None] * g_b / den_sq))
    v = u + d
    u = v + theta * flow._divergence(p[:, :, 0], p[:, :, 1])
    gux, guy = flow._grad_forward(u)
    den = 1.0 + sigma * flow._sqrt(gux * gux + guy * guy)
    p = torch.stack([(p[:, :, 0] + sigma * gux) / den,
                     (p[:, :, 1] + sigma * guy) / den], dim=2)
    return u, p


def _iterate_inputs(seed, B, H, W):
    """Seeded float32 (u, p, rho_c, gx, gy) whose residuals fall in all
    three thresholding cases (|rho| against lam * theta * |grad|^2)."""
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: _t((rng.randn(*s) * scale).astype(np.float32))
    return (f(B, 2, H, W, scale=2.0), f(B, 2, 2, H, W, scale=0.5), f(B, H, W, scale=20.0),
            f(B, H, W, scale=10.0), f(B, H, W, scale=10.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(2, 16, 32), (3, 40, 24), (2, 72, 128)])
def test_tvl1_iterate_equals_the_inline_body(shape, seed):
    """The op on the CPU, over three chained iterations, equals the frozen
    inline body bit for bit, each thresholding case taken."""
    u, p, rho_c, gx, gy = _iterate_inputs(seed, *shape)
    rho = rho_c + gx * u[:, 0] + gy * u[:, 1]
    thr = LAM * THETA * (gx * gx + gy * gy)
    for case in (rho < -thr, rho > thr, (rho >= -thr) & (rho <= thr)):
        assert int(case.sum()) > 0
    want_u, want_p = u, p
    for _ in range(3):
        u, p = torch.ops.stabnet.tvl1_iterate(u, p, rho_c, gx, gy, TAU, LAM, THETA)
        want_u, want_p = _inline_iteration(want_u, want_p, rho_c, gx, gy)
        assert torch.equal(u, want_u) and torch.equal(p, want_p)
    got = flow.tvl1_iterate(want_u, want_p, rho_c, gx, gy, tau=TAU, lam=LAM, theta=THETA)
    want = flow.tvl1_iterate_plain(want_u, want_p, rho_c, gx, gy, tau=TAU, lam=LAM,
                                   theta=THETA)
    assert all(map(torch.equal, got, want))


def test_tvl1_iterate_opcheck_and_fake():
    """The op's schema, fake and CPU dispatch pass `torch.library.opcheck`;
    under FakeTensorMode it gives u's and p's shapes in float32."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _iterate_inputs(3, 2, 9, 14)
    torch.library.opcheck(torch.ops.stabnet.tvl1_iterate.default,
                          args + (TAU, LAM, THETA))
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args]
        u, p = torch.ops.stabnet.tvl1_iterate(*fake, TAU, LAM, THETA)
    assert (tuple(u.shape), tuple(p.shape)) == ((2, 2, 9, 14), (2, 2, 2, 9, 14))
    assert u.dtype == p.dtype == torch.float32


@pytest.mark.parametrize("fault", ["dtype", "strides", "shape", "n-dtype", "n-strides",
                                   "n-shape", "n-negative", "n-off-chip"])
def test_tvl1_iterate_refuses(fault):
    """What the kernel does not take is refused on every device: float64,
    a non-contiguous tensor, or p of another size than u; the on-chip op
    (`tvl1_iterate_n`, faults "n-...") refuses the same, a negative count,
    and images whose band would not fit on chip (the finest metrics
    level)."""
    op, _, fault = fault.rpartition("-")
    shape = (1, 144, 256) if fault == "chip" else (2, 8, 16)
    u, p, rho_c, gx, gy = _iterate_inputs(4, *shape)
    n = -1 if fault == "negative" else 2
    if fault == "dtype":
        gx = gx.double()
    elif fault == "strides":
        u = u.transpose(2, 3).contiguous().transpose(2, 3)
    elif fault == "shape":
        p = p[..., :8, :15].contiguous()
    if op:
        with pytest.raises(ValueError, match="tvl1_iterate_n"):
            flow.tvl1_iterate_n(u, p, rho_c, gx, gy, n, tau=TAU, lam=LAM, theta=THETA)
        return
    with pytest.raises(ValueError, match="tvl1_iterate"):
        flow.tvl1_iterate(u, p, rho_c, gx, gy, tau=TAU, lam=LAM, theta=THETA)


@pytest.mark.parametrize("shape,n", [((2, 16, 32), 5), ((3, 37, 45), 4), ((1, 72, 128), 3),
                                     ((2, 5, 7), 6), ((2, 16, 32), 0)])
def test_tvl1_iterate_n_equals_n_iterations(shape, n):
    """The on-chip op's plain version (the op on the CPU) equals n chained
    `tvl1_iterate_plain` calls bit for bit, ragged and single-image shapes
    among them, each thresholding case taken; fresh tensors, the inputs
    untouched, copies of them at n = 0."""
    args = _iterate_inputs(5, *shape)
    kept = [t.clone() for t in args]
    got = torch.ops.stabnet.tvl1_iterate_n(*args, n, TAU, LAM, THETA)
    want = args[:2]
    for _ in range(n):
        want = flow.tvl1_iterate_plain(*want, *args[2:], tau=TAU, lam=LAM, theta=THETA)
    assert all(map(torch.equal, got, want))
    assert all(map(torch.equal, flow.tvl1_iterate_n(*args, n, tau=TAU, lam=LAM,
                                                    theta=THETA), want))
    assert all(map(torch.equal, args, kept))
    assert not any(g.data_ptr() == a.data_ptr() for g in got for a in args)


def test_tvl1_iterate_n_opcheck_and_fake():
    """The on-chip op's schema, fake and CPU dispatch pass
    `torch.library.opcheck`; under FakeTensorMode it gives u's and p's
    shapes in float32, and refuses what the op refuses."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _iterate_inputs(6, 2, 9, 14)
    torch.library.opcheck(torch.ops.stabnet.tvl1_iterate_n.default,
                          args + (3, TAU, LAM, THETA))
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args]
        u, p = torch.ops.stabnet.tvl1_iterate_n(*fake, 3, TAU, LAM, THETA)
        with pytest.raises(ValueError, match="tvl1_iterate_n"):
            torch.ops.stabnet.tvl1_iterate_n(*fake, -1, TAU, LAM, THETA)
    assert (tuple(u.shape), tuple(p.shape)) == ((2, 2, 9, 14), (2, 2, 2, 9, 14))
    assert u.dtype == p.dtype == torch.float32


@pytest.mark.parametrize("shape,fine_iters,onchip,launches,px,onchip_px", [
    ((32, 144, 256), 100, [False, True, True, True], 515, 778_240_000, 188_416_000),
    ((10, 288, 512), 40, [False, False, True, True], 710, 535_552_000, 56_320_000),
])
def test_onchip_levels_of_the_pyramids(shape, fine_iters, onchip, launches, px, onchip_px):
    """The rule (`onchip_rows`, recorded as `Tvl1Level.onchip`): the
    metrics chunk's three coarse levels go on chip, (32, 144, 256) stays on
    one launch an iteration; training's two coarsest, (10, 288, 512) and
    (10, 144, 256) stay.  Each on-chip level is one launch a warp, a band
    within the block's pixels and the image within four blocks."""
    levels = flow.tvl1_schedule(*shape, fine_iters=fine_iters)
    assert [lv.onchip for lv in levels] == onchip
    assert [lv.onchip for lv in levels] == [flow.onchip_rows(*lv.shape[1:]) > 0
                                            for lv in levels]
    assert sum(lv.launches for lv in levels) == launches
    assert sum(lv.px for lv in levels) == px
    assert sum(lv.px for lv in levels if lv.onchip) == onchip_px
    for lv in levels:
        _, h, w = lv.shape
        rows = flow.onchip_rows(h, w)
        assert lv.launches == lv.warps * (1 if lv.onchip else lv.iters)
        if lv.onchip:
            assert rows * w <= flow.ONCHIP_BLOCK_PX and -(-h // rows) <= flow.ONCHIP_CLUSTER
        else:
            assert -(-h // flow.ONCHIP_CLUSTER) * w > flow.ONCHIP_BLOCK_PX


def test_onchip_levels_run_as_one_call_a_warp(monkeypatch):
    """`tvl1_flow_eager` calls the on-chip op once a warp at the levels the
    schedule puts on chip and K7 once an iteration elsewhere, and the flow
    equals the one with every level on K7 bit for bit."""
    a, b = _pair(2, 40, 72, [(0.8, -0.4)])
    kw = dict(num_iters=4, fine_iters=3)
    calls = []
    for name in ("tvl1_iterate", "tvl1_iterate_n"):
        original = getattr(flow, name)
        monkeypatch.setattr(flow, name, lambda *x, _f=original, _n=name, **k: (
            calls.append((_n, tuple(x[2].shape))), _f(*x, **k))[1])
    got = flow.tvl1_flow_eager(_t(a), _t(b), **kw)
    sched = flow.tvl1_schedule(1, 40, 72, **kw)
    want_calls = []
    for lv in sched[::-1]:
        per_warp = [("tvl1_iterate_n", lv.shape)] if lv.onchip else \
            [("tvl1_iterate", lv.shape)] * lv.iters
        want_calls += per_warp * lv.warps
    assert calls == want_calls
    monkeypatch.setattr(flow, "onchip_rows", lambda h, w: 0)
    assert not any(lv.onchip for lv in flow.tvl1_schedule(1, 40, 72, **kw))
    assert torch.equal(flow.tvl1_flow_eager(_t(a), _t(b), **kw), got)


@pytest.mark.parametrize("shape,fine_iters,want", [
    ((32, 144, 256), 100, [(144, 256), (72, 128), (32, 64), (16, 32)]),
    ((10, 288, 512), 40, [(288, 512), (144, 256), (72, 128), (32, 64)]),
])
def test_tvl1_schedule_is_the_pyramid_the_flow_runs(monkeypatch, shape, fine_iters, want):
    """`tvl1_schedule` gives the shapes and iterations `tvl1_flow_eager`
    runs its levels at (the levels stubbed: only the pyramid is built)."""
    ran = []

    def level(i0, i1, u, *, num_warps, num_iters, **kw):
        ran.append((tuple(i0.shape), num_warps, num_iters))
        return torch.zeros((i0.shape[0], 2) + tuple(i0.shape[1:]))

    monkeypatch.setattr(flow, "_tvl1_level", level)
    B = shape[0]
    a = torch.rand(shape)
    flow.tvl1_flow_eager(a, a, fine_iters=fine_iters)
    sched = flow.tvl1_schedule(*shape, fine_iters=fine_iters)
    assert [lv.shape for lv in sched] == [(B,) + hw for hw in want]
    assert [(lv.shape, lv.warps, lv.iters) for lv in sched] == ran[::-1]
    assert [lv.iters for lv in sched] == [fine_iters, 100, 100, 100]


def test_score_pairs_counts_the_flow_iterations():
    """On a tiny clip scored on the CPU under the profiler, each
    `score.pairs` span's `tvl1_launches`, `tvl1_px` and `tvl1_onchip_px`
    are its chunks' K7 launches on the card, pixel updates and those of the
    on-chip launches, as the schedule gives them: at 24 x 32 every level
    fits on chip, 5 launches a level; a metrics chunk at 144 x 256 makes
    515 (test_onchip_levels_of_the_pyramids)."""
    from torch.profiler import ProfilerActivity, profile

    from stabnet_tpu_torch.eval.metrics import _EVAL_CHUNK, _FINE_ITERS, score_stabilized_clip
    from stabnet_tpu_torch.utils.profiling import TRACER

    rng = np.random.RandomState(5)
    frames = (rng.rand(3, 24, 32, 3) * 255).astype(np.uint8)
    gray = rng.rand(3, 24, 32).astype(np.float32)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        score_stabilized_clip(frames, gray, (24, 32), device="cpu")
    pairs = [s for s in TRACER.spans(t0, time.time_ns()) if s.name == "score.pairs"]
    sched = flow.tvl1_schedule(_EVAL_CHUNK, 24, 32, fine_iters=_FINE_ITERS)
    px = sum(lv.warps * lv.iters * lv.shape[0] * lv.shape[1] * lv.shape[2] for lv in sched)
    assert all(lv.onchip for lv in sched)
    assert len(pairs) == 3            # output and input stability, cross-video
    for s in pairs:
        assert s.counters["tvl1_launches"] == sum(lv.launches for lv in sched) == 5 * 4
        assert s.counters["tvl1_px"] == px
        assert s.counters["tvl1_onchip_px"] == px
