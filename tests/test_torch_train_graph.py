"""The port's compiled training path: the Siamese step, the eval step and
the augmentation as captured CUDA graphs (the JAX package's `jax.jit` of
`train_step`, `eval_step` and the augmentation), with the loss gates, the
learning rate and Adam's bias corrections computed on the device from the
step and update counters.

On the CPU:
  * `loss_gates` and `learning_rate` of a 0-d device counter equal their
    host forms and the JAX package's, bit for bit, at every gate's boundary
    and around the learning-rate steps;
  * `power_f32` is the correctly rounded float32 power: Adam's bias
    corrections equal optax's at every count up to 200,000 but two (b2 at
    counts 2958 and 3606, one ulp: 6.3e-8 relative), where numpy's float32
    power (the host formula before) missed at 2 counts of b1 and 289 of b2;
  * Adam driven by its device count equals Adam with the host corrections,
    bit for bit, and stays within 1e-7 of each leaf's largest update from
    optax over 6 updates;
  * the step body driven by the device counters equals the host-float step
    (gates, learning rate and bias corrections as host floats) bit for bit
    over 6 steps that cross every gate and a learning-rate step: every loss
    term, parameter, BN statistic, moment and both counters; and each step
    stays within tests/test_torch_train.py's bounds of the JAX step from
    the same state (each loss term 1e-5 relative, BN statistics 1e-6
    absolute; measured: 2.63e-6 and 2.38e-7);
  * a restore between steps is seen by the next step;
  * the augmentation's draws apart from its device body compose to
    `augment_batch`'s batch bit for bit, and the pipeline's batches at a
    fixed seed are those of `augment_batch` over the same raw batches;
  * the launch record keyed by the capturing stream, as a host function;
  * a CPU state and a CPU pipeline never capture (which process groups
    capture: tests/test_torch_dp_graph.py).

The `cuda` tests hold the graphs to the eager functions on a card; they
skip without one.  On a machine with a card and no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_graph.py
"""

import functools
import threading
import types

import numpy as np
import pytest
import torch

from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.data import augment, make_raw_batch, prepare_raw
from stabnet_tpu_torch.data.pipeline import (InputPipeline, augment_compiled,
                                             batch_iterator, ensure_flow)
from stabnet_tpu_torch.models import make_model, scale_theta_head
from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.train import (Adam, TrainState, compute_losses, learning_rate,
                                     loss_gates, make_eval_step, make_train_step,
                                     train_step)
from stabnet_tpu_torch.train import checkpoint as ckpt
from stabnet_tpu_torch.train import train as train_mod
from stabnet_tpu_torch.train.state import power_f32
from stabnet_tpu_torch.utils.graphs import GraphCache

torch.set_num_threads(1)

# Six steps cross every gate: theta-only at 0-1, black from 2, temporal
# from 3, and the learning rate's staircase at 4.
GATES = dict(compute_dtype="float32", do_theta_only_iter=1, do_black_loss_iter=2,
             do_temp_loss_iter=3, step_size=4)
STEPS = 6


def _cfg(**kw):
    return get_config("tiny").replace(**{**GATES, **kw})


def _batch(cfg, seed, device="cpu", part=(0, 1)):
    raw = prepare_raw(make_raw_batch(cfg, cfg.batch_size, seed=seed))
    return augment.augment_batch(torch.Generator().manual_seed(seed),
                                 {k: torch.from_numpy(v).to(device) for k, v in raw.items()},
                                 cfg, part=part)


# --- the schedule on a device counter ----------------------------------------

def _gate_steps():
    cfg = get_config("v2_93")
    edges = (cfg.no_theta_iter, cfg.do_temp_loss_iter, cfg.do_black_loss_iter,
             cfg.do_theta_only_iter, 3)
    return sorted({0, 1} | {e + d for e in edges for d in (-1, 0, 1)})


@pytest.mark.parametrize("theta_10", [-1, 3])
@pytest.mark.parametrize("step", _gate_steps())
def test_loss_gates_on_a_device_counter(step, theta_10):
    """Tensor gates equal the host floats and the JAX package's at 0, 1 and
    each gate's boundary +-1 (`do_theta_10_iter` 3 makes the 10 gate
    live)."""
    import jax.numpy as jnp

    from stabnet_tpu.config import get_config as jax_config
    from stabnet_tpu.train.train import loss_gates as jax_loss_gates

    cfg = get_config("v2_93").replace(do_theta_10_iter=theta_10)
    got = loss_gates(torch.tensor(step), cfg)
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in got.values())
    host = loss_gates(step, cfg)
    want = jax_loss_gates(jnp.asarray(step),
                          jax_config("v2_93").replace(do_theta_10_iter=theta_10))
    assert {k: float(v) for k, v in got.items()} == host
    assert host == {k: float(v) for k, v in want.items()}


def _lr_steps():
    size = get_config("v2_93").step_size
    return sorted({0, 1} | {k * size + d for k in (1, 2, 3, 10) for d in (-1, 0, 1)})


@pytest.mark.parametrize("step", _lr_steps())
def test_learning_rate_on_a_device_counter(step):
    """The tensor learning rate (float32 floor, then lr0 * decay ** p)
    equals the host float and optax's schedule, bit for bit, around each
    staircase step."""
    from stabnet_tpu.config import get_config as jax_config
    from stabnet_tpu.train.state import lr_schedule as jax_lr_schedule

    cfg = get_config("v2_93")
    got = learning_rate(torch.tensor(step), cfg)
    assert got.dtype == torch.float32 and got.dim() == 0
    want = float(jax_lr_schedule(jax_config("v2_93"))(step))
    assert float(got) == learning_rate(step, cfg) == want


def test_bias_corrections_against_optax():
    """1 - b^t from `power_f32`, host and device forms, against optax's
    float32 `1 - b ** count` (int32 count) at every count to 200,000: equal
    but for b2 at counts 2958 and 3606, one ulp (the recorded gap).
    numpy's float32 power, the host formula before, missed optax's at 2
    counts of b1 (from count 4) and 289 of b2."""
    import jax.numpy as jnp

    t = np.arange(1, 200_001)
    for b, gaps, numpy_misses in ((0.9, [], 2), (0.999, [2958, 3606], 289)):
        dev = (1.0 - power_f32(b, torch.from_numpy(t))).numpy()
        host = np.array([np.float32(1) - np.float32(power_f32(b, int(k))) for k in t[:2000]])
        assert np.array_equal(dev[:2000], host)
        want = np.asarray(1 - b ** jnp.asarray(t, dtype=jnp.int32))
        miss = np.nonzero(dev != want)[0]
        assert list(t[miss]) == gaps, (b, t[miss][:10])
        assert np.all(np.abs(dev[miss] - want[miss]) <= np.spacing(want[miss]))
        assert int(np.sum((np.float32(1) - np.float32(b) ** t.astype(np.float32)) != want)) \
            == numpy_misses


# --- Adam on its device count --------------------------------------------------

def _host_adam_update(params, mu, nu, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """Adam with host-float bias corrections and learning rate, in the
    optax order (the port's update before its counters moved to the
    device)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    c1 = float(np.float32(1) - np.float32(power_f32(b1, count)))
    c2 = float(np.float32(1) - np.float32(power_f32(b2, count)))
    with torch.no_grad():
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        den = [d.double().sqrt_().float() for d in torch._foreach_div(nu, c2)]
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)


def _leaves(seed, shapes=((3, 5), (7,), (2, 2, 4))):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(s, generator=g)) for s in shapes]


def test_adam_on_the_device_count_equals_host_corrections():
    cfg = _cfg()
    dev_p, host_p = _leaves(0), _leaves(0)
    opt = Adam(dev_p)
    mu = [torch.zeros_like(p) for p in host_p]
    nu = [torch.zeros_like(p) for p in host_p]
    for t in range(STEPS):
        for a, b, g in zip(dev_p, host_p, _leaves(10 + t)):
            a.grad, b.grad = g.detach().clone(), g.detach().clone()
        opt.update(learning_rate(torch.tensor(t), cfg))
        _host_adam_update(host_p, mu, nu, t + 1, learning_rate(t, cfg))
        for a, b in zip(dev_p + opt.mu + opt.nu, host_p + mu + nu):
            assert torch.equal(a, b)
    assert int(opt.count_t) == STEPS and opt.count == 0     # update() is the device half
    opt.step(learning_rate(STEPS, cfg))
    assert int(opt.count_t) == STEPS + 1 and opt.count == 1


def test_adam_on_the_device_count_matches_optax():
    """Six updates through the learning-rate step, the same gradients into
    optax: each update within 1e-7 of its leaf's largest update (the
    parameters are zeroed before each, so each leaves exactly its update
    in them; the moments carry over)."""
    import jax.numpy as jnp

    from stabnet_tpu.config import get_config as jax_config
    from stabnet_tpu.train.state import make_optimizer as jax_make_optimizer

    cfg = _cfg()
    params = _leaves(0)
    opt = Adam(params)
    tx = jax_make_optimizer(jax_config("tiny").replace(step_size=4))
    zeros = [jnp.zeros(tuple(p.shape), jnp.float32) for p in params]
    st = tx.init(zeros)
    for t in range(STEPS):
        grads = _leaves(10 + t)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.zero_()
                p.grad = g.detach().clone()
        opt.update(learning_rate(torch.tensor(t), cfg))
        upd, st = tx.update([jnp.asarray(g.detach().numpy()) for g in grads], st, zeros)
        for p, u in zip(params, upd):
            u = torch.from_numpy(np.array(u))
            assert float((p.detach() - u).abs().max()) <= 1e-7 * float(u.abs().max()), t


# --- the step body on the device counters ---------------------------------------

@functools.lru_cache(maxsize=None)
def _narrow_weights():
    from tests.test_torch_train import _tiny_variables

    return _tiny_variables()


def _narrow_state(cfg):
    from tests.test_torch_train import NARROW
    from stabnet_tpu_torch.models import convert_flax_variables
    from stabnet_tpu_torch.models.resnet import StabNetRegressor

    model = StabNetRegressor(cfg.in_channels, cfg.theta_dim, dtype=torch.float32, **NARROW)
    model.load_state_dict(convert_flax_variables(_narrow_weights()))
    return TrainState(step=0, model=model.train(), opt=Adam(model.parameters()))


def _host_step(model, mu, nu, step, batch, cfg):
    """The host-float step: gates and learning rate as host floats, Adam's
    bias corrections from the host count."""
    for p in model.parameters():
        p.grad = None
    total, aux = compute_losses(model, batch, cfg, loss_gates(step, cfg))
    total.backward()
    _host_adam_update(list(model.parameters()), mu, nu, step + 1, learning_rate(step, cfg))
    return {k: v.detach() for k, v in aux.items()}


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            [t.clone() for t in state.opt.mu + state.opt.nu])


@functools.lru_cache(maxsize=None)
def _six_steps():
    """(batches, per-step loss terms and snapshots) of the port's compiled
    step on the CPU (the eager body on the device counters)."""
    cfg = _cfg()
    batches = [_batch(cfg, seed) for seed in range(STEPS)]
    state, step = _narrow_state(cfg), make_train_step(cfg)
    losses, snaps = [], []
    for b in batches:
        state, aux = step(state, b)
        losses.append({k: float(v) for k, v in aux.items()})
        snaps.append(_snapshot(state))
    assert state.step == STEPS and state.opt.count == STEPS
    assert int(state.step_t) == STEPS and int(state.opt.count_t) == STEPS
    return batches, losses, snaps


def test_step_body_on_device_counters_equals_the_host_float_step():
    cfg = _cfg()
    batches, losses, snaps = _six_steps()
    ref = _narrow_state(cfg)
    mu = [torch.zeros_like(p) for p in ref.model.parameters()]
    nu = [torch.zeros_like(p) for p in ref.model.parameters()]
    eager = _narrow_state(cfg)
    for i, b in enumerate(batches):
        want = _host_step(ref.model, mu, nu, i, b, cfg)
        eager, aux = train_step(eager, b, cfg)
        assert {k: float(v) for k, v in want.items()} == losses[i] \
            == {k: float(v) for k, v in aux.items()}, i
        model, moments = snaps[i]
        for k, v in ref.model.state_dict().items():
            assert torch.equal(model[k], v) and torch.equal(eager.model.state_dict()[k], v), (i, k)
        for a, b2, c in zip(moments, mu + nu, eager.opt.mu + eager.opt.nu):
            assert torch.equal(a, b2) and torch.equal(c, b2), i
    # Every gate and the learning-rate step were crossed.
    assert losses[0]["temp"] == 0.0 and losses[STEPS - 1]["temp"] > 0.0
    assert learning_rate(STEPS - 1, cfg) < learning_rate(0, cfg)


def _to_flax(template, state):
    """The port's state_dict as Flax variables shaped like `template` (the
    inverse of `convert_flax_variables`)."""
    leaves = {"bias": "bias", "scale": "weight", "mean": "running_mean",
              "var": "running_var", "kernel": "weight"}

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            a = state[".".join(path[1:] + (leaves[k],))].numpy()
            if k == "kernel":
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            out[k] = np.ascontiguousarray(a)
        return out

    return walk(template, ())


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """Per step of `_six_steps`: the JAX package's loss terms and new BN
    statistics of that step from the port's state before it (its weights
    and statistics, the gates of its step; XLA's warp)."""
    import jax
    import jax.numpy as jnp

    from stabnet_tpu.config import get_config as jax_config
    from stabnet_tpu.train.train import compute_losses as jax_compute_losses
    from stabnet_tpu.train.train import loss_gates as jax_loss_gates
    from tests.test_torch_train import _JaxNarrow

    cfg = jax_config("tiny").replace(**GATES)
    model = _JaxNarrow(cfg.theta_dim)

    @jax.jit
    def losses(variables, batch, step):
        _, (aux, stats) = jax_compute_losses(model, variables["params"],
                                             variables["batch_stats"], batch, cfg,
                                             jax_loss_gates(step, cfg), pallas_warp=False)
        return aux, stats

    batches, _, snaps = _six_steps()
    template = _narrow_weights()
    before = [_narrow_state(_cfg()).model.state_dict()] + [m for m, _ in snaps[:-1]]
    out = []
    for i, (b, state) in enumerate(zip(batches, before)):
        aux, stats = losses(_to_flax(template, state),
                            {k: jnp.asarray(t.numpy()) for k, t in b.items()}, jnp.asarray(i))
        out.append(({k: float(a) for k, a in aux.items()},
                    jax.tree_util.tree_map(np.asarray, stats)))
    return out


def test_six_compiled_steps_match_the_jax_step():
    """Each of the six steps within tests/test_torch_train.py's bounds of
    the JAX step from the same state: loss terms 1e-5 relative, BN
    statistics 1e-6 absolute (measured 2.63e-6 and 2.38e-7; the first
    step's, from the file's own state, 1.71e-6 and 1.19e-7)."""
    from stabnet_tpu_torch.models import convert_flax_variables

    _, losses, snaps = _six_steps()
    for i, (want_losses, want_stats) in enumerate(_jax_steps()):
        assert set(losses[i]) == set(want_losses)
        for k, want in want_losses.items():
            np.testing.assert_allclose(losses[i][k], want, rtol=1e-5, atol=0,
                                       err_msg=f"step {i} {k}")
        model = snaps[i][0]
        for name, ref in convert_flax_variables({"batch_stats": want_stats}).items():
            np.testing.assert_allclose(model[name].numpy(), ref.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"step {i} {name}")


def test_a_restore_between_steps_is_seen(tmp_path):
    """Step, save, step, restore, step: the last step is the third step of
    the run without the detour (a restore copies in place, so a captured
    step reads the restored values)."""
    cfg = _cfg()
    batches, losses, snaps = _six_steps()
    state, step = _narrow_state(cfg), make_train_step(cfg)
    state, _ = step(state, batches[0])
    state, _ = step(state, batches[1])
    ckpt.save(str(tmp_path), state)
    state, _ = step(state, batches[5])
    assert state.step == 3
    ids = [id(t) for t in state.opt.mu + list(state.model.parameters())]
    state = ckpt.restore(str(tmp_path), state)
    assert [id(t) for t in state.opt.mu + list(state.model.parameters())] == ids
    assert (state.step, int(state.step_t), state.opt.count, int(state.opt.count_t)) == (2, 2, 2, 2)
    state, aux = step(state, batches[2])
    assert {k: float(v) for k, v in aux.items()} == losses[2]
    for k, v in snaps[2][0].items():
        assert torch.equal(state.model.state_dict()[k], v), k


def test_eval_step_reads_the_device_counter():
    cfg = _cfg()
    state = _narrow_state(cfg)
    batch = _six_steps()[0][0]
    ev = make_eval_step(cfg)
    before = ev(state, batch)
    state.step = 3          # the temporal gate opens at 3
    after = ev(state, batch)
    assert float(before["temp"]) == 0.0 and float(after["temp"]) > 0.0
    assert state.model.training


# --- the augmentation, its draws apart ----------------------------------------------

def _augment_before(generator, raw, cfg, part):
    """`augment_batch` as it was before its draws were split out: draws
    and device work interleaved in one function."""
    B = raw["stable"].shape[0]
    bc = cfg.before_ch
    index, count = part
    mine = slice(index * B, (index + 1) * B)
    p = augment.AugParams(*(t[mine] for t in augment.draw_params(generator, cfg, B * count)))
    Hs = augment.rand_homography(generator, cfg, (2, B * count, bc))[:, mine]
    stable = augment.warp_img(raw["stable"].float() / 255.0 - 0.5, p, cfg)
    unstable = augment.warp_img(raw["unstable"].float() / 255.0 - 0.5, p, cfg)
    frames1, masks1 = augment.add_history_masks(Hs[0], stable[..., 1: 1 + bc], cfg)
    frames2, masks2 = augment.add_history_masks(Hs[1], stable[..., bc + 2: 2 * bc + 2], cfg)
    m1, k1 = augment.warp_points(raw["matches1"], raw["mask1"].bool(), p, cfg)
    m2, k2 = augment.warp_points(raw["matches2"], raw["mask2"].bool(), p, cfg)
    return {
        "x1": torch.cat([masks1, frames1, unstable[..., 0:1]], dim=-1),
        "y1": stable[..., 0:1],
        "x2": torch.cat([masks2, frames2, unstable[..., 1:2]], dim=-1),
        "y2": stable[..., bc + 1: bc + 2],
        "matches1": m1, "mask1": k1.float(), "matches2": m2, "mask2": k2.float(),
        "flow": augment.warp_flow(raw["flow"], p, cfg),
    }


@pytest.mark.parametrize("part", [(0, 1), (1, 2)])
def test_draws_and_device_body_compose_to_augment_batch(part):
    cfg = get_config("tiny")
    assert cfg.input_mask
    raw = {k: torch.from_numpy(v) for k, v in
           prepare_raw(make_raw_batch(cfg, 2, seed=3)).items()}
    want = _augment_before(torch.Generator().manual_seed(7), raw, cfg, part)
    gen = torch.Generator().manual_seed(7)
    draws = augment.draw_augmentation(gen, cfg, 2, part)
    composed = augment.augment_with(raw, draws, cfg)
    batch = augment.augment_batch(torch.Generator().manual_seed(7), raw, cfg, part=part)
    compiled = augment_compiled(GraphCache(), torch.Generator().manual_seed(7), raw, cfg,
                                part, "cpu")
    assert set(want) == set(composed) == set(batch) == set(compiled)
    for k in want:
        for got in (composed, batch, compiled):
            assert torch.equal(got[k], want[k]), k
    # The next draw of the generator is where the old function left it.
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=_drawn(cfg, part)))


def _drawn(cfg, part):
    g = torch.Generator().manual_seed(7)
    _augment_before(g, {k: torch.from_numpy(v) for k, v in
                        prepare_raw(make_raw_batch(cfg, 2, seed=3)).items()}, cfg, part)
    return g


def test_pipeline_batches_at_a_fixed_seed_are_unchanged(tmp_path):
    """InputPipeline's batches (draws, then the compiled augmentation) are
    `augment_batch`'s over the same raw batches with the same generator."""
    from stabnet_tpu_torch.data import write_synthetic_dataset

    cfg = get_config("tiny").replace(batch_size=2)
    write_synthetic_dataset(str(tmp_path), cfg, 6, seed=0)
    pipe = InputPipeline(str(tmp_path), cfg, seed=3, start_step=1, device="cpu")
    gen = torch.Generator().manual_seed(3 * 1_000_003 + 1)
    try:
        for _, raw in zip(range(4), batch_iterator(str(tmp_path), cfg, seed=4)):
            raw = prepare_raw(ensure_flow(raw))
            want = augment.augment_batch(gen, {k: torch.from_numpy(v) for k, v in raw.items()},
                                         cfg)
            got = next(pipe)
            assert set(got) == set(want)
            assert all(torch.equal(got[k], want[k]) for k in want)
    finally:
        pipe.close()
    assert len(pipe.graphs) == 0


# --- launches, captures and the process group, as host functions ----------------------

def test_launch_record_follows_the_capturing_stream(monkeypatch):
    """A launch into a capture of the recorded stream goes into its record
    from any thread (autograd's device thread runs a backward there); a
    capture of another stream with no record of its own falls back to
    the launching thread's record, and outside any capture it counts."""
    local = threading.local()
    monkeypatch.setattr(cuda_warp, "_capturing_stream", lambda: getattr(local, "key", None))
    side = types.SimpleNamespace(device_index=0, stream_id=7)

    def on_stream(key, kernel):
        def run():
            local.key = key
            cuda_warp._launched(kernel)
        worker = threading.Thread(target=run)
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()

    cuda_warp.reset_launch_counts()
    with cuda_warp.recording_launches(side) as record:
        local.key = (0, 7)
        cuda_warp._launched(cuda_warp.bilinear_sample)     # the capturing thread
        local.key = None
        on_stream((0, 7), cuda_warp.bilinear_splat)         # autograd's thread
        on_stream((0, 7), cuda_warp.sample_map_grad)
        on_stream((0, 9), cuda_warp.bilinear_sample)        # another stream: counts
        on_stream(None, cuda_warp.warp_mesh)                # no capture: counts
        assert cuda_warp._stream_records == {(0, 7): record}
    assert record == {cuda_warp.bilinear_sample: 1, cuda_warp.bilinear_splat: 1,
                      cuda_warp.sample_map_grad: 1}
    assert cuda_warp._stream_records == {}
    assert [k.launches for k in cuda_warp.KERNELS] == [1, 1, 0, 0, 0, 0]
    cuda_warp.add_launches(record)
    assert [k.launches for k in cuda_warp.KERNELS] == [2, 1, 0, 0, 1, 1]
    cuda_warp.reset_launch_counts()


def test_cpu_state_and_pipeline_never_capture(monkeypatch):
    class NoGraph:
        def __init__(self, *a, **k):
            raise AssertionError("a CPU path tried to capture a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", NoGraph)
    monkeypatch.setattr(torch.cuda, "graph", NoGraph)
    cfg = _cfg()
    state = _narrow_state(cfg)
    batch = _six_steps()[0][0]
    state, _ = make_train_step(cfg)(state, batch)
    make_eval_step(cfg)(state, batch)
    cache = GraphCache()
    raw = {k: torch.from_numpy(v) for k, v in prepare_raw(make_raw_batch(cfg, 2)).items()}
    augment_compiled(cache, torch.Generator(), raw, cfg, (0, 1), "cpu")
    assert len(state.graphs) == 0 and len(cache) == 0


def test_counters_move_in_pairs():
    state = _narrow_state(_cfg())
    state.step = 41
    state.opt.count = 40
    assert (int(state.step_t), int(state.opt.count_t)) == (41, 40)
    state.advance()
    assert (state.step, state.opt.count) == (42, 41)
    assert (int(state.step_t), int(state.opt.count_t)) == (41, 40)   # the device's own


# --- on the card -------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_state(cfg, card, seed=0):
    model = scale_theta_head(make_model(cfg, torch.Generator().manual_seed(seed)), 0.05)
    model = model.to(card).train()
    return TrainState(step=0, model=model, opt=Adam(model.parameters()))


def _card_run(cfg, card, batches, compiled):
    state = _card_state(cfg, card)
    step = make_train_step(cfg) if compiled else functools.partial(train_step, cfg=cfg)
    out = []
    for b in batches:
        state, aux = step(state, b)
        out.append(({k: v.clone() for k, v in aux.items()},) + _snapshot(state))
    torch.cuda.synchronize()
    return state, out


def _equal_runs(a, b):
    return all(all(torch.equal(x[k], y[k]) for k in x) for ra, rb in zip(a, b)
               for x, y in zip(ra[:2], rb[:2])) and all(
        torch.equal(x, y) for ra, rb in zip(a, b) for x, y in zip(ra[2], rb[2]))


@pytest.mark.cuda
def test_card_train_graph_equals_the_eager_step(card):
    """One training graph across every gate and the learning-rate step,
    against the eager step: torch.equal when two eager runs are, else both
    under cuDNN's and torch's deterministic algorithms; K2 2, K4 1 and K6b
    1 launches per replayed step."""
    cfg = _cfg()
    batches = [_batch(cfg, seed, card) for seed in range(STEPS)]
    _, e1 = _card_run(cfg, card, batches, compiled=False)
    _, e2 = _card_run(cfg, card, batches, compiled=False)
    deterministic = not _equal_runs(e1, e2)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
    try:
        _, eager = _card_run(cfg, card, batches, compiled=False)
        cuda_warp.reset_launch_counts()
        state, graph = _card_run(cfg, card, batches, compiled=True)
        launches = {k.__name__: k.launches for k in cuda_warp.KERNELS}
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    assert len(state.graphs) == 1
    assert state.graphs.stats()[0]["replays"] == STEPS - 1
    assert _equal_runs(graph, eager)
    assert (state.step, int(state.step_t), state.opt.count, int(state.opt.count_t)) == \
        (STEPS,) * 4
    assert launches == {"bilinear_sample": 2 * STEPS, "warp_mesh": 0,
                        "warp_uint8_cf_lowres": 0, "warp_uint8_cf": 0,
                        "bilinear_splat": STEPS, "sample_map_grad": STEPS}


@pytest.mark.cuda
def test_card_eval_graph_and_restore_between_replays(card, tmp_path):
    cfg = _cfg()
    batches = [_batch(cfg, seed, card) for seed in range(4)]
    state, step, ev = _card_state(cfg, card), make_train_step(cfg), make_eval_step(cfg)
    for b in batches[:2]:
        state, _ = step(state, b)
    ckpt.save(str(tmp_path), state)
    want = train_mod.eval_step(state, batches[3], cfg)
    got = ev(state, batches[3])
    got_again = ev(state, batches[3])
    assert all(torch.equal(got[k], want[k]) and torch.equal(got_again[k], want[k])
               for k in want)
    state, _ = step(state, batches[2])
    state = ckpt.restore(str(tmp_path), state)
    state, aux = step(state, batches[2])
    ref = _card_state(cfg, card)
    ref = ckpt.restore(str(tmp_path), ref)
    ref, want_aux = train_step(ref, batches[2], cfg)
    torch.cuda.synchronize()
    assert {k: float(v) for k, v in aux.items()} == {k: float(v) for k, v in want_aux.items()}
    assert len(state.graphs) == 2        # one train and one eval graph


@pytest.mark.cuda
@pytest.mark.parametrize("part", [(0, 1), (1, 2)])
@pytest.mark.parametrize("with_flow", [True, False])
def test_card_augment_graph_equals_augment_batch(card, part, with_flow):
    cfg = get_config("tiny")
    cache = GraphCache()
    gen_graph, gen_eager = torch.Generator().manual_seed(2), torch.Generator().manual_seed(2)
    for seed in range(3):
        raw = {k: torch.from_numpy(v) for k, v in
               prepare_raw(make_raw_batch(cfg, 2, seed=seed)).items()}
        if not with_flow:
            raw.pop("flow")
        got = augment_compiled(cache, gen_graph, raw, cfg, part, card)
        want = augment.augment_batch(gen_eager, {k: v.to(card) for k, v in raw.items()},
                                     cfg, part=part)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert len(cache) == 1 and cache.stats()[0]["replays"] == 2


@pytest.mark.cuda
def test_card_powers_equal_the_host_powers(card):
    """`power_f32` on the card (CUDA's float64 pow, rounded) against the
    host's at every count to 200,000 and every staircase exponent."""
    t = torch.arange(1, 200_001, dtype=torch.int64)
    for b in (0.9, 0.999):
        assert torch.equal(power_f32(b, t.to(card)).cpu(), power_f32(b, t))
    p = torch.arange(0, 38, dtype=torch.float32)
    assert torch.equal(power_f32(0.1, p.to(card)).cpu(), power_f32(0.1, p))
