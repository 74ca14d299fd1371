"""The port's headline bench (stabnet_tpu_torch/bench.py), on the CPU at TINY.

One bench run in a subprocess holds the contract the JAX bench's tests hold
(tests/test_bench_multidev.py): rc 0, JSON headline lines on stdout after
every leg, all six legs, the keys of the JAX bench, run beside it on the same
settings, with the port's documented differences.  The CLI's `bench` runs
beside them.  The twelve cases of the JAX
bench's budget machinery (tests/test_bench_watchdog.py) are ported one for
one against the port's functions; the paired latency percentiles, the FLOP
count and the card's peak are checked at function level.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from stabnet_tpu_torch import bench
from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.ops import cuda_warp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_ENV = dict(
    STABNET_BENCH_DEVICE="cpu",
    STABNET_BENCH_CONFIG="tiny",
    STABNET_BENCH_OUT="48,64",
    STABNET_BENCH_OUT2="32,48",
    STABNET_BENCH_S="1",
    STABNET_BENCH_S2="1",
    STABNET_BENCH_T="9",
    STABNET_BENCH_REPEATS="1",
    # A run takes ~15 s on one core; the budgets leave room for a loaded host.
    STABNET_BENCH_WATCHDOG_S="600",
    STABNET_BENCH_DEADLINE_S="900",
    OMP_NUM_THREADS="1",
)

# The port's stats keys against the JAX bench's: the JAX formula's value
# beside the counted FLOPs in place of XLA's count, the card's power limit
# and the kernels' launch counts.
PORT_ONLY = {"flops_per_frame_g_analytic", "power_limit_w", "kernel_launches"}
JAX_ONLY = {"flops_per_frame_g_xla"}


def _env(extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("STABNET_BENCH_")}
    env["PYTHONPATH"] = REPO
    env.update(extra or {})
    return env


def _bench(args, extra=None, timeout=600):
    return subprocess.run([sys.executable, *args], cwd=REPO, env=_env(extra),
                          capture_output=True, text=True, timeout=timeout)


def _run_bench(extra):
    return _bench(["-m", "stabnet_tpu_torch.bench"], extra, timeout=300)


def _run(body: str):
    return _bench(["-c", body], timeout=120)


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def runs():
    """`python -m stabnet_tpu_torch.bench` and `cli.main bench`, at TINY on
    the CPU, one after the other, while the JAX package's root `bench.py`
    runs on the same settings beside them, on one CPU device as the port."""
    jax_env = {k: v for k, v in TINY_ENV.items() if k != "STABNET_BENCH_DEVICE"}
    jax = subprocess.Popen([sys.executable, "bench.py"], cwd=REPO,
                           env=_env(dict(jax_env, JAX_PLATFORMS="cpu", XLA_FLAGS="")),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = {"module": _bench(["-m", "stabnet_tpu_torch.bench"], TINY_ENV),
               "cli": _bench(["-m", "stabnet_tpu_torch.cli.main", "bench", "--device",
                              "cpu"], jax_env)}
        stdout, stderr = jax.communicate(timeout=600)
    finally:
        jax.kill()
    out["jax"] = subprocess.CompletedProcess(jax.args, jax.returncode, stdout, stderr)
    return out


def test_bench_contract_at_tiny_on_the_cpu(runs):
    r, jax = runs["module"], runs["jax"]
    assert r.returncode == 0, r.stderr[-3000:]
    assert jax.returncode == 0, jax.stderr[-3000:]
    jax_head = json.loads(jax.stdout.strip().splitlines()[-1])
    jax_st = _json_lines(jax.stderr)[-1]
    lines = r.stdout.strip().splitlines()
    heads = [json.loads(ln) for ln in lines]      # every stdout line is JSON
    assert len(heads) == 6                         # one emission per leg
    for h in heads:
        assert h["metric"] == "stabilized_48p_throughput"
        assert h["unit"] == "frames/s/chip"
        assert h["value"] > 0 and h["vs_baseline"] is None
    assert set(heads[-1]) == set(jax_head)
    stats = _json_lines(r.stderr)
    assert len(stats) == 6
    st = stats[-1]
    assert JAX_ONLY <= set(jax_st) and not PORT_ONLY & set(jax_st)
    assert set(st) == (set(jax_st) - JAX_ONLY) | PORT_ONLY
    assert st["device"] == "cpu" and st["n_devices"] == 1 and st["power_limit_w"] is None
    assert st["mfu_vs_bf16_peak"] is None                 # no peak for the CPU
    assert st["flops_per_frame_g"] == bench.model_flops_per_frame(get_config("tiny")) / 1e9
    assert st["flops_per_frame_g_analytic"] == jax_st["flops_per_frame_g"] == round(
        bench.analytic_gflops_per_frame(get_config("tiny")), 4)
    # The plain versions ran: no kernel was launched.
    assert set(st["kernel_launches"]) == {k.__name__ for k in cuda_warp.KERNELS}
    assert not any(st["kernel_launches"].values())
    for k in ("fps_48p_batch1_per_chip", "fps_32p_batch1_per_chip", "fps_48p_single_stream",
              "online_pipelined_wall_fps", "achieved_tflops_per_s_per_chip",
              "online_step_device_resident_fenced_p50_ms"):
        assert st[k] > 0, k
    assert st["online_latency_device_p90_ms"] >= st["online_latency_device_p50_ms"]
    for k in ("online_step_upload_p50_ms", "online_step_dispatch_p50_ms",
              "online_step_compute_readback_p50_ms", "online_step_fence_floor_p50_ms"):
        assert st[k] >= 0, k
    assert "skipping leg" not in r.stderr
    assert "kernels built" not in r.stderr               # nothing is built for the CPU


def test_cli_bench_prints_what_the_module_prints(runs):
    a, b = runs["module"], runs["cli"]
    assert b.returncode == 0, b.stderr[-3000:]
    heads_a = [json.loads(ln) for ln in a.stdout.strip().splitlines()]
    heads_b = [json.loads(ln) for ln in b.stdout.strip().splitlines()]
    assert [set(h) for h in heads_b] == [set(h) for h in heads_a]
    assert [set(s) for s in _json_lines(b.stderr)] == [set(s) for s in _json_lines(a.stderr)]


def test_clip_inputs_are_the_jax_benchs():
    """The bench's clip, bit for bit the JAX bench's (bench.py:292-296):
    the JAX package's make_video tiled to T frames and its to_gray_train."""
    from stabnet_tpu.data.synthetic import make_video
    from stabnet_tpu.stream.video_io import to_gray_train

    cfg, (h, w), T = get_config("tiny"), (48, 64), 11
    gray, color = bench.clip_inputs(cfg, (h, w), T)
    color1 = make_video(8, h, w, seed=0, jitter=4.0)[np.arange(T) % 8][None]
    gray1 = np.stack([to_gray_train(f, cfg.height, cfg.width) for f in color1[0]])[None]
    assert color.dtype == color1.dtype and np.array_equal(color, color1)
    assert gray.dtype == gray1.dtype and np.array_equal(gray, gray1)


def test_paired_percentiles_keep_p90_above_p50():
    # A fence floor with one slow call: subtracting the floor's percentiles
    # from the steps' apart (bench.py:559-562) puts p90 below p50.
    fenced = np.full(7, 2.2e-3)
    floor = np.array([0.1e-3] * 6 + [5e-3])
    fenced_ms, floor_ms = fenced * 1e3, floor * 1e3
    jax_p50 = max(np.percentile(fenced_ms, 50) - np.percentile(floor_ms, 50), 0.0)
    jax_p90 = max(np.percentile(fenced_ms, 90) - np.percentile(floor_ms, 90), 0.0)
    assert jax_p90 < jax_p50
    p50, p90 = bench.paired_percentiles(fenced, floor)
    assert p90 >= p50
    diff = (fenced - floor) * 1e3
    assert [p50, p90] == [np.percentile(diff, 50), np.percentile(diff, 90)]
    rng = np.random.RandomState(0)
    for _ in range(20):
        f, fl = rng.exponential(1e-3, 7), rng.exponential(1e-3, 7)
        p50, p90 = bench.paired_percentiles(f, fl)
        assert p90 >= p50


def _hand_count(cfg) -> int:
    """Two FLOPs per multiply-add of every convolution and dense layer of
    the slim ResNet-v2-50 and its head, from the layer shapes (biases,
    BatchNorm, pooling and ReLU uncounted, as FlopCounterMode counts)."""
    def conv(cin, cout, k, h, w):
        return 2 * cin * cout * k * k * h * w

    h, w = -(-cfg.height // 2), -(-cfg.width // 2)          # 7x7/2 stem
    total = conv(cfg.in_channels, 64, 7, h, w)
    h, w = -(-h // 2), -(-w // 2)                           # 3x3/2 SAME max-pool
    depth_in = 64
    for units, depth, bottleneck, stride in ((3, 256, 64, 2), (4, 512, 128, 2),
                                             (6, 1024, 256, 2), (3, 2048, 512, 1)):
        for u in range(units):
            if depth_in != depth:                           # projection shortcut
                total += conv(depth_in, depth, 1, h, w)
            total += conv(depth_in, bottleneck, 1, h, w)
            s = stride if u == units - 1 else 1             # slim: stride on the last unit
            h, w = -(-h // s), -(-w // s)
            total += conv(bottleneck, bottleneck, 3, h, w) + conv(bottleneck, depth, 1, h, w)
            depth_in = depth
    head = 2048 * 2048 + 2048 * 1024 + 1024 * 512 + 512 * cfg.theta_dim
    return total + 2 * head


def test_flops_are_counted_from_the_model():
    tiny, v2_93 = get_config("tiny"), get_config("v2_93")
    assert bench.model_flops_per_frame(tiny) == _hand_count(tiny) == 490_686_464
    assert bench.model_flops_per_frame(v2_93) == _hand_count(v2_93) == 22_780_889_088
    # The JAX formula's value at v2_93: ResNet-50's 4.1 G multiply-adds
    # taken for FLOPs, so well under the count.
    assert round(bench.analytic_gflops_per_frame(v2_93), 4) == 14.3608


def test_peak_is_the_cards_own(monkeypatch):
    monkeypatch.delenv("STABNET_BENCH_PEAK_TFLOPS", raising=False)
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    with pytest.raises(RuntimeError, match="PEAK_BF16_TFLOPS"):
        bench.peak_tflops("NVIDIA A100-SXM4-80GB")
    monkeypatch.setenv("STABNET_BENCH_PEAK_TFLOPS", "312")
    assert bench.peak_tflops("NVIDIA A100-SXM4-80GB") == 312.0


def test_no_cuda_exits_nonzero_naming_cuda(monkeypatch, capsys):
    """Asked for the card (the default) without one, the bench exits 1
    naming CUDA and prints no headline: it never measures the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for k in list(os.environ):
        if k.startswith("STABNET_BENCH_"):
            monkeypatch.delenv(k)
    # No deadline guard or watchdog thread in this process.
    monkeypatch.setenv("STABNET_BENCH_DEADLINE_S", "0")
    monkeypatch.setenv("STABNET_BENCH_WATCHDOG_S", "0")
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code == 1
    out, err = capsys.readouterr()
    assert "CUDA is not available" in err and out == ""


# --- the budget machinery: tests/test_bench_watchdog.py, one for one ---------

_IMPORT = f"import sys; sys.path.insert(0, {REPO!r})\nfrom stabnet_tpu_torch import bench\n"


def test_zero_disables():
    r = _run(_IMPORT + "import time\nbench._arm_init_watchdog(0.0)\ntime.sleep(1)\n"
             "print('survived')\n")
    assert r.returncode == 0 and "survived" in r.stdout


def test_fires_when_never_disarmed():
    r = _run(_IMPORT + "import time\nbench._arm_init_watchdog(1.0)\ntime.sleep(60)\n"
             "print('unreachable')\n")
    assert r.returncode == 113                        # bench.WATCHDOG_EXIT_CODE
    assert "wedged" in r.stderr and "unreachable" not in r.stdout


def test_silent_when_disarmed():
    r = _run(_IMPORT + "import time\nbench._arm_init_watchdog(0.2).set()\ntime.sleep(1)\n"
             "print('survived')\n")
    assert r.returncode == 0 and "survived" in r.stdout


def test_retry_wrapper_relaunches_on_watchdog_abort():
    # A wedge on every attempt (the hook sleeps before torch is imported):
    # each child exits 113, the parent retries once with budget to spare.
    r = _run_bench(dict(STABNET_BENCH_WATCHDOG_S="0.5", STABNET_BENCH_ATTEMPTS="2",
                        STABNET_BENCH_RETRY_PAUSE_S="0", STABNET_BENCH_DEADLINE_S="600",
                        STABNET_BENCH_FAKE_WEDGE_ATTEMPTS="0,1"))
    assert r.returncode == 113
    assert "retrying" in r.stderr
    assert r.stderr.count("wedged") == 2


def test_no_retry_when_budget_spent():
    # After the first abort the deadline leaves less than MIN_RETRY_S: one
    # watchdog fire and no retry.
    r = _run_bench(dict(STABNET_BENCH_WATCHDOG_S="0.5", STABNET_BENCH_ATTEMPTS="2",
                        STABNET_BENCH_RETRY_PAUSE_S="0", STABNET_BENCH_DEADLINE_S="30",
                        STABNET_BENCH_MIN_RETRY_S="150",
                        STABNET_BENCH_FAKE_WEDGE_ATTEMPTS="0,1"))
    assert r.returncode == 113
    assert "retrying" not in r.stderr
    assert r.stderr.count("wedged") == 1


def test_retry_wrapper_relaunches_on_release_transient():
    # A CUDA error at the first read-back on both attempts: each child exits
    # 114 and the parent retries after a short pause.
    r = _run_bench(dict(TINY_ENV, STABNET_BENCH_ATTEMPTS="2", STABNET_BENCH_RETRY_PAUSE_S="0",
                        STABNET_BENCH_DEADLINE_S="600",
                        STABNET_BENCH_FAKE_TRANSIENT_ATTEMPTS="0,1"))
    assert r.returncode == 114                        # bench.TRANSIENT_INIT_EXIT_CODE
    assert "transient" in r.stderr and "retrying" in r.stderr
    assert r.stderr.count("transient error") == 2
    assert r.stdout == ""


def test_deadline_guard_exits_zero_with_partial_results():
    # Once a leg has emitted, the deadline is a clean exit 0, even while the
    # main thread is blocked.
    r = _run(_IMPORT + "import json, time\nstate = {'emitted': False}\n"
             "bench._arm_deadline_guard(time.time() + 1.0, state)\n"
             "print(json.dumps({'metric': 'stabilized_720p_throughput', 'value': 1.0,"
             " 'unit': 'frames/s/chip', 'vs_baseline': None}), flush=True)\n"
             "state['emitted'] = True\ntime.sleep(60)\nprint('unreachable')\n")
    assert r.returncode == 0
    assert "deadline reached" in r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["metric"] == \
        "stabilized_720p_throughput"
    assert "unreachable" not in r.stdout


def test_deadline_guard_exits_112_without_results():
    r = _run(_IMPORT + "import time\n"
             "bench._arm_deadline_guard(time.time() + 1.0, {'emitted': False})\n"
             "time.sleep(60)\n")
    assert r.returncode == 112                        # bench.NO_MEASUREMENT_EXIT_CODE
    assert "before any measurement" in r.stderr


def test_watchdog_shrinks_to_fit_deadline():
    # 125 s left leaves the default 360 s watchdog max(10, 125 - 120) = 10 s:
    # it fires (113) long before the deadline guard would (112).
    r = _run_bench(dict(STABNET_BENCH_CHILD="1",
                        STABNET_BENCH_DEADLINE_TS=repr(time.time() + 125.0),
                        STABNET_BENCH_FAKE_WEDGE_ATTEMPTS="0"))
    assert r.returncode == 113, r.stderr
    assert "within 10s" in r.stderr


def test_leg_persistence_round_trip(tmp_path):
    path = str(tmp_path / "legs.json")
    stats = {"fps_720p_batch6_per_chip": 876.5, "n_devices": 1}
    headline = {"metric": "stabilized_720p_throughput", "value": 876.5,
                "vs_baseline": None, "fps_1080p_per_chip": 528.8}
    bench._save_legs(path, {"batch", "out2"}, stats, headline)
    saved = bench._load_legs(path)
    assert saved["legs"] == ["batch", "out2"]
    assert saved["stats"] == stats
    assert saved["headline"]["fps_1080p_per_chip"] == 528.8


def test_leg_persistence_tolerates_torn_file(tmp_path):
    path = str(tmp_path / "legs.json")
    with open(path, "w") as f:
        f.write('{"legs": ["batch", "ou')          # a force-exit mid-write
    assert bench._load_legs(path) == {"legs": [], "stats": {}, "headline": {}}
    assert bench._load_legs(str(tmp_path / "nope.json"))["legs"] == []
    assert bench._load_legs(None)["legs"] == []
    bench._save_legs(None, {"x"}, {}, {})             # no deadline: a no-op


def test_persist_path_keyed_by_deadline():
    assert bench._persist_path(float("inf")) is None
    p1 = bench._persist_path(1755740000.0)
    p2 = bench._persist_path(1755740300.0)
    assert p1 != p2 and "1755740000" in p1
    # Two runs started in the same second keep their own files.
    assert bench._persist_path(1755740000.25) != p1


def test_default_budget_fits_driver_window(monkeypatch):
    for var in ("STABNET_BENCH_DEADLINE_S", "STABNET_BENCH_DEADLINE_TS"):
        monkeypatch.delenv(var, raising=False)
    t0 = time.time()
    assert bench._deadline_ts() - t0 <= 540
