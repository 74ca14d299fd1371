"""scripts/torch_quality_gate.py, the port's quality gate, against
scripts/quality_gate.py, the JAX package's.

The gate's configuration at several step counts and with overrides, its
defaults and flags, its held-out clips and its report keys and checks equal
the JAX script's.  A plumbing run on the CPU at a toy schedule prints the
whole report; whether it passes is not asserted there (a 4-step model does
not steady video).  Two tests are `slow`: TINY overfits one batch through
every gate phase-in (the port's counterpart of tests/test_convergence.py),
and, on a card, the gate at its defaults passes.
"""

import argparse
import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_gate = _script("quality_gate")
gate = _script("torch_quality_gate")


def _jax_defaults(monkeypatch, capsys, argv=()):
    """The JAX script's parsed arguments, read through its own `main`."""
    monkeypatch.setattr(jax_gate, "run_gate", lambda args: {"pass": True, **vars(args)})
    assert jax_gate.main(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_flags_and_defaults_match_the_jax_gate(monkeypatch, capsys):
    argv = ["--steps", "30", "--set", "lr_decay_rate=0.5", "--set", "disp_freq=7",
            "--clips", "5", "--min-margin", "0.01"]
    for args in ((), argv):
        want = _jax_defaults(monkeypatch, capsys, args)
        want.pop("pass")
        got = vars(gate.parser().parse_args(list(args)))
        # The port's additions: the device; a working directory in TMPDIR.
        assert got.pop("device") == "cuda"
        assert os.path.basename(got.pop("workdir")) == "stabnet_torch_quality_gate"
        want.pop("workdir")
        assert got == want


@pytest.mark.parametrize("steps,overrides", [
    (2500, []), (200, []), (4, []), (1, []), (3000, ["consistency_mul=20"]),
    (600, ["distortion_mul=4", "lr_decay_rate=0.1", "batch_size=4"])])
def test_build_config_matches_the_jax_gate(steps, overrides, tmp_path):
    args = argparse.Namespace(steps=steps, batch_size=8, lr=3e-4, set=overrides,
                              workdir=str(tmp_path))
    want = dataclasses.asdict(jax_gate.build_config(args))
    got = dataclasses.asdict(gate.build_config(args))
    want.pop("mesh_data_axis")   # JAX's mesh; the port has no counterpart
    assert got == want
    assert got["step_size"] == max(2 * steps // 3, 1)


def test_held_out_clips_match_the_jax_gate():
    from stabnet_tpu.config import get_config as jax_config
    from stabnet_tpu_torch.config import get_config

    jitters = [1.5, 2.5, 3.5, 5.0]
    want = jax_gate.held_out_clips(jax_config("tiny"), 5, 6, jitters, seed=3)
    got = gate.held_out_clips(get_config("tiny"), 5, 6, jitters, seed=3)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (6, 48, 64, 3)
        np.testing.assert_array_equal(g, w)


def _dict_keys(func, name):
    """The keys that `func`'s source gives the dict `name`: its literal and
    every `name["key"] = ...` after it."""
    keys = []
    for node in ast.walk(ast.parse(open(func).read())):
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if (isinstance(target, ast.Name) and target.id == name
                and isinstance(node.value, ast.Dict)):
            keys += [k.value for k in node.value.keys]
        elif (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
              and target.value.id == name):
            keys.append(target.slice.value)
    return keys


def test_plumbing_run_prints_every_report_key_and_check(tmp_path, capsys):
    """A toy schedule on the CPU through every part: exit 0 or 1 as the
    report says, the JAX script's keys and checks, every score in (0, 1]."""
    rc = gate.main(["--steps", "4", "--examples", "8", "--clips", "2", "--frames", "16",
                    "--device", "cpu", "--workdir", str(tmp_path / "gate")])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if report["pass"] else 1)
    jax_source = os.path.join(REPO, "scripts", "quality_gate.py")
    assert list(report) == _dict_keys(jax_source, "report")
    assert list(report["checks"]) == _dict_keys(jax_source, "checks")
    assert report["pass"] == all(report["checks"].values())
    assert (report["steps"], report["clips"], report["majority_needed"]) == (4, 2, 2)
    for key in ("stability_input", "stability_trained", "stability_random",
                "cropping_trained", "distortion_trained", "crop_area_trained",
                "distortion_random"):
        assert len(report[key]) == 2 and all(0 < v <= 1 + 1e-6 for v in report[key]), key
    assert np.isfinite(report["final_train_loss"])
    assert os.path.isfile(tmp_path / "gate" / "model" / "4" / "state.pt")


@pytest.mark.slow
def test_overfit_tiny_batch_through_every_gate_phase_in():
    """TINY overfits one fixed batch for 60 steps with the gates phasing in
    at 5 (theta-only off), 20 (black) and 40 (temporal): finite throughout,
    and the image loss halves once theta-only training ends."""
    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.data.augment import augment_batch, prepare_raw
    from stabnet_tpu_torch.data.synthetic import make_raw_batch
    from stabnet_tpu_torch.train import create_train_state, train_step

    cfg = get_config("tiny").replace(batch_size=2, do_theta_only_iter=5,
                                     do_black_loss_iter=20, do_temp_loss_iter=40,
                                     initial_learning_rate=5e-4, step_size=10 ** 9)
    state = create_train_state(cfg, device="cpu")
    raw = {k: torch.from_numpy(v) for k, v in
           prepare_raw(make_raw_batch(cfg, cfg.batch_size, seed=0)).items()}
    batch = augment_batch(torch.Generator().manual_seed(0), raw, cfg)
    img, total = [], []
    for _ in range(60):
        state, aux = train_step(state, batch, cfg)
        img.append(float(aux["img1"]) + float(aux["img2"]))
        total.append(float(aux["total"]))
    img, total = np.asarray(img), np.asarray(total)
    assert np.isfinite(total).all() and np.isfinite(img).all(), total
    assert img[-5:].mean() < 0.5 * img[6], (img[6], img[-5:].mean(), img[::10])
    assert state.step == 60


@pytest.mark.slow
@pytest.mark.cuda
def test_quality_gate_passes_on_the_card(tmp_path):
    """The gate at its defaults (2500 steps, 16 clips of 120 frames) on the
    card, in a process of its own that imports no JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_quality_gate.py"),
         "--workdir", str(tmp_path / "gate")],
        capture_output=True, text=True, timeout=3600, cwd=REPO)
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and report["pass"], (report["checks"], proc.stderr[-2000:])
    assert report["mean_stability_trained"] > report["mean_stability_input"]
