"""The port's `doctor` (stabnet_tpu_torch/cli/doctor.py): the JAX package's
six tests (tests/test_doctor.py) ported, and what the card adds.

The behaviour that matters most is the negative one: a wedged card is
REPORTED within the deadline, not waited out, and a missing card is a
failure, never quietly the CPU.  Here, without CUDA, the backend and
kernels checks run with `--device cpu`: the CPU's liveness and every
kernel's plain version on CPU tensors.
"""

import json

import pytest
import torch

from stabnet_tpu.cli.doctor import run_doctor as jax_run_doctor
from stabnet_tpu_torch.cli.doctor import run_doctor


@pytest.fixture(scope="module")
def cpu_report():
    """Every check at `--device cpu`, in one run."""
    return run_doctor(timeout_s=300.0, device="cpu")


def test_host_and_mesh_checks_pass(cpu_report):
    assert cpu_report["checks"]["host"]["ok"]
    assert cpu_report["checks"]["host"]["cpus"] >= 1
    mesh = cpu_report["checks"]["mesh"]
    assert mesh["ok"], mesh
    assert mesh["mesh_devices"] == 8 and mesh["all_reduce_sum"] == 496.0
    assert cpu_report["ok"]


def test_backend_check_reports_cpu_liveness(cpu_report):
    backend = cpu_report["checks"]["backend"]
    assert backend["ok"], backend
    assert backend["device"] == "cpu" and backend["device_count"] == 1
    assert backend["first_compute_seconds"] < 300.0


def test_kernels_check_on_the_cpu_runs_every_plain_version(cpu_report):
    kernels = cpu_report["checks"]["kernels"]
    assert kernels["ok"], kernels
    assert kernels["device"] == "cpu" and kernels["failed"] == []
    assert list(kernels["kernels"]) == ["K1", "K2", "K2m", "K3", "K4", "K6b", "K7",
                                          "K7n"]
    for name, k in kernels["kernels"].items():
        assert k["ok"] and k["launches"] == 0 and k["max_abs_err"] == 0.0, name
        assert k["calls"] == (2 if name == "K2" else 1)   # K2: both edge modes


def test_report_has_the_jax_report_structure(cpu_report):
    """Top level {"ok", "checks"}, each check {"ok", "seconds", ...}; host
    and mesh carry at least the JAX package's keys, the backend its
    liveness keys."""
    jax_report = jax_run_doctor(timeout_s=300.0, checks=["host", "mesh"])
    assert cpu_report.keys() == jax_report.keys() == {"ok", "checks"}
    for name in ("host", "mesh"):
        assert set(jax_report["checks"][name]) <= set(cpu_report["checks"][name]), name
    for name in ("backend", "kernels", "mesh"):
        assert {"ok", "seconds"} <= set(cpu_report["checks"][name]), name
    assert {"enumerate_seconds", "first_compute_seconds", "device_count"} <= set(
        cpu_report["checks"]["backend"])


def test_wedged_backend_is_reported_not_waited_out(monkeypatch):
    monkeypatch.setenv("STABNET_DOCTOR_FAKE_HANG", "backend")
    report = run_doctor(timeout_s=3.0, checks=["backend"])
    backend = report["checks"]["backend"]
    assert backend["ok"] is False
    assert "did not respond" in backend["error"] and "wedged" in backend["error"]
    assert backend["seconds"] < 30.0
    assert report["ok"] is False


def test_total_budget_spans_all_probes(monkeypatch):
    # timeout_s is the TOTAL deadline: with the backend probe wedged and a
    # small budget, the later probes are short-circuited ("budget
    # exhausted"), not each given a full deadline of its own.
    import time

    monkeypatch.setenv("STABNET_DOCTOR_FAKE_HANG", "backend")
    t0 = time.time()
    report = run_doctor(timeout_s=3.0, checks=["backend", "kernels", "mesh"], device="cpu")
    assert time.time() - t0 < 30.0
    assert report["ok"] is False
    assert "wedged" in report["checks"]["backend"]["error"]
    later = [report["checks"]["kernels"], report["checks"]["mesh"]]
    assert any("budget exhausted" in c.get("error", "") for c in later)


def test_empty_and_unknown_checks_are_errors():
    # A vacuous {"checks": {}, "ok": true} must be impossible.
    with pytest.raises(ValueError):
        run_doctor(checks=[])
    with pytest.raises(ValueError):
        run_doctor(checks=["host", "pallas"])


def test_cli_wiring(monkeypatch, capsys):
    # The subcommand parses, runs and prints JSON; a failed check exits 1.
    from stabnet_tpu_torch.cli.main import main

    monkeypatch.setenv("STABNET_DOCTOR_FAKE_HANG", "backend")
    with pytest.raises(SystemExit) as exc:
        main(["doctor", "--only", "backend", "--timeout", "3", "--compact"])
    assert exc.value.code == 1
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] is False


def test_missing_card_fails_and_is_never_the_cpu(capsys):
    """Asked for the card (the default) on a machine without one, the
    backend and kernels checks fail naming CUDA, and doctor exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from stabnet_tpu_torch.cli.main import main

    with pytest.raises(SystemExit) as exc:
        main(["doctor", "--only", "backend", "kernels", "--compact"])
    assert exc.value.code == 1
    report = json.loads(capsys.readouterr().out)
    for name in ("backend", "kernels"):
        check = report["checks"][name]
        assert check["ok"] is False and "CUDA is not available" in check["error"], check
