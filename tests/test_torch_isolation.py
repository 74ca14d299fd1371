"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package (and TensorFlow only inside `compat.load_tf_checkpoint`), it runs on
CUDA unless the CPU is asked for, and its chip smoke script refuses to report
success without a card."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import stabnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(stabnet_tpu_torch.__path__,
                                               "stabnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 40, names
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "orbax", "stabnet_tpu", "tensorflow")
             or m.startswith(("jax.", "flax.", "orbax.", "stabnet_tpu.", "tensorflow.")))
assert not bad, bad
print("imported", len(names))
"""


def _run(args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = _run(["-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device works")
    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.models import make_model
    from stabnet_tpu_torch.stream import StreamEngine

    cfg = get_config("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamEngine(make_model(cfg), cfg)


def test_metrics_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device works")
    import numpy as np

    from stabnet_tpu_torch.cli.main import main
    from stabnet_tpu_torch.eval import evaluate_clip, score_stabilized_clip

    frames = np.zeros((3, 16, 16), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_clip(frames)
    with pytest.raises(RuntimeError, match="CUDA"):
        score_stabilized_clip(np.zeros((3, 16, 16, 3), np.uint8), frames, (16, 16))
    # The CLI's evaluate, on a clip it can read, defaults to CUDA as well.
    cv2 = pytest.importorskip("cv2")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (32, 24))
        for _ in range(3):
            writer.write(np.full((24, 32, 3), 128, np.uint8))
        writer.release()
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["evaluate", "--output", path, "--config", "tiny"])


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run([os.path.join(REPO, "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
