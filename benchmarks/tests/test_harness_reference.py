"""The plain reference agrees with the port on each cell's entry, on the CPU
at the tiny size, with the port's trunk in float32 (the configuration's
bf16 is what the cells' limits allow for; here the two sides compute the
same arithmetic, so the gaps are those of summation order alone)."""


import pytest
import torch

from benchmarks.harness.main import Context, cell_files, sized


@pytest.fixture
def fp32_tiny(monkeypatch):
    import stabnet_tpu_torch.config as C

    monkeypatch.setitem(C._REGISTRY, "tiny", C.TINY.replace(compute_dtype="float32"))


def cell(name, seed=5):
    import importlib

    wl, cfg = cell_files(name)
    wl, cfg = sized(wl, "tiny"), dict(sized(cfg, "tiny"), compute_dtype="float32")
    ctx = Context(name, wl, cfg, seed, torch.device("cpu"), False, "tiny")
    return importlib.import_module(f"benchmarks.drivers.{wl['driver']}").Cell(ctx)


@pytest.mark.parametrize("seed", [5, 6])
def test_serve_batch(fp32_tiny, seed):
    """The host's grays: OpenCV rounds in fixed point, the reference in
    float, a level apart at most, which moves a tiny frame's warp by a few
    hundredths of a level on average."""
    c = cell("serve-batch-720p", seed)
    r = c.reading(seed)
    assert r["frame_gap"] < 0.03 and r["black_gap"] < 0.01 and r["crop_gap"] == 0.0, r


@pytest.mark.parametrize("seed", [5, 6])
def test_score(fp32_tiny, seed):
    """The scorer's arithmetic, repeated operation for operation: equal."""
    c = cell("score-720p", seed)
    assert c.reading(seed)["score_gap"] == 0.0


def test_flops_match_the_published_count():
    from benchmarks.drivers.serving import flops_per_frame

    wl, cfg = cell_files("serve-batch-720p")
    assert flops_per_frame(cfg) == 22_780_889_088
