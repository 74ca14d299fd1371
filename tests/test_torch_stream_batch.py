"""The batch call's host copies (`StreamDriver.stabilize_batch`): what it
returns owns its memory, and on the card its uploads and read-backs go
through page-locked buffers reused from call to call
(`utils/graphs.PinnedStage`), counted on the spans `engine.upload` and
`driver.readback`.

TINY in f32 at 96x128; no JAX.  The `cuda` cases run on a card and skip
without one.  On a machine with a card and no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stream_batch.py
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.data.synthetic import make_video
from stabnet_tpu_torch.models import make_model
from stabnet_tpu_torch.stream import DeployOptions, StreamDriver, StreamEngine
from stabnet_tpu_torch.stream.driver import _read_back
from stabnet_tpu_torch.utils.graphs import PinnedStage
from stabnet_tpu_torch.utils.profiling import TRACER

CFG = get_config("tiny").replace(compute_dtype="float32")
HF, WF = 96, 128
LENGTHS = (7, 5)          # the second clip padded to the first's 7 frames
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


def _driver(device: torch.device) -> StreamDriver:
    torch.manual_seed(0)
    return StreamDriver(StreamEngine(make_model(CFG), CFG, device=device), DeployOptions())


def _clips(seed: int):
    return [make_video(n, HF, WF, seed=seed + k, jitter=4.0) for k, n in enumerate(LENGTHS)]


def _held(results):
    return [(r.frames.copy(), r.cropped.copy(), r.all_black.copy()) for r in results]


@pytest.mark.parametrize("chunk", [None, 3, 6], ids=["whole", "chunked", "one-segment"])
@pytest.mark.parametrize("device", DEVICES)
def test_batch_results_own_their_memory(device, chunk):
    """A call's frames, crop and black counts are unchanged by a second call
    of the same shapes on other clips: nothing returned aliases a buffer the
    next call reuses (the card's page-locked stages)."""
    drv = _driver(_device(device))
    first = drv.stabilize_batch(_clips(10), chunk=chunk)
    held = _held(first)
    second = drv.stabilize_batch(_clips(20), chunk=chunk)
    for r, (frames, cropped, black), other in zip(first, held, second):
        np.testing.assert_array_equal(r.frames, frames)
        np.testing.assert_array_equal(r.cropped, cropped)
        np.testing.assert_array_equal(r.all_black, black)
        assert r.frames.shape == other.frames.shape
        # The second call's frames differ, so an alias would have shown.
        assert not np.array_equal(r.frames[1:], other.frames[1:])


def _copy_spans(fn):
    """`fn()` under a profiler; the `engine.upload` and `driver.readback`
    spans it kept, by name."""
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        fn()
        t1 = time.time_ns()
    kept = TRACER.spans(t0, t1)
    return {name: [s for s in kept if s.name == name]
            for name in ("engine.upload", "driver.readback")}


@pytest.mark.parametrize("device", DEVICES)
def test_batch_copies_are_counted(device):
    """`pinned_bytes` and `pageable_bytes` of a batch call: on the card every
    byte moved goes through a stage, on the CPU none (the host arrays are
    the CPU engine's input and output as they lie)."""
    dev = _device(device)
    drv = _driver(dev)
    clips = _clips(10)
    by = _copy_spans(lambda: drv.stabilize_batch(clips))
    S, T = len(clips), max(LENGTHS)
    up = S * T * (CFG.height * CFG.width * 4 + HF * WF * 3)
    back = S * (T - 1) * HF * WF * 3 + S * CFG.height * CFG.width * 4
    counts = {name: {k: sum(s.counters[k] for s in spans)
                     for k in ("pinned_bytes", "pageable_bytes")}
              for name, spans in by.items()}
    assert len(by["engine.upload"]) == 1 and len(by["driver.readback"]) == 2
    if dev.type == "cuda":
        assert counts == {"engine.upload": {"pinned_bytes": up, "pageable_bytes": 0},
                          "driver.readback": {"pinned_bytes": back, "pageable_bytes": 0}}
    else:
        assert counts == {"engine.upload": {"pinned_bytes": 0, "pageable_bytes": up},
                          "driver.readback": {"pinned_bytes": 0, "pageable_bytes": back}}


@pytest.mark.cuda
def test_card_stages_equal_pageable_copies_and_are_reused():
    """On the card: the staged upload and read-back equal plain `.to()` and
    `.cpu()` copies of the same tensors bit for bit; a second call of the
    same shapes pins nothing new; a stage grows to the largest request and
    serves smaller ones from its prefix."""
    dev = _device("cuda")
    drv = _driver(dev)
    eng = drv.engine
    rng = np.random.RandomState(0)
    S, T = 2, 5
    grays = rng.rand(S, T, CFG.height, CFG.width).astype(np.float32)
    colors = rng.randint(0, 256, (S, T, HF, WF, 3)).astype(np.uint8)
    g, c = eng._upload(grays, colors)
    assert torch.equal(g, torch.from_numpy(grays).to(dev))
    assert torch.equal(c, torch.from_numpy(colors).to(dev))
    # A non-contiguous host slice, as the chunked call uploads.
    g, _ = eng._upload(grays[:, 1:4], colors[:, 1:4])
    assert torch.equal(g, torch.from_numpy(np.ascontiguousarray(grays[:, 1:4])).to(dev))
    # Inputs already on the card move no host bytes.
    kept = _copy_spans(lambda: eng._upload(g, c))["engine.upload"]
    assert [s.counters for s in kept] == [{"pinned_bytes": 0, "pageable_bytes": 0}]

    warped, state = eng.stabilize_clip(grays, colors)
    np.testing.assert_array_equal(_read_back(warped, drv._landing(0, warped)),
                                  warped.cpu().numpy())
    np.testing.assert_array_equal(_read_back(state.all_black, drv._landing(1, state.all_black)),
                                  state.all_black.cpu().numpy())
    # Into a slice of one result, segment by segment.
    host = drv._landing(0, warped[:, :2], tuple(warped.shape))
    _read_back(warped[:, :2], host[:, :2])
    _read_back(warped[:, 2:], host[:, 2:])
    np.testing.assert_array_equal(host.numpy(), warped.cpu().numpy())

    clips = _clips(10)
    drv.stabilize_batch(clips)
    stages = list(eng._stages) + list(drv._stages)
    ptrs = [st.buf.data_ptr() for st in stages]
    assert all(st.buf.is_pinned() for st in stages)
    drv.stabilize_batch(_clips(20))
    assert [st.buf.data_ptr() for st in stages] == ptrs

    stage = PinnedStage()
    first = stage.view((2, 3), torch.float32)
    assert first.is_pinned() and stage.view((5,), torch.uint8).data_ptr() == first.data_ptr()
    grown = stage.view((1 << 20,), torch.uint8)
    assert grown.data_ptr() != first.data_ptr()
    assert stage.view((2, 3), torch.float32).data_ptr() == grown.data_ptr()
