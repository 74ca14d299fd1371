"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole run of a cell (set-up, window, check, result
line) at its tiny size on the CPU, without the harness's look for a card,
with one fault planted in the program: a step that returns its state
unchanged; half of the batch left out (the serving step computes half of
its streams and hands their frames to the rest); an answer altered where it
is produced (the scorer, which keeps no state and takes one clip a call, can
have only the last).  No cell runs across chips,
so none can leave out an exchange between them.
"""

import io
import json
import time
from contextlib import redirect_stdout

import pytest


def run(cell):
    from benchmarks.harness.main import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["--workload", cell, "--seed", "3000000077", "--seconds", "1",
                   "--trace", "0", "--device", "cpu", "--size", "tiny"], time.time())
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def unchanged_state(monkeypatch):
    """The serving step writes nothing into its history: the ring and the
    black counts are put back after each step."""
    from stabnet_tpu_torch.stream import engine

    orig = engine.stream_step

    def step(model, state, *a, **k):
        kept = (state.frames.clone(), state.masks.clone(), state.all_black.clone())
        new, out = orig(model, state, *a, **k)
        for t, v in zip((state.frames, state.masks, state.all_black), kept):
            t.copy_(v)
        return new, out

    monkeypatch.setattr(engine, "stream_step", step)


def half_streams(monkeypatch):
    """The step computes the first half of the streams and hands their
    outputs to the other half too."""
    from stabnet_tpu_torch.stream import engine

    orig = engine.stream_step

    def step(model, state, cur_gray, cur_color, *a, **k):
        new, out = orig(model, state, cur_gray, cur_color, *a, **k)
        w = out.warped_color.clone()
        h = w.shape[0] // 2
        w[h:] = w[: w.shape[0] - h]
        return new, out._replace(warped_color=w)

    monkeypatch.setattr(engine, "stream_step", step)


def altered_frame(monkeypatch):
    """The color warp's output is inverted in its top quarter."""
    from stabnet_tpu_torch.stream import engine

    orig = engine.warp_color

    def warp(*a, **k):
        out = orig(*a, **k).clone()
        q = out.shape[1] // 4
        out[:, :q] = 255 - out[:, :q]
        return out

    monkeypatch.setattr(engine, "warp_color", warp)


@pytest.mark.parametrize("fault", [unchanged_state, half_streams, altered_frame],
                         ids=lambda f: f.__name__)
def test_serve_batch_fault(monkeypatch, fault):
    fault(monkeypatch)
    assert run("serve-batch-720p")["correct"] is False


def test_sound_runs_are_correct():
    for cell in ("serve-batch-720p", "score-720p"):
        assert run(cell)["correct"] is True, cell


def altered_score(monkeypatch):
    """The cropping score comes out 0.05 off where it is produced."""
    from stabnet_tpu_torch.eval import metrics

    orig = metrics.cropping_score
    monkeypatch.setattr(metrics, "cropping_score", lambda Hs: orig(Hs) - 0.05)


def test_score_fault(monkeypatch):
    altered_score(monkeypatch)
    assert run("score-720p")["correct"] is False
