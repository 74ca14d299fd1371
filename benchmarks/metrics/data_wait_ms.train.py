"""Input pipeline (`data/pipeline.py`): the training loop's wait for its
next batch, the program's `train.data` spans (`StageTimer("train.")`), in
ms per step over the window's steps."""

from benchmarks import spans


def read(rec):
    kept = spans.program_spans(rec, "train.data")
    if kept is None:
        return None
    return spans.total(kept, "train.data") / len(kept) * 1e3
