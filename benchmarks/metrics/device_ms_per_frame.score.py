"""Flow and metrics (`ops/flow.py`, `eval/metrics.py`): the device time of
the traced window (the union of its device operations' intervals) per
scored frame, in ms."""


def read(rec):
    c = rec.counters
    if not rec.on_card or not c.get("frames"):
        return None
    return rec.reduced["busy_s"] / c["frames"] * 1e3
