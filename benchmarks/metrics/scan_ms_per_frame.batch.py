"""Engine and graphs (`stream/engine.py`, `utils/graphs.py`): the batch
call's upload, graph replays and read-back (`stage_summary["scan"]`), in ms
per stabilized frame, summed over the window's calls."""


def read(rec):
    c = rec.counters
    if not c.get("frames"):
        return None
    return c["scan_s"] / c["frames"] * 1e3
