"""Driver layer (`stream/driver.py`): the host's preparation of a batch call
(each frame's gray and color copy, `ClipResult.stage_summary["pre"]`), in ms
per stabilized frame, summed over the window's calls."""


def read(rec):
    c = rec.counters
    if not c.get("frames"):
        return None
    return c["pre_s"] / c["frames"] * 1e3
