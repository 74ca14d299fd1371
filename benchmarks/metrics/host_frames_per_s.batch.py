"""Driver layer (`StreamDriver.stabilize_batch`): stabilized frames back in
host memory over the window's elapsed time on the host clock, in frames/s.
The host's preparation and copies set it, so it moves with the host's speed
from run to run."""


def read(rec):
    c = rec.counters
    if not c.get("frames") or rec.window_s <= 0:
        return None
    return c["frames"] / rec.window_s
