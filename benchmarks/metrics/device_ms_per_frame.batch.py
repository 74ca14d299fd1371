"""The card's time per stabilized frame in batch serving: the union of the
window's device operations (kernels, copies, fills) on one profiler
timeline, over the frames that reached host memory in the window, in ms.
What a frame costs the card, however many host processes feed it."""


def read(rec):
    c = rec.counters
    if not rec.on_card or not c.get("frames"):
        return None
    return rec.reduced["busy_s"] / c["frames"] * 1e3
