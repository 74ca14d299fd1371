"""The card's time per training step: the union of the window's device
operations (the step's graph, the input pipeline's upload and augmentation)
on one profiler timeline, over the steps completed in the window, in ms.
What a step costs the card, however fast the host feeds it."""


def read(rec):
    c = rec.counters
    if not rec.on_card or not c.get("steps"):
        return None
    return rec.reduced["busy_s"] / c["steps"] * 1e3
