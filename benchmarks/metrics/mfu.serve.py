"""Model (`models/resnet.py`): the regressor's forward FLOPs (counted on the
plain model by `FlopCounterMode`) times the frames stabilized in the traced
window, over the window and the card's dense bf16 peak, in %."""


def read(rec):
    peak = rec.peak_flops()
    c = rec.counters
    if peak is None or not c.get("frames") or rec.window_s <= 0:
        return None
    return 100.0 * c["flops_per_frame"] * c["frames"] / (rec.window_s * peak)
