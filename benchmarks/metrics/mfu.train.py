"""Model (`models/resnet.py`): the regressor's forward and backward FLOPs
over both halves of the Siamese pair (counted on the plain model by
`FlopCounterMode`) times the steps completed in the traced window, over the
window and the card's dense bf16 peak, in %."""


def read(rec):
    peak = rec.peak_flops()
    c = rec.counters
    if peak is None or not c.get("steps") or rec.window_s <= 0:
        return None
    return 100.0 * c["flops_per_step"] * c["steps"] / (rec.window_s * peak)
