"""Operations and bytes of the port's hand-written kernels, from their shapes.

Bytes count each input read once and each output written once, whatever a
kernel reads again; operations are float32 operations on the CUDA cores.  A
kernel's least time is the larger of its bytes over the card's HBM rate and
its operations over its float32 rate (`least_seconds`).
"""

from benchmarks.harness.peaks import card


def least_seconds(nbytes: int, ops: int, card_name: str):
    c = card(card_name)
    if c is None:
        return None
    return max(nbytes / c["hbm_bytes_s"], ops / c["f32_flops"])
