"""K1, `warp_uint8_cf_lowres` (csrc/warp.cu `warp_uint8_kernel`): the uint8
color warp with the low-resolution maps' up-sample fused in.  Reads the
(B, C, Hin, Win) uint8 frames and the two (B, h, w) float32 maps, writes
(B, Ho, Wo, C) uint8.  Per output pixel: two 2-tap up-samples (rows, then
columns: 6 operations each), the NDC-to-pixel map and floor of x and y (8),
four corner weights (12), and per channel four products and three sums (7)
and the rounding and clip (3)."""

NAME = "warp_uint8_kernel"


def nbytes(B: int, C: int, Hin: int, Win: int, Ho: int, Wo: int, h: int, w: int) -> int:
    return B * C * Hin * Win + B * Ho * Wo * C + 2 * B * h * w * 4


def ops(B: int, C: int, Hin: int, Win: int, Ho: int, Wo: int, h: int, w: int) -> int:
    return B * Ho * Wo * (2 * 6 + 8 + 12 + 10 * C)
