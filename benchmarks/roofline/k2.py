"""K2, `bilinear_sample` (csrc/warp.cu `bilinear_sample_kernel`): the float32
strict sampler at given maps.  Reads the (B, H, W, C) image and the two
(B, Ho, Wo) maps, writes (B, Ho, Wo, C).  Per output pixel: the NDC-to-pixel
map and floor of x and y (8), four corner weights (12), and per channel four
products and three sums (7)."""

NAME = "bilinear_sample_kernel"


def nbytes(B: int, H: int, W: int, C: int, Ho: int, Wo: int) -> int:
    return 4 * (B * H * W * C + 2 * B * Ho * Wo + B * Ho * Wo * C)


def ops(B: int, H: int, W: int, C: int, Ho: int, Wo: int) -> int:
    return B * Ho * Wo * (8 + 12 + 7 * C)
