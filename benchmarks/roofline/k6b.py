"""K6b, `sample_map_grad` (csrc/warp_grad.cu `sample_map_grad_kernel`): the
strict sampler's derivative in the maps.  Reads the (B, H, W, C) image, the
two (B, Ho, Wo) maps and the (B, Ho, Wo, C) output gradient, writes the two
(B, Ho, Wo) map gradients.  Per output pixel: the corner set-up (20) and per
channel the two directional differences and their products (12)."""

NAME = "sample_map_grad_kernel"


def nbytes(B: int, H: int, W: int, C: int, Ho: int, Wo: int) -> int:
    return 4 * (B * H * W * C + 2 * B * Ho * Wo + B * Ho * Wo * C + 2 * B * Ho * Wo)


def ops(B: int, H: int, W: int, C: int, Ho: int, Wo: int) -> int:
    return B * Ho * Wo * (20 + 12 * C)
