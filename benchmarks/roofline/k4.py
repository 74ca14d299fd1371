"""K4, `bilinear_splat` (csrc/warp_grad.cu, three passes: `splat_max_kernel`,
`splat_scatter_kernel`, `splat_convert_kernel`): the strict sampler's adjoint
in the image, deterministic.  Reads the (B, Ho, Wo, C) gradient and the two
(B, Ho, Wo) maps, writes the (B, H, W, C) image gradient (the int64
accumulator between the passes is not counted).  Per output pixel: the
corner weights (20) and per channel four products and four adds (8)."""

NAMES = ("splat_max_kernel", "splat_scatter_kernel", "splat_convert_kernel")


def nbytes(B: int, H: int, W: int, C: int, Ho: int, Wo: int) -> int:
    return 4 * (B * Ho * Wo * C + 2 * B * Ho * Wo + B * H * W * C)


def ops(B: int, H: int, W: int, C: int, Ho: int, Wo: int) -> int:
    return B * Ho * Wo * (20 + 8 * C)
