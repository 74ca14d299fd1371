"""K7, `tvl1_iterate` (csrc/tvl1.cu `tvl1_iterate_kernel`): one primal-dual
iteration of TV-L1 at one warp of one pyramid level.  Per pixel it reads the
flow u (2 floats), its dual field p (4), the residual's constant part rho_c
and the warped gradient gx, gy, and writes u and p: 15 floats, 60 B.  Per
pixel, float32 operations on the CUDA cores: the data term 12 (|grad|^2 3,
rho 4, the two thresholds 2 and their compares 2, the divisor's clamp 1); per
flow component the step (negation, product and quotient 3), v 1, the
divergence 3, its product with theta 1 and the sum 1, then the forward
gradient 2, its magnitude 4 (two products, a sum, the root), the
denominator 2 and the two dual updates 6; 12 + 2 * (9 + 14) = 58."""

NAME = "tvl1_iterate_kernel"
BYTES_PER_PX = 60
OPS_PER_PX = 58


def nbytes(px: int) -> int:
    """Bytes of `px` pixel updates (pixels times iterations)."""
    return BYTES_PER_PX * px


def ops(px: int) -> int:
    return OPS_PER_PX * px
