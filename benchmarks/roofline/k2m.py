"""K2m, `warp_mesh` (csrc/warp.cu `warp_mesh_kernel`): the serving warp, the
dense maps of the mesh's homographies, the black mask and the strict sample
of one channel in one pass.  Reads the (B, H, W) float32 frames, the (B, 4,
4, 3, 3) homographies and the four axis tables ((W,) and (H,) float32 NDC
axes, (W,) and (H,) int32 cells); writes the sample, the mask and the two
maps, each (B, H, W) float32.  Per pixel: three projective rows (4 each),
the nudged divide (4), the mask's four compares (4), and K2's sample of one
channel (27)."""

NAME = "warp_mesh_kernel"


def nbytes(B: int, H: int, W: int, gh: int = 4, gw: int = 4) -> int:
    frames = B * H * W * 4
    return frames + 4 * frames + B * gh * gw * 9 * 4 + 2 * (W + H) * 4


def ops(B: int, H: int, W: int, gh: int = 4, gw: int = 4) -> int:
    return B * H * W * (12 + 4 + 4 + 27)
