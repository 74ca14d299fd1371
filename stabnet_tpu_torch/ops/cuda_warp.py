"""The warp kernels (csrc/warp.cu, csrc/warp_grad.cu) and their plain versions.

K2  `bilinear_sample`      replaces stabnet_tpu/ops/pallas_warp.py:469
                           `bilinear_sample_pallas` (f32 sampler, reference
                           semantics, `strict_edge` flag) at given maps.
K2m `warp_mesh`            the same sampler with the dense maps and the
                           black mask fused in (stabnet_tpu/ops/warp.py:70-111):
                           the serving warp from per-cell homographies.
K1  `warp_uint8_cf_lowres` replaces stabnet_tpu/ops/pallas_warp.py:575
                           `warp_uint8_cf_lowres` (uint8 color warp with the
                           map up-sample fused in).
K3  `warp_uint8_cf`        replaces pallas_warp.py:524 `warp_uint8_cf` (the
                           same color warp at full-resolution maps; K1's
                           kernel body, on no path, as in the JAX package).
K4  `bilinear_splat`       replaces pallas_warp.py:738 `bilinear_splat_pallas`
                           (the strict sampler's adjoint in the image).
K6b `sample_map_grad`      replaces the backward of pallas_warp.py:917
                           (the strict sampler's derivative in the maps).
K5  `bilinear_sample_const_maps` and K6 `bilinear_sample_const_image`
    replace the custom VJPs of pallas_warp.py:879 and :917: autograd
    Functions with K2 forward and K4 or K6b backward.

Each entry point is a `torch.library` custom op, `torch.ops.stabnet.<name>`,
so `torch.export` keeps it in a traced graph as one call: its "cpu"
implementation is the plain PyTorch version, its "cuda" implementation the
kernel's launch on the current stream, and a fake implementation gives the
output's shape and dtype to tracers.  The dispatcher picks the
implementation by the tensors' device: the plain version runs on CPU
tensors and only there; on CUDA tensors the kernel launches or raises, and
nothing falls back.  The public functions below check their arguments and
call the op.  Every launch adds one to the public function's `launches`
attribute, so a run can show that it went through the kernel, the ops of an
exported program included.  A launch made into a CUDA graph's capture runs
nothing: it goes into the capture's record instead (`recording_launches`),
which the graph cache (utils/graphs.py) adds to the counts once per replay
(`add_launches`), so a count is always the launches that ran.  The record
is found by the capturing stream, not by the thread: autograd runs K5's
and K6's backwards (K4, K6b) on its own device thread, on the stream of
their forward.  The kernels reproduce the plain versions'
arithmetic operation for operation, so the two agree bit for bit (see the
notes in csrc/).

No kernel wrapper carries a gradient: each raises when gradient mode is on
and an input requires grad, on every device, so code that trains on the CPU
cannot silently stop training on the card.  Gradients go through K5 and K6.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Dict, Iterator, Tuple

import torch

from stabnet_tpu_torch.ops import cuda_build
from stabnet_tpu_torch.ops.resize import device_taps, resize_bilinear_bhw

_P = ctypes.c_void_p
_I = ctypes.c_int


def _warp_lib() -> ctypes.CDLL:
    lib = cuda_build.load("warp")
    if not getattr(lib, "_stabnet_typed", False):
        lib.stabnet_bilinear_sample_f32.argtypes = [_P] * 4 + [_I] * 7 + [_P]
        lib.stabnet_bilinear_sample_f32.restype = _I
        lib.stabnet_warp_uint8_lowres.argtypes = [_P] * 12 + [_I] * 8 + [_P]
        lib.stabnet_warp_uint8_lowres.restype = _I
        lib.stabnet_warp_uint8_cf.argtypes = [_P] * 4 + [_I] * 6 + [_P]
        lib.stabnet_warp_uint8_cf.restype = _I
        lib.stabnet_warp_mesh_f32.argtypes = ([_P] * 2 + [ctypes.c_longlong] + [_I] * 2
                                              + [_P] * 8 + [_I] * 6 + [_P])
        lib.stabnet_warp_mesh_f32.restype = _I
        lib.stabnet_empty_launch.argtypes = [_I] * 4 + [_P]
        lib.stabnet_empty_launch.restype = _I
        lib._stabnet_typed = True
    return lib


def _grad_lib() -> ctypes.CDLL:
    lib = cuda_build.load("warp_grad")
    if not getattr(lib, "_stabnet_typed", False):
        lib.stabnet_bilinear_splat_f32.argtypes = [_P] * 6 + [_I] * 7 + [_P]
        lib.stabnet_bilinear_splat_f32.restype = _I
        lib.stabnet_sample_map_grad_f32.argtypes = [_P] * 6 + [_I] * 6 + [_P]
        lib.stabnet_sample_map_grad_f32.restype = _I
        lib._stabnet_typed = True
    return lib


def _no_grad_inputs(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel would cut the autograd graph silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel carries no gradient, and an input requires "
            "grad; use bilinear_sample_const_maps (image gradients) or "
            "bilinear_sample_const_image (map gradients)")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on the CPU, False if every one is on one CUDA
    device; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _on_card(*tensors: torch.Tensor) -> None:
    """A kernel launches only on tensors that all lie on one CUDA device
    (the dispatcher picks the CUDA implementation if any of them does)."""
    if _on_cpu(*tensors):
        raise ValueError("a CUDA kernel was handed CPU tensors")


_capture = threading.local()
_stream_records: Dict[Tuple[int, int], Dict[object, int]] = {}   # capturing stream -> record


def _stream_key(stream) -> Tuple[int, int]:
    return (stream.device_index, stream.stream_id)


def _capturing_stream():
    """The key of this thread's current CUDA stream while it captures a
    graph, else None."""
    if not torch.cuda.is_available() or not torch.cuda.is_current_stream_capturing():
        return None
    return _stream_key(torch.cuda.current_stream())


def _launched(kernel) -> None:
    """Count one launch of `kernel` (a public wrapper): on its `launches`,
    or into a capture's record: that of the stream being captured (on
    whatever thread launches into it), else that of this thread."""
    key = _capturing_stream()
    record = _stream_records.get(key) if key is not None else None
    if record is None:
        record = getattr(_capture, "record", None)
    if record is None:
        kernel.launches += 1
    else:
        record[kernel] = record.get(kernel, 0) + 1


@contextlib.contextmanager
def recording_launches(stream=None) -> Iterator[Dict[object, int]]:
    """Within: this thread's launches, and every launch into a capture of
    `stream` (a CUDA stream, from any thread), go into the yielded record
    {wrapper: launches}, not into the counts (a CUDA graph capture
    launches nothing; other threads and streams count as before)."""
    outer = getattr(_capture, "record", None)
    _capture.record = record = {}
    key = None if stream is None else _stream_key(stream)
    outer_stream = _stream_records.get(key)
    if key is not None:
        _stream_records[key] = record
    try:
        yield record
    finally:
        _capture.record = outer
        if key is not None:
            if outer_stream is None:
                del _stream_records[key]
            else:
                _stream_records[key] = outer_stream


def add_launches(record: Dict[object, int]) -> None:
    """Add a capture's record to the counts: one replay of its graph."""
    for kernel, n in record.items():
        kernel.launches += n


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_maps(x: torch.Tensor, y: torch.Tensor, batch: int) -> None:
    _require(x.dtype == torch.float32 and y.dtype == torch.float32,
             f"maps must be float32, got {x.dtype}, {y.dtype}")
    _require(x.dim() == 3 and x.shape == y.shape and x.shape[0] == batch,
             f"maps must be (B, Ho, Wo) of the image's batch {batch}, "
             f"got {tuple(x.shape)}, {tuple(y.shape)}")
    _require(x.is_contiguous() and y.is_contiguous(), "maps must be contiguous")


def _launch_check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


_INDEX_MAX = 2 ** 31 - 1   # the kernels index within one image in 32 bits
_GRID_MAX = 65535          # CUDA's limit on a grid's y and z extents
_SIDE_MAX = 2 ** 22 - 2    # csrc/bilinear.cuh floors coordinates below 2^22


def _check_index_range(name: str, sides, batch: int = 1, tiles_y: int = 1,
                       *counts: int) -> None:
    """Refuse sizes beyond what the kernels index: image sides (the exact
    floor of csrc/bilinear.cuh), the elements of one image of each array in
    `counts` (32-bit offsets), one grid layer per image and one block row
    per tile row of the output.  Checked on every device, so the plain
    versions take exactly what the kernels take."""
    _require(max(sides) <= _SIDE_MAX and max(counts, default=0) <= _INDEX_MAX
             and batch <= _GRID_MAX and tiles_y <= _GRID_MAX,
             f"{name}: sizes beyond the kernels' 32-bit indexing (sides "
             f"{tuple(sides)}, elements per image {max(counts, default=0)}, batch "
             f"{batch}, tile rows {tiles_y})")


# --- K2: f32 bilinear sampler ------------------------------------------------

def bilinear_sample_plain(im: torch.Tensor, x_ndc: torch.Tensor,
                          y_ndc: torch.Tensor,
                          strict_edge: bool = True) -> torch.Tensor:
    """Bilinearly sample `im` at NDC coordinates with reference edge semantics.

    Args:
      im: (B, H, W, C) input images.
      x_ndc, y_ndc: (B, Ho, Wo) sample coordinates in [-1, 1] (values outside
        fade to zero, matching the reference's clamped-weight scheme).
      strict_edge: True gives exactly 0 for a sample at x == W-1 or y == H-1
        (the reference); False includes the edge pixel there.

    Returns:
      (B, Ho, Wo, C) float32 sampled images.

    Reference: spatial_transformer3.py:62-123 `_interpolate`; the JAX
    package's stabnet_tpu/ops/warp.py:114-163.
    """
    B, H, W, C = im.shape
    out_shape = tuple(x_ndc.shape)
    # NDC -> continuous pixel coordinates (the reference's (x+1)*W/2, an
    # intentional off-by-(n/(n-1)) quirk preserved for parity).
    x = (x_ndc.float() + 1.0) * (W / 2.0)
    y = (y_ndc.float() + 1.0) * (H / 2.0)

    # Corners in float so no coordinate can overflow an integer cast.
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    if not strict_edge:
        x0 = torch.where(x == W - 1, x0 - 1.0, x0)
        y0 = torch.where(y == H - 1, y0 - 1.0, y0)
    x0c = x0.clamp(0, W - 1)
    x1c = (x0 + 1.0).clamp(0, W - 1)
    y0c = y0.clamp(0, H - 1)
    y1c = (y0 + 1.0).clamp(0, H - 1)

    im_flat = im.float().reshape(B, H * W, C)

    def gather(yy, xx):
        idx = (yy.long() * W + xx.long()).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(im_flat, 1, idx)

    Ia = gather(y0c, x0c)
    Ib = gather(y1c, x0c)
    Ic = gather(y0c, x1c)
    Id = gather(y1c, x1c)

    # Weights from the CLAMPED corners (parity-critical).
    xr, yr = x.reshape(B, -1, 1), y.reshape(B, -1, 1)
    x0f, x1f = x0c.reshape(B, -1, 1), x1c.reshape(B, -1, 1)
    y0f, y1f = y0c.reshape(B, -1, 1), y1c.reshape(B, -1, 1)
    wa = (x1f - xr) * (y1f - yr)
    wb = (x1f - xr) * (yr - y0f)
    wc = (xr - x0f) * (y1f - yr)
    wd = (xr - x0f) * (yr - y0f)

    out = wa * Ia + wb * Ib + wc * Ic + wd * Id
    return out.reshape(out_shape + (C,))


@torch.library.custom_op(
    "stabnet::bilinear_sample", mutates_args=(), device_types="cpu",
    schema="(Tensor im, Tensor x_ndc, Tensor y_ndc, bool strict_edge) -> Tensor")
def _bilinear_sample_op(im, x_ndc, y_ndc, strict_edge):
    return bilinear_sample_plain(im, x_ndc, y_ndc, strict_edge)


@_bilinear_sample_op.register_kernel("cuda")
def _bilinear_sample_cuda(im, x_ndc, y_ndc, strict_edge):
    _on_card(im, x_ndc, y_ndc)
    B, H, W, C = im.shape
    _, Ho, Wo = x_ndc.shape
    _require(im.dtype == torch.float32, f"image must be float32, got {im.dtype}")
    _require(im.is_contiguous(), "image must be contiguous")
    _check_maps(x_ndc, y_ndc, B)
    out = torch.empty((B, Ho, Wo, C), dtype=torch.float32, device=im.device)
    with torch.cuda.device(im.device):
        stream = torch.cuda.current_stream(im.device).cuda_stream
        err = _warp_lib().stabnet_bilinear_sample_f32(
            im.data_ptr(), x_ndc.data_ptr(), y_ndc.data_ptr(), out.data_ptr(),
            B, H, W, C, Ho, Wo, int(strict_edge), stream)
    _launch_check(err, "bilinear_sample")
    _launched(bilinear_sample)
    return out


@_bilinear_sample_op.register_fake
def _bilinear_sample_fake(im, x_ndc, y_ndc, strict_edge):
    return im.new_empty(tuple(x_ndc.shape) + (im.shape[3],), dtype=torch.float32)


def bilinear_sample(im: torch.Tensor, x_ndc: torch.Tensor, y_ndc: torch.Tensor,
                    strict_edge: bool = True) -> torch.Tensor:
    """K2: `bilinear_sample_plain` as one CUDA kernel (plain version on CPU),
    through `torch.ops.stabnet.bilinear_sample`.

    im: (B, H, W, C) float32, maps (B, Ho, Wo) float32, all contiguous.
    """
    _no_grad_inputs("bilinear_sample", im, x_ndc, y_ndc)
    _require(im.dim() == 4 and x_ndc.dim() == 3,
             f"image must be (B, H, W, C) and maps (B, Ho, Wo), got "
             f"{tuple(im.shape)}, {tuple(x_ndc.shape)}")
    B, H, W, C = (int(v) for v in im.shape)
    Ho, Wo = int(x_ndc.shape[1]), int(x_ndc.shape[2])
    _check_index_range("bilinear_sample", (H, W), B, -(-Ho // 8), H * W * C, Ho * Wo * C)
    _on_cpu(im, x_ndc, y_ndc)
    return torch.ops.stabnet.bilinear_sample(im, x_ndc, y_ndc, bool(strict_edge))


bilinear_sample.launches = 0


# --- K2m: the serving warp, maps and mask fused into the sampler --------------

def warp_mesh_plain(im: torch.Tensor, Hs: torch.Tensor, tables
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp frames by per-cell homographies: the dense NDC maps, the black
    mask and the strict sample, with every product, sum and quotient rounded
    as K2m rounds it.

    im: (B, H, W, 1) float32 frames (any strides); Hs: (B, grid_h, grid_w,
    3, 3) homographies from output-cell NDC to input NDC; tables: (gx, gy,
    cell_col, cell_row), the NDC grid's axes (W,) and (H,) float32 and each
    output column's and row's mesh cell, (W,) and (H,) int32
    (`ops.warp.mesh_tables`).  Per pixel, with its cell's homography h:
    X = (h00 gx + h01 gy) + h02, likewise Y and Z; z = Z + 1e-8 where
    Z >= 0, else Z - 1e-8; x = X / z, y = Y / z.  Returns (output (B, H, W,
    1), black (B, H, W), x_map, y_map): the JAX package's `dense_maps`,
    `black_mask` and `bilinear_sample` (stabnet_tpu/ops/warp.py:70-184),
    whose einsum sums the same terms, rounded in another order.
    """
    gx, gy, cell_col, cell_row = tables
    B, grid_h, grid_w = (int(v) for v in Hs.shape[:3])
    h = Hs.float().reshape(B, grid_h, grid_w, 9)[:, cell_row.long()][:, :, cell_col.long()]

    def coord(r):
        return h[..., 3 * r] * gx + h[..., 3 * r + 1] * gy[:, None] + h[..., 3 * r + 2]

    X, Y, Z = coord(0), coord(1), coord(2)
    z = Z + torch.where(Z >= 0, 1e-8, -1e-8)
    x, y = X / z, Y / z
    black = ((x < -1.0) | (x > 1.0) | (y < -1.0) | (y > 1.0)).float()
    return bilinear_sample_plain(im, x, y), black, x, y


@torch.library.custom_op(
    "stabnet::warp_mesh", mutates_args=(), device_types="cpu",
    schema="(Tensor im, Tensor Hs, Tensor gx, Tensor gy, Tensor cell_col, "
           "Tensor cell_row) -> (Tensor, Tensor, Tensor, Tensor)")
def _warp_mesh_op(im, Hs, gx, gy, cell_col, cell_row):
    return warp_mesh_plain(im, Hs, (gx, gy, cell_col, cell_row))


_ONE_PIX_MAX = 2 * 132 * 2048   # pixels in about two waves at one per thread


def warp_mesh_pix(B: int, H: int, W: int, col_stride: int) -> int:
    """Pixels per thread of K2m (csrc/warp.cu, `warp_mesh_kernel`) for B
    frames of H x W whose pixels lie `col_stride` elements apart.  One (8
    rows per block) where the grid fills the card in about two waves or less,
    since the latency of each pixel's chain of loads bounds it there, or where
    the frame's pixels are strided, since its tap gathers bound it then.
    Otherwise four (4 rows per block), whose 16-byte loads and stores issue
    fewer instructions per pixel, since the bytes bound it there.  A frame
    one pixel wide has no column stride to speak of."""
    strided = W > 1 and col_stride != 1
    return 1 if B * H * W <= _ONE_PIX_MAX or strided else 4


def _launch_warp_mesh(im, Hs, tables, pix: int):
    """Allocate K2m's four planes and launch it at `pix` pixels per thread on
    the current stream (the op's CUDA implementation;
    scripts/warp_mesh_layouts.py times each layout)."""
    gx, gy, cell_col, cell_row = tables
    B, H, W, _ = im.shape
    dev = im.device
    # A side of one pixel never moves an offset: its stride may be anything.
    strides = [im.stride(d) if im.shape[d] > 1 else 0 for d in (1, 2)]
    out = torch.empty((B, H, W, 1), dtype=torch.float32, device=dev)
    black, x_map, y_map = (torch.empty((B, H, W), dtype=torch.float32, device=dev)
                           for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _warp_lib().stabnet_warp_mesh_f32(
            Hs.data_ptr(), im.data_ptr(), im.stride(0), *strides,
            gx.data_ptr(), gy.data_ptr(), cell_col.data_ptr(), cell_row.data_ptr(),
            out.data_ptr(), black.data_ptr(), x_map.data_ptr(), y_map.data_ptr(),
            B, H, W, Hs.shape[1], Hs.shape[2], pix, stream)
    _launch_check(err, "warp_mesh")
    return out, black, x_map, y_map


@_warp_mesh_op.register_kernel("cuda")
def _warp_mesh_cuda(im, Hs, gx, gy, cell_col, cell_row):
    _on_card(im, Hs, gx, gy, cell_col, cell_row)
    B, H, W, _ = im.shape
    _require(im.dtype == torch.float32 and Hs.dtype == torch.float32,
             f"warp_mesh: frames and homographies must be float32, got {im.dtype}, "
             f"{Hs.dtype}")
    _require(Hs.is_contiguous(), "warp_mesh: homographies must be contiguous")
    for t, n, dtype in ((gx, W, torch.float32), (gy, H, torch.float32),
                        (cell_col, W, torch.int32), (cell_row, H, torch.int32)):
        _require(tuple(t.shape) == (n,) and t.dtype == dtype and t.is_contiguous(),
                 f"warp_mesh: bad table {tuple(t.shape)} {t.dtype} for {H} x {W} frames")
    res = _launch_warp_mesh(im, Hs, (gx, gy, cell_col, cell_row),
                            warp_mesh_pix(B, H, W, im.stride(2)))
    _launched(warp_mesh)
    return res


@_warp_mesh_op.register_fake
def _warp_mesh_fake(im, Hs, gx, gy, cell_col, cell_row):
    B, H, W, _ = im.shape
    return (im.new_empty((B, H, W, 1), dtype=torch.float32),
            *(im.new_empty((B, H, W), dtype=torch.float32) for _ in range(3)))


def warp_mesh(im: torch.Tensor, Hs: torch.Tensor, tables
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2m: `warp_mesh_plain` as one CUDA kernel (plain version on CPU),
    through `torch.ops.stabnet.warp_mesh` (the tables as four tensors).

    im: (B, H, W, 1) float32 at any strides (the current frame is read in
    place from the input stack); Hs: (B, grid_h, grid_w, 3, 3) float32
    contiguous; tables as `warp_mesh_plain` takes them.
    """
    _no_grad_inputs("warp_mesh", im, Hs)
    _require(im.dim() == 4 and im.shape[-1] == 1,
             f"warp_mesh: frames must be (B, H, W, 1), got {tuple(im.shape)}")
    B, H, W = (int(v) for v in im.shape[:3])
    _require(Hs.dim() == 5 and Hs.shape[0] == B and tuple(Hs.shape[3:]) == (3, 3),
             f"warp_mesh: homographies must be (B, grid_h, grid_w, 3, 3) of the "
             f"frames' batch {B}, got {tuple(Hs.shape)}")
    grid_h, grid_w = int(Hs.shape[1]), int(Hs.shape[2])
    _require(1 <= grid_h <= H and 1 <= grid_w <= W,
             f"warp_mesh: a {grid_h} x {grid_w} mesh on {H} x {W} frames (no more "
             f"cells than pixels along a side)")
    frame_span = (H - 1) * im.stride(1) + (W - 1) * im.stride(2) + 1
    _check_index_range("warp_mesh", (H, W), B, -(-H // 8), H * W, frame_span)
    _on_cpu(im, Hs, *tables)
    return torch.ops.stabnet.warp_mesh(im, Hs, *tables)


warp_mesh.launches = 0


def empty_launch(B: int, H: int, W: int, pix: int, device: torch.device) -> None:
    """Launch an empty kernel at K2m's grid for B frames of H x W at `pix`
    pixels per thread, on the current stream: the floor under K2m's time
    that any launch of that size pays (chip_smoke times it beside K2m).  Not
    a kernel of any path, and not counted."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch_check(_warp_lib().stabnet_empty_launch(B, H, W, pix, stream), "empty_launch")


# --- K1 and K3: the uint8 color warp ------------------------------------------

def _check_frames(name: str, imc: torch.Tensor, out_hw: Tuple[int, int]):
    """(B, C, H, W, Ho, Wo) of a color warp, with its size checks."""
    _require(imc.dim() == 4, f"frames must be (B, C, H, W), got {tuple(imc.shape)}")
    B, C, H, W = (int(v) for v in imc.shape)
    Ho, Wo = (int(v) for v in out_hw)
    _require(Ho > 0 and Wo > 0, f"bad output size {out_hw}")
    _require(1 <= C <= 4, f"{name}: 1 to 4 channels, got {C}")
    _check_index_range(name, (H, W), B, -(-Ho // 8), C * H * W, C * Ho * Wo)
    return B, C, H, W, Ho, Wo


def _check_frames_on_card(imc: torch.Tensor) -> None:
    _require(imc.dtype == torch.uint8, f"frames must be uint8, got {imc.dtype}")
    _require(imc.is_contiguous(), "frames must be contiguous")


def warp_uint8_cf_plain(imc: torch.Tensor, x_ndc: torch.Tensor,
                        y_ndc: torch.Tensor) -> torch.Tensor:
    """Sample the channels-first uint8 frames with strict edges at NDC maps,
    round half to even and clip to uint8.

    imc: (B, C, H, W) uint8; maps (B, Ho, Wo) float32.  Returns (B, Ho, Wo,
    C) uint8: the JAX reference of tests/test_pallas_warp.py:128-130.
    """
    img = imc.permute(0, 2, 3, 1).float()
    warped = bilinear_sample_plain(img, x_ndc, y_ndc)
    return torch.clamp(torch.round(warped), 0, 255).to(torch.uint8)


@torch.library.custom_op(
    "stabnet::warp_uint8_cf", mutates_args=(), device_types="cpu",
    schema="(Tensor imc, Tensor x_ndc, Tensor y_ndc) -> Tensor")
def _warp_uint8_cf_op(imc, x_ndc, y_ndc):
    return warp_uint8_cf_plain(imc, x_ndc, y_ndc)


@_warp_uint8_cf_op.register_kernel("cuda")
def _warp_uint8_cf_cuda(imc, x_ndc, y_ndc):
    _on_card(imc, x_ndc, y_ndc)
    B, C, H, W = imc.shape
    _, Ho, Wo = x_ndc.shape
    _check_frames_on_card(imc)
    _check_maps(x_ndc, y_ndc, B)
    out = torch.empty((B, Ho, Wo, C), dtype=torch.uint8, device=imc.device)
    with torch.cuda.device(imc.device):
        stream = torch.cuda.current_stream(imc.device).cuda_stream
        err = _warp_lib().stabnet_warp_uint8_cf(
            imc.data_ptr(), x_ndc.data_ptr(), y_ndc.data_ptr(), out.data_ptr(),
            B, C, H, W, Ho, Wo, stream)
    _launch_check(err, "warp_uint8_cf")
    _launched(warp_uint8_cf)
    return out


@_warp_uint8_cf_op.register_fake
def _warp_uint8_cf_fake(imc, x_ndc, y_ndc):
    return imc.new_empty(tuple(x_ndc.shape) + (imc.shape[1],), dtype=torch.uint8)


def warp_uint8_cf(imc: torch.Tensor, x_ndc: torch.Tensor,
                  y_ndc: torch.Tensor) -> torch.Tensor:
    """K3: `warp_uint8_cf_plain` as one CUDA kernel (plain on CPU), through
    `torch.ops.stabnet.warp_uint8_cf`.

    imc: (B, C, H, W) uint8 contiguous, 1 <= C <= 4; maps (B, Ho, Wo)
    float32 contiguous.  K1's kernel body, reading full-resolution maps.
    """
    _no_grad_inputs("warp_uint8_cf", imc, x_ndc, y_ndc)
    _require(x_ndc.dim() == 3, f"maps must be (B, Ho, Wo), got {tuple(x_ndc.shape)}")
    _check_frames("warp_uint8_cf", imc, x_ndc.shape[1:])
    _on_cpu(imc, x_ndc, y_ndc)
    return torch.ops.stabnet.warp_uint8_cf(imc, x_ndc, y_ndc)


warp_uint8_cf.launches = 0


def warp_uint8_cf_lowres_plain(imc: torch.Tensor, x_ndc_lr: torch.Tensor,
                               y_ndc_lr: torch.Tensor,
                               out_hw: Tuple[int, int]) -> torch.Tensor:
    """Up-sample the low-res NDC maps to `out_hw`, then `warp_uint8_cf_plain`.

    imc: (B, C, H, W) uint8; maps (B, h, w) float32.  Returns (B, Ho, Wo, C)
    uint8.  The JAX package's equivalent is stream/engine.py:200-204.
    """
    xs = resize_bilinear_bhw(x_ndc_lr.float(), tuple(out_hw))
    ys = resize_bilinear_bhw(y_ndc_lr.float(), tuple(out_hw))
    return warp_uint8_cf_plain(imc, xs, ys)


@torch.library.custom_op(
    "stabnet::warp_uint8_cf_lowres", mutates_args=(), device_types="cpu",
    schema="(Tensor imc, Tensor x_ndc_lr, Tensor y_ndc_lr, int[] out_hw) -> Tensor")
def _warp_uint8_cf_lowres_op(imc, x_ndc_lr, y_ndc_lr, out_hw):
    return warp_uint8_cf_lowres_plain(imc, x_ndc_lr, y_ndc_lr, tuple(out_hw))


@_warp_uint8_cf_lowres_op.register_fake
def _warp_uint8_cf_lowres_fake(imc, x_ndc_lr, y_ndc_lr, out_hw):
    return imc.new_empty((imc.shape[0], *out_hw, imc.shape[1]), dtype=torch.uint8)


def warp_uint8_cf_lowres(imc: torch.Tensor, x_ndc_lr: torch.Tensor,
                         y_ndc_lr: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """K1: `warp_uint8_cf_lowres_plain` as one CUDA kernel (plain on CPU),
    through `torch.ops.stabnet.warp_uint8_cf_lowres`.

    imc: (B, C, H, W) uint8 contiguous, 1 <= C <= 4; maps (B, h, w) float32
    contiguous.
    """
    _no_grad_inputs("warp_uint8_cf_lowres", imc, x_ndc_lr, y_ndc_lr)
    B, C, H, W, Ho, Wo = _check_frames("warp_uint8_cf_lowres", imc, out_hw)
    _check_index_range("warp_uint8_cf_lowres", (H, W), B, 1,
                       int(x_ndc_lr.shape[-2]) * int(x_ndc_lr.shape[-1]))
    _on_cpu(imc, x_ndc_lr, y_ndc_lr)
    return torch.ops.stabnet.warp_uint8_cf_lowres(imc, x_ndc_lr, y_ndc_lr, [Ho, Wo])


warp_uint8_cf_lowres.launches = 0


@_warp_uint8_cf_lowres_op.register_kernel("cuda")
def _warp_uint8_cf_lowres_cuda(imc, x_ndc_lr, y_ndc_lr, out_hw):
    _on_card(imc, x_ndc_lr, y_ndc_lr)
    B, C, H, W = imc.shape
    Ho, Wo = out_hw
    _check_frames_on_card(imc)
    _check_maps(x_ndc_lr, y_ndc_lr, B)
    _, h, w = x_ndc_lr.shape
    dev = imc.device
    row = device_taps(h, Ho, dev)
    col = device_taps(w, Wo, dev)
    out = torch.empty((B, Ho, Wo, C), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _warp_lib().stabnet_warp_uint8_lowres(
            imc.data_ptr(), x_ndc_lr.data_ptr(), y_ndc_lr.data_ptr(),
            *(t.data_ptr() for t in row), *(t.data_ptr() for t in col),
            out.data_ptr(),
            B, C, H, W, h, w, Ho, Wo, stream)
    _launch_check(err, "warp_uint8_cf_lowres")
    _launched(warp_uint8_cf_lowres)
    return out


# --- the clamped-corner geometry shared by the adjoints' plain versions -------

def _clamped_taps(x_ndc: torch.Tensor, y_ndc: torch.Tensor, H: int, W: int):
    """Strict taps of samples at NDC maps (B, Ho, Wo), as flat (B, Ho*Wo)
    tensors: the element indices of taps a = (y0, x0), b = (y1, x0),
    c = (y0, x1), d = (y1, x1) into a (B, H*W) plane and the weight factors
    ax = x1c - x, bx = x - x0c, ay = y1c - y, by = y - y0c, rounded as
    csrc/bilinear.cuh rounds them."""
    B = x_ndc.shape[0]
    x = ((x_ndc.float() + 1.0) * (W / 2.0)).reshape(B, -1)
    y = ((y_ndc.float() + 1.0) * (H / 2.0)).reshape(B, -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x0c = x0.clamp(0, W - 1)
    x1c = (x0 + 1.0).clamp(0, W - 1)
    y0c = y0.clamp(0, H - 1)
    y1c = (y0 + 1.0).clamp(0, H - 1)
    ix0, ix1 = x0c.long(), x1c.long()
    iy0, iy1 = y0c.long() * W, y1c.long() * W
    taps = (iy0 + ix0, iy1 + ix0, iy0 + ix1, iy1 + ix1)
    return taps, (x1c - x, x - x0c, y1c - y, y - y0c)


# --- K4: the sampler's adjoint in the image (splat) ---------------------------

def _splat_head(Ho: int, Wo: int) -> int:
    """62 - ceil(log2(4 Ho Wo)): no sum of the at most 4 Ho Wo fixed-point
    contributions to one image element overflows int64 (csrc/warp_grad.cu)."""
    return 62 - max(4 * Ho * Wo - 1, 1).bit_length()


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """2.0 ** n as float64, exactly, for int64 n in [-1022, 1023]."""
    return ((n + 1023) << 52).view(torch.float64)


def bilinear_splat_plain(g: torch.Tensor, x_ndc: torch.Tensor,
                         y_ndc: torch.Tensor,
                         im_hw: Tuple[int, int]) -> torch.Tensor:
    """Scatter-add the cotangent of the strict sampler into its image.

    g: (B, Ho, Wo, C) cotangent of `bilinear_sample(im, x_ndc, y_ndc)`;
    maps (B, Ho, Wo).  Returns d<g, out>/d im, (B, H, W, C) float32.  Each
    contribution w * g is rounded in fp32, then summed exactly in 64-bit
    fixed point with a quantum 2^-s set by the largest contribution, and
    rounded once to fp32, as K4 does (csrc/warp_grad.cu): the result is the
    same on every run and on every device (NaN everywhere if a contribution
    is not finite).  The JAX package's equivalent is the XLA sampler's vjp
    in the image (pallas_warp.py:845-853).
    """
    B, Ho, Wo, C = g.shape
    H, W = (int(v) for v in im_hw)
    if g.numel() == 0:
        return torch.zeros((B, H, W, C), device=g.device)
    taps, (ax, bx, ay, by) = _clamped_taps(x_ndc, y_ndc, H, W)
    gf = g.float().reshape(B, Ho * Wo, C)
    contrib = [w[..., None] * gf for w in (ax * ay, ax * by, bx * ay, bx * by)]
    peak = torch.stack([c.abs().amax() for c in contrib]).amax()
    s = _splat_head(Ho, Wo) - torch.frexp(peak).exponent.long()
    scale = _pow2(s)
    base = (torch.arange(B, device=g.device) * (H * W))[:, None]
    acc = torch.zeros((B * H * W, C), dtype=torch.int64, device=g.device)
    for idx, c in zip(taps, contrib):
        q = torch.round(c.double() * scale).long()
        acc.index_add_(0, (base + idx).reshape(-1), q.reshape(-1, C))
    out = (acc.double() * _pow2(-s)).float().reshape(B, H, W, C)
    return torch.where(torch.isfinite(peak), out, math.nan)


@torch.library.custom_op(
    "stabnet::bilinear_splat", mutates_args=(), device_types="cpu",
    schema="(Tensor g, Tensor x_ndc, Tensor y_ndc, int[] im_hw) -> Tensor")
def _bilinear_splat_op(g, x_ndc, y_ndc, im_hw):
    return bilinear_splat_plain(g, x_ndc, y_ndc, tuple(im_hw))


@_bilinear_splat_op.register_kernel("cuda")
def _bilinear_splat_cuda(g, x_ndc, y_ndc, im_hw):
    _on_card(g, x_ndc, y_ndc)
    B, Ho, Wo, C = g.shape
    H, W = im_hw
    _require(g.dtype == torch.float32, f"cotangent must be float32, got {g.dtype}")
    _require(g.is_contiguous(), "cotangent must be contiguous")
    _check_maps(x_ndc, y_ndc, B)
    _require(tuple(x_ndc.shape[1:]) == (Ho, Wo),
             f"maps {tuple(x_ndc.shape)} do not match the cotangent {tuple(g.shape)}")
    dev = g.device
    acc = torch.empty((B, H, W, C), dtype=torch.int64, device=dev)  # pass 1 zero-fills
    max_bits = torch.zeros((1,), dtype=torch.int32, device=dev)
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _grad_lib().stabnet_bilinear_splat_f32(
            g.data_ptr(), x_ndc.data_ptr(), y_ndc.data_ptr(), acc.data_ptr(),
            max_bits.data_ptr(), out.data_ptr(), B, Ho, Wo, C, H, W,
            _splat_head(Ho, Wo), stream)
    _launch_check(err, "bilinear_splat")
    _launched(bilinear_splat)
    return out


@_bilinear_splat_op.register_fake
def _bilinear_splat_fake(g, x_ndc, y_ndc, im_hw):
    return g.new_empty((g.shape[0], *im_hw, g.shape[3]), dtype=torch.float32)


def bilinear_splat(g: torch.Tensor, x_ndc: torch.Tensor, y_ndc: torch.Tensor,
                   im_hw: Tuple[int, int]) -> torch.Tensor:
    """K4: `bilinear_splat_plain` as one CUDA kernel call (three passes;
    plain version on CPU), through `torch.ops.stabnet.bilinear_splat`.
    g (B, Ho, Wo, C) float32, maps (B, Ho, Wo) float32, all contiguous,
    1 <= C <= 4."""
    _no_grad_inputs("bilinear_splat", g, x_ndc, y_ndc)
    _require(g.dim() == 4, f"cotangent must be (B, Ho, Wo, C), got {tuple(g.shape)}")
    B, Ho, Wo, C = (int(v) for v in g.shape)
    H, W = (int(v) for v in im_hw)
    _require(H > 0 and W > 0, f"bad image size {im_hw}")
    _require(1 <= C <= 4, f"bilinear_splat: 1 to 4 channels, got {C}")
    _check_index_range("bilinear_splat", (H, W), B, -(-Ho // 32), C * H * W, C * Ho * Wo)
    _on_cpu(g, x_ndc, y_ndc)
    return torch.ops.stabnet.bilinear_splat(g, x_ndc, y_ndc, [H, W])


bilinear_splat.launches = 0


# --- K6b: the sampler's derivative in the maps --------------------------------

def sample_map_grad_plain(im: torch.Tensor, x_ndc: torch.Tensor,
                          y_ndc: torch.Tensor, g: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """d<g, bilinear_sample(im, x, y)>/d(x_ndc, y_ndc) at a fixed image.

    im (B, H, W, C), maps (B, Ho, Wo), g (B, Ho, Wo, C).  Returns (gx, gy),
    each (B, Ho, Wo) float32: with the four clamped taps Ia..Id,
    dodx = ay (Ic - Ia) + by (Id - Ib), dody = ax (Ib - Ia) + bx (Id - Ic),
    summed with g over the channels in order and scaled by W/2 and H/2, in
    K6b's operation order (pallas_warp.py:946-985 computes the same).
    """
    B, H, W, C = im.shape
    taps, (ax, bx, ay, by) = _clamped_taps(x_ndc, y_ndc, H, W)
    flat = im.float().reshape(B, H * W, C)
    Ia, Ib, Ic, Id = (torch.gather(flat, 1, t[..., None].expand(-1, -1, C))
                      for t in taps)
    dodx = ay[..., None] * (Ic - Ia) + by[..., None] * (Id - Ib)
    dody = ax[..., None] * (Ib - Ia) + bx[..., None] * (Id - Ic)
    gf = g.float().reshape(B, -1, C)
    px, py = gf * dodx, gf * dody
    sx, sy = px[..., 0], py[..., 0]
    for c in range(1, C):
        sx, sy = sx + px[..., c], sy + py[..., c]
    return ((sx * (W / 2.0)).reshape(x_ndc.shape),
            (sy * (H / 2.0)).reshape(y_ndc.shape))


@torch.library.custom_op(
    "stabnet::sample_map_grad", mutates_args=(), device_types="cpu",
    schema="(Tensor im, Tensor x_ndc, Tensor y_ndc, Tensor g) -> (Tensor, Tensor)")
def _sample_map_grad_op(im, x_ndc, y_ndc, g):
    return sample_map_grad_plain(im, x_ndc, y_ndc, g)


@_sample_map_grad_op.register_kernel("cuda")
def _sample_map_grad_cuda(im, x_ndc, y_ndc, g):
    _on_card(im, x_ndc, y_ndc, g)
    for name, t in (("image", im), ("cotangent", g)):
        _require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
        _require(t.dim() == 4 and t.is_contiguous(),
                 f"{name} must be contiguous 4-D, got {tuple(t.shape)}")
    B, H, W, C = im.shape
    _check_maps(x_ndc, y_ndc, B)
    _, Ho, Wo = x_ndc.shape
    _require(tuple(g.shape) == (B, Ho, Wo, C),
             f"cotangent {tuple(g.shape)} is not (B, Ho, Wo, C) = {(B, Ho, Wo, C)}")
    gx = torch.empty((B, Ho, Wo), dtype=torch.float32, device=im.device)
    gy = torch.empty_like(gx)
    with torch.cuda.device(im.device):
        stream = torch.cuda.current_stream(im.device).cuda_stream
        err = _grad_lib().stabnet_sample_map_grad_f32(
            im.data_ptr(), x_ndc.data_ptr(), y_ndc.data_ptr(), g.data_ptr(),
            gx.data_ptr(), gy.data_ptr(), B, H, W, C, Ho, Wo, stream)
    _launch_check(err, "sample_map_grad")
    _launched(sample_map_grad)
    return gx, gy


@_sample_map_grad_op.register_fake
def _sample_map_grad_fake(im, x_ndc, y_ndc, g):
    return (x_ndc.new_empty(x_ndc.shape, dtype=torch.float32),
            y_ndc.new_empty(y_ndc.shape, dtype=torch.float32))


def sample_map_grad(im: torch.Tensor, x_ndc: torch.Tensor, y_ndc: torch.Tensor,
                    g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6b: `sample_map_grad_plain` as one CUDA kernel (plain on CPU),
    through `torch.ops.stabnet.sample_map_grad`.  im (B, H, W, C), maps
    (B, Ho, Wo), g (B, Ho, Wo, C), all float32 and contiguous."""
    _no_grad_inputs("sample_map_grad", im, x_ndc, y_ndc, g)
    _check_index_range("sample_map_grad", im.shape[1:3])
    _on_cpu(im, x_ndc, y_ndc, g)
    return torch.ops.stabnet.sample_map_grad(im, x_ndc, y_ndc, g)


sample_map_grad.launches = 0


# --- K5 and K6: the strict sampler with one side's gradient -------------------

class _SampleConstMaps(torch.autograd.Function):
    """K2 forward, K4 backward; the maps get no gradient."""

    @staticmethod
    def forward(ctx, im, x_ndc, y_ndc):
        ctx.save_for_backward(x_ndc, y_ndc)
        ctx.im_hw = (im.shape[1], im.shape[2])
        return bilinear_sample(im, x_ndc, y_ndc)

    @staticmethod
    def backward(ctx, g):
        x_ndc, y_ndc = ctx.saved_tensors
        return bilinear_splat(g.contiguous(), x_ndc, y_ndc, ctx.im_hw), None, None


class _SampleConstImage(torch.autograd.Function):
    """K2 forward, K6b backward; the image gets no gradient."""

    @staticmethod
    def forward(ctx, im, x_ndc, y_ndc):
        ctx.save_for_backward(im, x_ndc, y_ndc)
        return bilinear_sample(im, x_ndc, y_ndc)

    @staticmethod
    def backward(ctx, g):
        im, x_ndc, y_ndc = ctx.saved_tensors
        gx, gy = sample_map_grad(im, x_ndc, y_ndc, g.contiguous())
        return None, gx, gy


def bilinear_sample_const_maps(im: torch.Tensor, x_ndc: torch.Tensor,
                               y_ndc: torch.Tensor) -> torch.Tensor:
    """K5: the strict sampler with exact IMAGE gradients and none for the
    maps (the temporal loss warps the sibling branch's output by the flow,
    which is data).  On CUDA tensors an autograd Function of K2 and K4; on
    CPU tensors the plain sampler under ordinary autograd (the reference
    chain: the JAX package's XLA path is plain autodiff too)."""
    if _on_cpu(im, x_ndc, y_ndc):
        return bilinear_sample_plain(im, x_ndc, y_ndc)
    return _SampleConstMaps.apply(im.contiguous(), x_ndc.contiguous(),
                                  y_ndc.contiguous())


def bilinear_sample_const_image(im: torch.Tensor, x_ndc: torch.Tensor,
                                y_ndc: torch.Tensor) -> torch.Tensor:
    """K6: the strict sampler with exact MAP gradients and none for the
    image (the training warp samples the current input frame, which is
    data).  On CUDA tensors an autograd Function of K2 and K6b; on CPU
    tensors the plain sampler under ordinary autograd."""
    if _on_cpu(im, x_ndc, y_ndc):
        return bilinear_sample_plain(im, x_ndc, y_ndc)
    return _SampleConstImage.apply(im.contiguous(), x_ndc.contiguous(),
                                   y_ndc.contiguous())


KERNELS = (bilinear_sample, warp_mesh, warp_uint8_cf_lowres, warp_uint8_cf, bilinear_splat,
           sample_map_grad)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
