"""The serving path's two warp kernels (csrc/warp.cu) and their plain versions.

K2 `bilinear_sample`      replaces stabnet_tpu/ops/pallas_warp.py:469
                          `bilinear_sample_pallas` (f32 sampler, reference
                          semantics, `strict_edge` flag).
K1 `warp_uint8_cf_lowres` replaces stabnet_tpu/ops/pallas_warp.py:575
                          `warp_uint8_cf_lowres` (uint8 color warp with the
                          map up-sample fused in).

Each wrapper runs its plain PyTorch version when its tensors lie on the CPU,
and only then.  On CUDA tensors it launches its kernel on the current stream
or raises; nothing falls back.  Every launch adds one to the wrapper's
`launches` attribute, so a run can show that it went through the kernel.
The kernels reproduce the plain versions' arithmetic operation for
operation, so the two agree bit for bit (see the note in csrc/warp.cu).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

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
        lib._stabnet_typed = True
    return lib


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


def bilinear_sample(im: torch.Tensor, x_ndc: torch.Tensor, y_ndc: torch.Tensor,
                    strict_edge: bool = True) -> torch.Tensor:
    """K2: `bilinear_sample_plain` as one CUDA kernel (plain version on CPU).

    im: (B, H, W, C) float32, maps (B, Ho, Wo) float32, all contiguous.
    """
    if _on_cpu(im, x_ndc, y_ndc):
        return bilinear_sample_plain(im, x_ndc, y_ndc, strict_edge)
    _require(im.dtype == torch.float32, f"image must be float32, got {im.dtype}")
    _require(im.dim() == 4 and im.is_contiguous(),
             f"image must be a contiguous (B, H, W, C), got {tuple(im.shape)}")
    B, H, W, C = im.shape
    _check_maps(x_ndc, y_ndc, B)
    _, Ho, Wo = x_ndc.shape
    out = torch.empty((B, Ho, Wo, C), dtype=torch.float32, device=im.device)
    with torch.cuda.device(im.device):
        stream = torch.cuda.current_stream(im.device).cuda_stream
        err = _warp_lib().stabnet_bilinear_sample_f32(
            im.data_ptr(), x_ndc.data_ptr(), y_ndc.data_ptr(), out.data_ptr(),
            B, H, W, C, Ho, Wo, int(strict_edge), stream)
    _launch_check(err, "bilinear_sample")
    bilinear_sample.launches += 1
    return out


bilinear_sample.launches = 0


# --- K1: uint8 color warp with the fused map up-sample -----------------------

def warp_uint8_cf_lowres_plain(imc: torch.Tensor, x_ndc_lr: torch.Tensor,
                               y_ndc_lr: torch.Tensor,
                               out_hw: Tuple[int, int]) -> torch.Tensor:
    """Up-sample the low-res NDC maps to `out_hw`, sample the channels-first
    uint8 frames with strict edges, round half to even and clip to uint8.

    imc: (B, C, H, W) uint8; maps (B, h, w) float32.  Returns (B, Ho, Wo, C)
    uint8.  The JAX package's equivalent is stream/engine.py:200-204.
    """
    xs = resize_bilinear_bhw(x_ndc_lr.float(), tuple(out_hw))
    ys = resize_bilinear_bhw(y_ndc_lr.float(), tuple(out_hw))
    img = imc.permute(0, 2, 3, 1).float()
    warped = bilinear_sample_plain(img, xs, ys)
    return torch.clamp(torch.round(warped), 0, 255).to(torch.uint8)


def warp_uint8_cf_lowres(imc: torch.Tensor, x_ndc_lr: torch.Tensor,
                         y_ndc_lr: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """K1: `warp_uint8_cf_lowres_plain` as one CUDA kernel (plain on CPU).

    imc: (B, C, H, W) uint8 contiguous; maps (B, h, w) float32 contiguous.
    """
    if _on_cpu(imc, x_ndc_lr, y_ndc_lr):
        return warp_uint8_cf_lowres_plain(imc, x_ndc_lr, y_ndc_lr, out_hw)
    _require(imc.dtype == torch.uint8, f"frames must be uint8, got {imc.dtype}")
    _require(imc.dim() == 4 and imc.is_contiguous(),
             f"frames must be a contiguous (B, C, H, W), got {tuple(imc.shape)}")
    B, C, H, W = imc.shape
    _check_maps(x_ndc_lr, y_ndc_lr, B)
    _, h, w = x_ndc_lr.shape
    Ho, Wo = (int(v) for v in out_hw)
    _require(Ho > 0 and Wo > 0, f"bad output size {out_hw}")
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
    warp_uint8_cf_lowres.launches += 1
    return out


warp_uint8_cf_lowres.launches = 0



KERNELS = (bilinear_sample, warp_uint8_cf_lowres)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
