"""The warp kernels (csrc/warp.cu, csrc/warp_grad.cu) and their plain versions.

K2  `bilinear_sample`      replaces stabnet_tpu/ops/pallas_warp.py:469
                           `bilinear_sample_pallas` (f32 sampler, reference
                           semantics, `strict_edge` flag).
K1  `warp_uint8_cf_lowres` replaces stabnet_tpu/ops/pallas_warp.py:575
                           `warp_uint8_cf_lowres` (uint8 color warp with the
                           map up-sample fused in).
K4  `bilinear_splat`       replaces pallas_warp.py:738 `bilinear_splat_pallas`
                           (the strict sampler's adjoint in the image).
K6b `sample_map_grad`      replaces the backward of pallas_warp.py:916
                           (the strict sampler's derivative in the maps).
K5  `bilinear_sample_const_maps` and K6 `bilinear_sample_const_image`
    replace the custom VJPs of pallas_warp.py:878 and :916: autograd
    Functions with K2 forward and K4 or K6b backward.

Each wrapper runs its plain PyTorch version when its tensors lie on the CPU,
and only then.  On CUDA tensors it launches its kernel on the current stream
or raises; nothing falls back.  Every launch adds one to the wrapper's
`launches` attribute, so a run can show that it went through the kernel.
The kernels reproduce the plain versions' arithmetic operation for
operation, so the two agree bit for bit (see the notes in csrc/).

No kernel wrapper carries a gradient: each raises when gradient mode is on
and an input requires grad, on every device, so code that trains on the CPU
cannot silently stop training on the card.  Gradients go through K5 and K6.
"""

from __future__ import annotations

import ctypes
import math
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
    _no_grad_inputs("bilinear_sample", im, x_ndc, y_ndc)
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
    _no_grad_inputs("warp_uint8_cf_lowres", imc, x_ndc_lr, y_ndc_lr)
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


def bilinear_splat(g: torch.Tensor, x_ndc: torch.Tensor, y_ndc: torch.Tensor,
                   im_hw: Tuple[int, int]) -> torch.Tensor:
    """K4: `bilinear_splat_plain` as one CUDA kernel call (three passes;
    plain version on CPU).  g (B, Ho, Wo, C) float32, maps (B, Ho, Wo)
    float32, all contiguous."""
    _no_grad_inputs("bilinear_splat", g, x_ndc, y_ndc)
    if _on_cpu(g, x_ndc, y_ndc):
        return bilinear_splat_plain(g, x_ndc, y_ndc, im_hw)
    _require(g.dtype == torch.float32, f"cotangent must be float32, got {g.dtype}")
    _require(g.dim() == 4 and g.is_contiguous(),
             f"cotangent must be a contiguous (B, Ho, Wo, C), got {tuple(g.shape)}")
    B, Ho, Wo, C = g.shape
    _check_maps(x_ndc, y_ndc, B)
    _require(tuple(x_ndc.shape[1:]) == (Ho, Wo),
             f"maps {tuple(x_ndc.shape)} do not match the cotangent {tuple(g.shape)}")
    H, W = (int(v) for v in im_hw)
    _require(H > 0 and W > 0, f"bad image size {im_hw}")
    dev = g.device
    acc = torch.zeros((B, H, W, C), dtype=torch.int64, device=dev)
    max_bits = torch.zeros((1,), dtype=torch.int32, device=dev)
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _grad_lib().stabnet_bilinear_splat_f32(
            g.data_ptr(), x_ndc.data_ptr(), y_ndc.data_ptr(), acc.data_ptr(),
            max_bits.data_ptr(), out.data_ptr(), B, Ho, Wo, C, H, W,
            _splat_head(Ho, Wo), stream)
    _launch_check(err, "bilinear_splat")
    bilinear_splat.launches += 1
    return out


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


def sample_map_grad(im: torch.Tensor, x_ndc: torch.Tensor, y_ndc: torch.Tensor,
                    g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6b: `sample_map_grad_plain` as one CUDA kernel (plain on CPU).
    im (B, H, W, C), maps (B, Ho, Wo), g (B, Ho, Wo, C), all float32 and
    contiguous."""
    _no_grad_inputs("sample_map_grad", im, x_ndc, y_ndc, g)
    if _on_cpu(im, x_ndc, y_ndc, g):
        return sample_map_grad_plain(im, x_ndc, y_ndc, g)
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
    sample_map_grad.launches += 1
    return gx, gy


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


KERNELS = (bilinear_sample, warp_uint8_cf_lowres, bilinear_splat,
           sample_map_grad)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
