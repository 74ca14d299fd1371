"""TV-L1 optical flow (Zach et al. 2007; Sanchez et al., IPOL 2013).

PyTorch port of stabnet_tpu/ops/flow.py.  Training estimates the temporal
loss's flow on the device from the augmented stable pair (`train
--compute-flow`), and the quality metrics (eval/metrics.py) measure camera
motion with it.

The coarse-to-fine pyramid and the warps are plain Python loops of batched
tensor operations, each element's arithmetic in the JAX package's order.
The flow is carried channels first, u as (B, 2, H, W) and its dual p as
(B, 2, 2, H, W) (component, direction), so the two components' proximal
steps are one batched operation.  Every warp samples the second image and
its gradient, three channels, through kernel K2 in its edge-inclusive mode
(`cuda_warp.bilinear_sample` with `strict_edge=False`, the Pallas sampler's
`strict_edge=False` in the JAX package): one launch per level and warp on
CUDA tensors, its plain version on CPU tensors.  Each primal-dual iteration
is one call of `torch.ops.stabnet.tvl1_iterate` (K7, csrc/tvl1.cu): on CUDA
tensors one launch that reads u, p and the warp's residual and gradient and
writes the new u and p, on CPU tensors its plain version,
`tvl1_iterate_plain`, some forty tensor operations in the order the kernel
repeats.  At a level whose images fit on chip (`onchip_rows`, recorded in
`tvl1_schedule`'s levels) a whole warp's iterations are one call of
`torch.ops.stabnet.tvl1_iterate_n` instead: on CUDA tensors one launch that
holds each image in a thread-block cluster's shared memory throughout, on
CPU tensors the plain iteration n times.  On the card the whole pyramid runs
as one captured CUDA graph (`tvl1_flow`; `tvl1_flow_eager` is the same
arithmetic launched one operation at a time, the CPU path).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Tuple

import torch

from stabnet_tpu_torch.ops import cuda_build, cuda_warp
from stabnet_tpu_torch.ops.resize import resize_bilinear_bhw
from stabnet_tpu_torch.utils.graphs import GraphCache


def _over(t: torch.Tensor, n: int) -> torch.Tensor:
    """t / n, correctly rounded on every device: on CUDA, PyTorch divides
    by a Python number as a product with its rounded reciprocal, which
    differs from the CPU's quotient in the last bit."""
    return t / torch.full((), float(n), device=t.device)


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device: PyTorch's
    float32 sqrt on the CPU can be 1 ulp off it (the card's is not); the
    float64 root of a float32 value, rounded to float32, is it."""
    return torch.sqrt(t.double()).float()


def _warp_fields(fields: torch.Tensor, x_pix: torch.Tensor,
                 y_pix: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) fields at (B, H, W) pixel coords, clamped to edge.

    Coordinates are clipped fractionally inside the frame, so the strict and
    the edge-inclusive sampler give the same value there (the strict one
    fades to zero OUTSIDE the frame, which would poison the residual at the
    borders).
    """
    B, H, W, C = fields.shape
    x = x_pix.clamp(0.0, W - 1.0 - 1e-3)
    y = y_pix.clamp(0.0, H - 1.0 - 1e-3)
    x_ndc = _over(2.0 * x, W) - 1.0
    y_ndc = _over(2.0 * y, H) - 1.0
    return cuda_warp.bilinear_sample(fields, x_ndc.contiguous(), y_ndc.contiguous(),
                                     strict_edge=False)


def _grad_central(im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradient of (..., H, W) with one-sided borders."""
    gx = torch.cat([im[..., 1:2] - im[..., 0:1],
                    (im[..., 2:] - im[..., :-2]) * 0.5,
                    im[..., -1:] - im[..., -2:-1]], dim=-1)
    gy = torch.cat([im[..., 1:2, :] - im[..., 0:1, :],
                    (im[..., 2:, :] - im[..., :-2, :]) * 0.5,
                    im[..., -1:, :] - im[..., -2:-1, :]], dim=-2)
    return gx, gy


def _grad_forward(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences of (..., H, W): gx[x] = u[x + 1] - u[x] for x <
    W - 1 and 0 (+0.0) at x = W - 1; gy likewise down the rows, 0 at
    y = H - 1.  K7 (csrc/tvl1.cu) takes the new u's gradient by this rule."""
    gx = torch.cat([u[..., 1:] - u[..., :-1], torch.zeros_like(u[..., :1])], dim=-1)
    gy = torch.cat([u[..., 1:, :] - u[..., :-1, :], torch.zeros_like(u[..., :1, :])],
                   dim=-2)
    return gx, gy


def _divergence(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence of (..., H, W), adjoint of
    _grad_forward: dx = px[0] at x = 0, px[x] - px[x - 1] inside, -px[W - 2]
    at x = W - 1 (the first rule wins where W = 1); dy likewise down the
    rows with py; the result dx + dy.  K7 (csrc/tvl1.cu) takes the
    divergence by this rule."""
    dx = torch.cat([px[..., :1], px[..., 1:-1] - px[..., :-2], -px[..., -2:-1]],
                   dim=-1)
    dy = torch.cat([py[..., :1, :], py[..., 1:-1, :] - py[..., :-2, :],
                    -py[..., -2:-1, :]], dim=-2)
    return dx + dy


def tvl1_iterate_plain(u: torch.Tensor, p: torch.Tensor, rho_c: torch.Tensor,
                       gx: torch.Tensor, gy: torch.Tensor, *, tau: float, lam: float,
                       theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One primal-dual iteration of TV-L1 at one warp: the new (u, p).

    u (B, 2, H, W) the flow, p (B, 2, 2, H, W) its dual field (component,
    direction), rho_c (B, H, W) the linearized residual's constant part and
    gx, gy (B, H, W) the warped second image's gradient, all float32.  The
    pointwise thresholding of the data term, then the TV proximal step on
    both components through their dual fields.  Each product, sum and
    quotient is one tensor operation, in the order K7 repeats; each Python
    number reaches the operations rounded to float32 once.
    """
    l_t = lam * theta
    sigma = tau / theta
    eps = 1e-9
    # The thresholds and the three candidate steps' factors, each rounded
    # as the JAX body rounds it.
    grad_sq = gx * gx + gy * gy
    g = torch.stack([gx, gy], dim=1)                  # (B, 2, H, W)
    lo_thr, hi_thr = -l_t * grad_sq, l_t * grad_sq
    den_sq = grad_sq.clamp_min(eps)[:, None]
    # rho(u') = I1w + <gradI1w, u' - u0> - I0, linearized at u0.
    rho = rho_c + gx * u[:, 0] + gy * u[:, 1]
    # Pointwise thresholding: exact minimizer of the L1 data term.
    case_lo = (rho < lo_thr)[:, None]
    case_hi = (rho > hi_thr)[:, None]
    d = torch.where(case_lo, l_t * g,
                    torch.where(case_hi, -l_t * g, -rho[:, None] * g / den_sq))
    v = u + d
    # TV proximal step on both flow components via their dual fields.
    u = v + theta * _divergence(p[:, :, 0], p[:, :, 1])
    gux, guy = _grad_forward(u)
    den = 1.0 + sigma * _sqrt(gux * gux + guy * guy)
    p = torch.stack([(p[:, :, 0] + sigma * gux) / den,
                     (p[:, :, 1] + sigma * guy) / den], dim=2)
    return u, p


def _tvl1_lib() -> ctypes.CDLL:
    lib = cuda_build.load("tvl1")
    if not getattr(lib, "_stabnet_typed", False):
        lib.stabnet_tvl1_iterate_f32.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                                                 + [ctypes.c_float] * 4 + [ctypes.c_void_p])
        lib.stabnet_tvl1_iterate_f32.restype = ctypes.c_int
        lib.stabnet_tvl1_iterate_n_f32.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
        lib.stabnet_tvl1_iterate_n_f32.restype = ctypes.c_int
        lib.stabnet_tvl1_onchip_init.argtypes = []
        lib.stabnet_tvl1_onchip_init.restype = ctypes.c_int
        lib._stabnet_typed = True
    return lib


def _check_iterate(u, p, rho_c, gx, gy, name: str = "tvl1_iterate") -> None:
    """K7 takes float32 contiguous u (B, 2, H, W), p (B, 2, 2, H, W) and
    rho_c, gx, gy (B, H, W) of one shape; checked on every device, so the
    plain version takes exactly what the kernel takes."""
    tensors = (u, p, rho_c, gx, gy)
    cuda_warp._require(all(t.dtype == torch.float32 for t in tensors),
                       f"{name}: tensors must be float32, got "
                       f"{[str(t.dtype) for t in tensors]}")
    cuda_warp._require(rho_c.dim() == 3, f"{name}: rho_c must be (B, H, W), got "
                                         f"{tuple(rho_c.shape)}")
    B, H, W = (int(v) for v in rho_c.shape)
    want = ((B, 2, H, W), (B, 2, 2, H, W), (B, H, W), (B, H, W), (B, H, W))
    cuda_warp._require(all(tuple(t.shape) == s for t, s in zip(tensors, want)),
                       f"{name}: shapes {[tuple(t.shape) for t in tensors]}, "
                       f"expected {list(want)}")
    cuda_warp._require(all(t.is_contiguous() for t in tensors),
                       f"{name}: tensors must be contiguous")
    cuda_warp._check_index_range(name, (H, W), B, -(-H // 8), 4 * H * W)


@torch.library.custom_op(
    "stabnet::tvl1_iterate", mutates_args=(), device_types="cpu",
    schema="(Tensor u, Tensor p, Tensor rho_c, Tensor gx, Tensor gy, float tau, "
           "float lam, float theta) -> (Tensor, Tensor)")
def _tvl1_iterate_op(u, p, rho_c, gx, gy, tau, lam, theta):
    return tvl1_iterate_plain(u, p, rho_c, gx, gy, tau=tau, lam=lam, theta=theta)


@_tvl1_iterate_op.register_kernel("cuda")
def _tvl1_iterate_cuda(u, p, rho_c, gx, gy, tau, lam, theta):
    cuda_warp._on_card(u, p, rho_c, gx, gy)
    _check_iterate(u, p, rho_c, gx, gy)
    B, H, W = rho_c.shape
    u_out, p_out = torch.empty_like(u), torch.empty_like(p)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        # Each Python number rounded to float32 once, as PyTorch hands a
        # scalar to a float32 kernel (ctypes rounds to nearest).
        err = _tvl1_lib().stabnet_tvl1_iterate_f32(
            u.data_ptr(), p.data_ptr(), rho_c.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            u_out.data_ptr(), p_out.data_ptr(), B, H, W, lam * theta, theta, tau / theta,
            1e-9, stream)
    cuda_warp._launch_check(err, "tvl1_iterate")
    cuda_warp._launched(tvl1_iterate)
    return u_out, p_out


@_tvl1_iterate_op.register_fake
def _tvl1_iterate_fake(u, p, rho_c, gx, gy, tau, lam, theta):
    return torch.empty_like(u), torch.empty_like(p)


def tvl1_iterate(u: torch.Tensor, p: torch.Tensor, rho_c: torch.Tensor, gx: torch.Tensor,
                 gy: torch.Tensor, *, tau: float, lam: float,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: `tvl1_iterate_plain` as one CUDA kernel (plain version on CPU),
    through `torch.ops.stabnet.tvl1_iterate`; fresh (u, p), the inputs
    untouched.  Shapes and types as `_check_iterate` says."""
    cuda_warp._no_grad_inputs("tvl1_iterate", u, p, rho_c, gx, gy)
    _check_iterate(u, p, rho_c, gx, gy)
    cuda_warp._on_cpu(u, p, rho_c, gx, gy)
    return torch.ops.stabnet.tvl1_iterate(u, p, rho_c, gx, gy, float(tau), float(lam),
                                          float(theta))


tvl1_iterate.launches = 0


# The on-chip kernel (csrc/tvl1.cu `tvl1_iterate_kernel_onchip`) holds an
# image in a cluster of at most ONCHIP_CLUSTER blocks, each a band of whole
# rows of at most ONCHIP_BLOCK_PX pixels (1,024 threads of at most 3 pixels;
# u and p 24 B a pixel in shared memory, the data term in registers).
# Three blocks an image run a 32-image metrics chunk in one wave of 96
# clusters; the card does not hold 32 clusters of four at once.
ONCHIP_CLUSTER = 3
ONCHIP_BLOCK_PX = 3072


def onchip_rows(H: int, W: int) -> int:
    """The rows of a block's band where the on-chip kernel takes (H, W)
    images: those of the fewest blocks, at most ONCHIP_CLUSTER, whose bands
    hold at most ONCHIP_BLOCK_PX pixels each (a cluster's barriers cost
    more than spreading a small image gains); 0 where none do, and each
    iteration is a K7 launch.  The one rule: `tvl1_schedule` records it,
    `tvl1_iterate_n` launches by it."""
    for blocks in range(1, ONCHIP_CLUSTER + 1):
        rows = -(-H // blocks)
        if 0 < rows * W <= ONCHIP_BLOCK_PX:
            return rows
    return 0


def tvl1_iterate_n_plain(u: torch.Tensor, p: torch.Tensor, rho_c: torch.Tensor,
                         gx: torch.Tensor, gy: torch.Tensor, n: int, *, tau: float,
                         lam: float, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """n iterations of `tvl1_iterate_plain` at one warp: the new (u, p),
    fresh tensors (copies of the inputs where n is 0)."""
    if n == 0:
        return u.clone(), p.clone()
    for _ in range(n):
        u, p = tvl1_iterate_plain(u, p, rho_c, gx, gy, tau=tau, lam=lam, theta=theta)
    return u, p


def _check_iterate_n(u, p, rho_c, gx, gy, n: int) -> None:
    """The on-chip kernel takes what K7 takes, n >= 0 iterations, and
    images that `onchip_rows` puts on chip; checked on every device."""
    _check_iterate(u, p, rho_c, gx, gy, name="tvl1_iterate_n")
    H, W = (int(v) for v in rho_c.shape[1:])
    cuda_warp._require(0 <= n <= 2 ** 31 - 1, f"tvl1_iterate_n: n must be in [0, 2^31), "
                                              f"got {n}")
    cuda_warp._require(onchip_rows(H, W) > 0,
                       f"tvl1_iterate_n: ({H}, {W}) images do not fit on chip (a band of "
                       f"{-(-H // ONCHIP_CLUSTER)} rows over {ONCHIP_BLOCK_PX} pixels); "
                       f"iterate with tvl1_iterate")


@torch.library.custom_op(
    "stabnet::tvl1_iterate_n", mutates_args=(), device_types="cpu",
    schema="(Tensor u, Tensor p, Tensor rho_c, Tensor gx, Tensor gy, int n, float tau, "
           "float lam, float theta) -> (Tensor, Tensor)")
def _tvl1_iterate_n_op(u, p, rho_c, gx, gy, n, tau, lam, theta):
    return tvl1_iterate_n_plain(u, p, rho_c, gx, gy, n, tau=tau, lam=lam, theta=theta)


_onchip_ready = set()   # devices whose on-chip kernel may take its shared memory


@_tvl1_iterate_n_op.register_kernel("cuda")
def _tvl1_iterate_n_cuda(u, p, rho_c, gx, gy, n, tau, lam, theta):
    cuda_warp._on_card(u, p, rho_c, gx, gy)
    _check_iterate_n(u, p, rho_c, gx, gy, n)
    B, H, W = rho_c.shape
    u_out, p_out = torch.empty_like(u), torch.empty_like(p)
    with torch.cuda.device(u.device):
        lib = _tvl1_lib()
        if u.device.index not in _onchip_ready:
            cuda_warp._launch_check(lib.stabnet_tvl1_onchip_init(), "tvl1_iterate_n")
            _onchip_ready.add(u.device.index)
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.stabnet_tvl1_iterate_n_f32(
            u.data_ptr(), p.data_ptr(), rho_c.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            u_out.data_ptr(), p_out.data_ptr(), B, H, W, onchip_rows(H, W), n, lam * theta,
            theta, tau / theta, 1e-9, stream)
    cuda_warp._launch_check(err, "tvl1_iterate_n")
    cuda_warp._launched(tvl1_iterate_n)
    return u_out, p_out


@_tvl1_iterate_n_op.register_fake
def _tvl1_iterate_n_fake(u, p, rho_c, gx, gy, n, tau, lam, theta):
    _check_iterate_n(u, p, rho_c, gx, gy, n)
    return torch.empty_like(u), torch.empty_like(p)


def tvl1_iterate_n(u: torch.Tensor, p: torch.Tensor, rho_c: torch.Tensor, gx: torch.Tensor,
                   gy: torch.Tensor, n: int, *, tau: float, lam: float,
                   theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 on chip: `tvl1_iterate_n_plain` as one CUDA launch (plain version
    on CPU), through `torch.ops.stabnet.tvl1_iterate_n`; fresh (u, p), the
    inputs untouched, bit for bit n calls of `tvl1_iterate`.  Shapes and
    types as `_check_iterate_n` says."""
    cuda_warp._no_grad_inputs("tvl1_iterate_n", u, p, rho_c, gx, gy)
    _check_iterate_n(u, p, rho_c, gx, gy, n)
    cuda_warp._on_cpu(u, p, rho_c, gx, gy)
    return torch.ops.stabnet.tvl1_iterate_n(u, p, rho_c, gx, gy, int(n), float(tau),
                                            float(lam), float(theta))


tvl1_iterate_n.launches = 0
# Counted and reset with the warp kernels.
cuda_warp.KERNELS += (tvl1_iterate, tvl1_iterate_n)


def _tvl1_level(i0: torch.Tensor, i1: torch.Tensor, u: torch.Tensor, *,
                num_warps: int, num_iters: int, tau: float, lam: float,
                theta: float, onchip: bool = False) -> torch.Tensor:
    """Fixed-point TV-L1 at one pyramid level.  i0/i1 (B, H, W), u (B, 2, H, W);
    `onchip` (`Tvl1Level.onchip`): each warp's iterations as one
    `tvl1_iterate_n` call, else one `tvl1_iterate` call an iteration."""
    B, H, W = i0.shape
    dev = i0.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    g1x, g1y = _grad_central(i1)
    fields = torch.stack([i1, g1x, g1y], dim=-1)      # (B, H, W, 3)
    u = u.contiguous()                                # K7 takes contiguous tensors
    p = torch.zeros((B, 2, 2, H, W), dtype=torch.float32, device=dev)
    for _ in range(num_warps):
        u0x, u0y = u[:, 0], u[:, 1]
        # Warp the second image and its gradient to the current flow (one
        # 3-channel pass of K2).
        w = _warp_fields(fields, xs + u0x, ys + u0y).permute(3, 0, 1, 2).contiguous()
        i1w, gx, gy = w[0], w[1], w[2]
        # rho(u') = I1w + <gradI1w, u' - u0> - I0, linearized at u0.
        rho_c = i1w - gx * u0x - gy * u0y - i0
        if onchip:
            u, p = tvl1_iterate_n(u, p, rho_c, gx, gy, num_iters, tau=tau, lam=lam,
                                  theta=theta)
            continue
        for _ in range(num_iters):
            u, p = tvl1_iterate(u, p, rho_c, gx, gy, tau=tau, lam=lam, theta=theta)
    return u


class Tvl1Level(NamedTuple):
    """One pyramid level of a `tvl1_flow` call: the frames' shape (B, h, w)
    there, its warps and the primal-dual iterations of each warp, and
    whether its images go on chip (`onchip_rows`): then a warp's iterations
    are one launch on the card, else one K7 launch each."""
    shape: Tuple[int, int, int]
    warps: int
    iters: int
    onchip: bool = False

    @property
    def launches(self) -> int:
        """K7's launches at this level on the card."""
        return self.warps * (1 if self.onchip else self.iters)

    @property
    def px(self) -> int:
        """Pixel updates at this level: pixels times iterations."""
        return self.warps * self.iters * math.prod(self.shape)


def tvl1_schedule(B: int, H: int, W: int, num_levels: int = 4, num_warps: int = 5,
                  num_iters: int = 100, fine_iters: int = 40) -> List[Tvl1Level]:
    """The pyramid `tvl1_flow_eager` runs for (B, H, W) frames and its
    arguments, finest level first: coarse shapes halved and rounded down to
    multiples of 8, at least 16 (as the JAX package rounds them for the
    TPU's layout); `fine_iters` iterations a warp at the finest level,
    `num_iters` elsewhere."""
    shapes = [(H, W)]
    for _ in range(num_levels - 1):
        h, w = shapes[-1]
        shapes.append((max(h // 2 // 8 * 8, 16), max(w // 2 // 8 * 8, 16)))
    return [Tvl1Level((B, h, w), num_warps, fine_iters if lvl == 0 else num_iters,
                      onchip_rows(h, w) > 0)
            for lvl, (h, w) in enumerate(shapes)]


# The flow's captured graphs, one per shape and static arguments, for the
# whole process (as jax.jit's cache is): the training pipeline's thread and
# the metrics reach them through `tvl1_flow`.
GRAPHS = GraphCache()


def tvl1_flow(i0: torch.Tensor, i1: torch.Tensor, *, num_levels: int = 4,
              num_warps: int = 5, num_iters: int = 100, fine_iters: int = 40,
              tau: float = 0.25, lam: float = 0.15,
              theta: float = 0.3) -> torch.Tensor:
    """`tvl1_flow_eager`'s flow (its arguments, its result bit for bit).

    On CUDA tensors it replays the captured CUDA graph of the whole pyramid
    for (B, H, W) and the other arguments (`GRAPHS`, the counterpart of the
    JAX package's `jax.jit` with `lax.fori_loop` bodies), captured at the
    first such call, which runs eagerly; the result is copied out of the
    graph's buffer.  On CPU tensors it is `tvl1_flow_eager`.
    """
    kw = dict(num_levels=num_levels, num_warps=num_warps, num_iters=num_iters,
              fine_iters=fine_iters, tau=tau, lam=lam, theta=theta)
    if i0.device.type != "cuda":
        return tvl1_flow_eager(i0, i1, **kw)

    def fn(a, b):
        return (tvl1_flow_eager(a, b, **kw),)

    with torch.no_grad(), GRAPHS.lock:
        (u,) = GRAPHS(("tvl1_flow",) + tuple(kw.items()), fn, (i0, i1), i0.device)
        return u.clone()


def tvl1_flow_eager(i0: torch.Tensor, i1: torch.Tensor, *, num_levels: int = 4,
                    num_warps: int = 5, num_iters: int = 100, fine_iters: int = 40,
                    tau: float = 0.25, lam: float = 0.15,
                    theta: float = 0.3) -> torch.Tensor:
    """Estimate dense TV-L1 optical flow from i0 to i1, one operation at a
    time (the CPU path, and the reference the graphs are held to).

    Args:
      i0, i1: (B, H, W) grayscale frames on one device; any affine intensity
        range (rescaled to [0, 255] over the whole call: `lam` is calibrated
        for 8-bit intensities, following the IPOL reference implementation).
        One pair's flow therefore depends on the other pairs in the call, as
        in the JAX package.
      num_levels: pyramid depth (scale 0.5 per level).
      num_warps / num_iters: warps per level / primal-dual iterations per
        warp; `fine_iters` applies at the finest level only.

    Returns:
      (B, H, W, 2) float32 pixel displacement u with i0(p) ~= i1(p + u(p)).
      On CUDA tensors one call launches K2 num_levels * num_warps times and
      K7 at each level as `tvl1_schedule` says (`Tvl1Level.launches`): once
      per warp where the level's images go on chip (`tvl1_iterate_n`), else
      once per primal-dual iteration (`tvl1_iterate`).  A metrics chunk,
      (32, 144, 256) at 100 iterations everywhere, makes 500 + 3 * 5 = 515
      launches; a training batch, (10, 288, 512) at fine_iters 40, 200 +
      500 + 2 * 5 = 710.
      No value goes to the host: the intensity range stays on the device,
      so the whole call can be captured as one graph.
    """
    B, H, W = i0.shape
    lo = torch.minimum(i0.min(), i1.min())
    hi = torch.maximum(i0.max(), i1.max())
    scale = 255.0 / torch.clamp_min(hi - lo, 1e-6)
    i0 = (i0.float() - lo) * scale
    i1 = (i1.float() - lo) * scale

    levels = tvl1_schedule(B, H, W, num_levels, num_warps, num_iters, fine_iters)
    pyr0, pyr1 = [i0], [i1]
    for level in levels[1:]:
        pyr0.append(resize_bilinear_bhw(pyr0[-1], level.shape[1:]))
        pyr1.append(resize_bilinear_bhw(pyr1[-1], level.shape[1:]))

    u = torch.zeros((B, 2) + levels[-1].shape[1:], dtype=torch.float32, device=i0.device)
    for lvl in range(num_levels - 1, -1, -1):
        u = _tvl1_level(pyr0[lvl], pyr1[lvl], u, num_warps=levels[lvl].warps,
                        num_iters=levels[lvl].iters, tau=tau, lam=lam, theta=theta,
                        onchip=levels[lvl].onchip)
        if lvl > 0:
            h, w = levels[lvl - 1].shape[1:]
            hs, ws = levels[lvl].shape[1:]
            # Up-sample the flow and rescale the displacement units.
            up = resize_bilinear_bhw(u, (h, w))
            u = torch.stack([up[:, 0] * (w / ws), up[:, 1] * (h / hs)], dim=1)
    return u.permute(0, 2, 3, 1).contiguous()


def flow_to_sampling(u: torch.Tensor) -> torch.Tensor:
    """Displacement flow -> the record / temporal-loss convention.

    The training records store flow as ABSOLUTE NDC sampling coordinates in
    the warp's (x + 1) * size / 2 convention: flow(p) is where frame-2
    content for frame-1 pixel p sits (data/synthetic.py, train/train.py's
    temporal loss).

    u: (B, H, W, 2) pixel displacement from `tvl1_flow`.  Returns (B, H, W,
    2) NDC sampling coordinates.
    """
    B, H, W = u.shape[:3]
    ys = torch.arange(H, dtype=torch.float32, device=u.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=u.device)
    return torch.stack([_over(2.0 * (xs + u[..., 0]), W) - 1.0,
                        _over(2.0 * (ys + u[..., 1]), H) - 1.0], dim=-1)
