"""TV-L1 optical flow (Zach et al. 2007; Sanchez et al., IPOL 2013).

PyTorch port of stabnet_tpu/ops/flow.py.  Training estimates the temporal
loss's flow on the device from the augmented stable pair (`train
--compute-flow`), and the quality metrics (eval/metrics.py) measure camera
motion with it.

The coarse-to-fine pyramid, the warps and the primal-dual iterations are
plain Python loops of batched elementwise tensor operations, each element's
arithmetic in the JAX package's order.  The flow is carried channels first,
u as (B, 2, H, W) and its dual p as (B, 2, 2, H, W) (component, direction),
so the two components' proximal steps are one batched operation.  Every
warp samples the second image and its gradient, three channels, through
kernel K2 in its edge-inclusive mode (`cuda_warp.bilinear_sample` with
`strict_edge=False`, the Pallas sampler's `strict_edge=False` in the JAX
package): one launch per level and warp on CUDA tensors, its plain version
on CPU tensors.  On the card the whole pyramid runs as one captured CUDA
graph (`tvl1_flow`; `tvl1_flow_eager` is the same arithmetic issued one
operation at a time, the CPU path).
"""

from __future__ import annotations

from typing import Tuple

import torch

from stabnet_tpu_torch.ops import cuda_warp
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
    """Forward differences of (..., H, W), zero at the far border."""
    gx = torch.cat([u[..., 1:] - u[..., :-1], torch.zeros_like(u[..., :1])], dim=-1)
    gy = torch.cat([u[..., 1:, :] - u[..., :-1, :], torch.zeros_like(u[..., :1, :])],
                   dim=-2)
    return gx, gy


def _divergence(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence of (..., H, W), adjoint of _grad_forward."""
    dx = torch.cat([px[..., :1], px[..., 1:-1] - px[..., :-2], -px[..., -2:-1]],
                   dim=-1)
    dy = torch.cat([py[..., :1, :], py[..., 1:-1, :] - py[..., :-2, :],
                    -py[..., -2:-1, :]], dim=-2)
    return dx + dy


def _tvl1_level(i0: torch.Tensor, i1: torch.Tensor, u: torch.Tensor, *,
                num_warps: int, num_iters: int, tau: float, lam: float,
                theta: float) -> torch.Tensor:
    """Fixed-point TV-L1 at one pyramid level.  i0/i1 (B, H, W), u (B, 2, H, W)."""
    B, H, W = i0.shape
    dev = i0.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    g1x, g1y = _grad_central(i1)
    fields = torch.stack([i1, g1x, g1y], dim=-1)      # (B, H, W, 3)
    l_t = lam * theta
    sigma = tau / theta
    eps = 1e-9
    p = torch.zeros((B, 2, 2, H, W), dtype=torch.float32, device=dev)
    for _ in range(num_warps):
        u0x, u0y = u[:, 0], u[:, 1]
        # Warp the second image and its gradient to the current flow (one
        # 3-channel pass of K2).
        w = _warp_fields(fields, xs + u0x, ys + u0y).permute(3, 0, 1, 2).contiguous()
        i1w, gx, gy = w[0], w[1], w[2]
        grad_sq = gx * gx + gy * gy
        # rho(u') = I1w + <gradI1w, u' - u0> - I0, linearized at u0.
        rho_c = i1w - gx * u0x - gy * u0y - i0
        # Invariant over the iterations: the thresholds and the three
        # candidate steps' factors, each rounded as the JAX body rounds it.
        g = w[1:]                                     # (2, B, H, W): gx, gy
        lo_thr, hi_thr = -l_t * grad_sq, l_t * grad_sq
        step_lo, step_hi = (l_t * g).transpose(0, 1), (-l_t * g).transpose(0, 1)
        g_b = g.transpose(0, 1)                       # (B, 2, H, W)
        den_sq = grad_sq.clamp_min(eps)[:, None]
        for _ in range(num_iters):
            rho = rho_c + gx * u[:, 0] + gy * u[:, 1]
            # Pointwise thresholding: exact minimizer of the L1 data term.
            case_lo = (rho < lo_thr)[:, None]
            case_hi = (rho > hi_thr)[:, None]
            d = torch.where(case_lo, step_lo,
                            torch.where(case_hi, step_hi, -rho[:, None] * g_b / den_sq))
            v = u + d
            # TV proximal step on both flow components via their dual fields.
            u = v + theta * _divergence(p[:, :, 0], p[:, :, 1])
            gux, guy = _grad_forward(u)
            den = 1.0 + sigma * _sqrt(gux * gux + guy * guy)
            p = torch.stack([(p[:, :, 0] + sigma * gux) / den,
                             (p[:, :, 1] + sigma * guy) / den], dim=2)
    return u


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
      On CUDA tensors one call launches K2 num_levels * num_warps times.
      No value goes to the host: the intensity range stays on the device,
      so the whole call can be captured as one graph.
    """
    B, H, W = i0.shape
    lo = torch.minimum(i0.min(), i1.min())
    hi = torch.maximum(i0.max(), i1.max())
    scale = 255.0 / torch.clamp_min(hi - lo, 1e-6)
    i0 = (i0.float() - lo) * scale
    i1 = (i1.float() - lo) * scale

    # Static pyramid (coarse shapes rounded to multiples of 8, as the JAX
    # package rounds them for the TPU's layout).
    shapes = [(H, W)]
    for _ in range(num_levels - 1):
        h, w = shapes[-1]
        shapes.append((max(h // 2 // 8 * 8, 16), max(w // 2 // 8 * 8, 16)))
    pyr0, pyr1 = [i0], [i1]
    for hw in shapes[1:]:
        pyr0.append(resize_bilinear_bhw(pyr0[-1], hw))
        pyr1.append(resize_bilinear_bhw(pyr1[-1], hw))

    u = torch.zeros((B, 2) + shapes[-1], dtype=torch.float32, device=i0.device)
    for lvl in range(num_levels - 1, -1, -1):
        u = _tvl1_level(pyr0[lvl], pyr1[lvl], u, num_warps=num_warps,
                        num_iters=(fine_iters if lvl == 0 else num_iters),
                        tau=tau, lam=lam, theta=theta)
        if lvl > 0:
            h, w = shapes[lvl - 1]
            hs, ws = shapes[lvl]
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
