"""Plain scoring of a stabilized clip: stability, cropping, distortion (the
scores of Liu et al., Bundled Camera Paths, SIGGRAPH 2013, as the StabNet
paper reports them), measured as the program's `stabilize --metrics`
defines them: TV-L1 flow (Zach et al. 2007; Sanchez et al., IPOL 2013)
between frame pairs on a coarse-to-fine pyramid, a phase-correlation
pre-alignment for consecutive frames, a Hartley-normalised least-squares
homography per pair from the flow sampled on a grid, and the scores from
those homographies.  A frozen copy of that plain arithmetic, operation for
operation, written against torch alone; it imports nothing of the program.

`dtype` runs the flow's pyramid and iterations in another precision (the
control's bfloat16); everything else stays float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from benchmarks.reference import geometry as geo

CHUNK = 32            # frame pairs per flow call; the tail repeats its last pair
FINE_ITERS = 100      # iterations per warp at the finest level
GRID_STEP = 16
GRID_MARGIN = 16
NOISE_PX, NOISE_RAD = 0.1, 0.002
BAND_EDGE = 6
MAX_SHIFT_FRAC = 0.3
EVAL_MAX_AREA = 180 * 320


# --- TV-L1 ----------------------------------------------------------------

def taps(n_in: int, n_out: int, device):
    """The two taps of each output sample of a half-pixel bilinear resize."""
    src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (src - lo).astype(np.float32)
    w_lo = (1.0 - f).astype(np.float32)
    w_hi = np.where(hi != lo, f, np.float32(0.0)).astype(np.float32)
    w_lo = np.where(hi != lo, w_lo, np.float32(1.0)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, w_lo, w_hi))


def resize(m: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., Ho, Wo): rows first, then columns, two taps each."""
    H, W = m.shape[-2:]
    if (H, W) == tuple(out_hw):
        return m
    lo, hi, a, b = taps(H, out_hw[0], m.device)
    rows = a[:, None].to(m.dtype) * m[..., lo, :] + b[:, None].to(m.dtype) * m[..., hi, :]
    lo, hi, a, b = taps(W, out_hw[1], m.device)
    return a.to(m.dtype) * rows[..., lo] + b.to(m.dtype) * rows[..., hi]


def over(t: torch.Tensor, n: int) -> torch.Tensor:
    return t / torch.full((), float(n), device=t.device, dtype=t.dtype)


def root(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(t.double()).to(t.dtype)


def grad_central(im):
    gx = torch.cat([im[..., 1:2] - im[..., 0:1], (im[..., 2:] - im[..., :-2]) * 0.5,
                    im[..., -1:] - im[..., -2:-1]], dim=-1)
    gy = torch.cat([im[..., 1:2, :] - im[..., 0:1, :], (im[..., 2:, :] - im[..., :-2, :]) * 0.5,
                    im[..., -1:, :] - im[..., -2:-1, :]], dim=-2)
    return gx, gy


def grad_forward(u):
    gx = torch.cat([u[..., 1:] - u[..., :-1], torch.zeros_like(u[..., :1])], dim=-1)
    gy = torch.cat([u[..., 1:, :] - u[..., :-1, :], torch.zeros_like(u[..., :1, :])], dim=-2)
    return gx, gy


def divergence(px, py):
    dx = torch.cat([px[..., :1], px[..., 1:-1] - px[..., :-2], -px[..., -2:-1]], dim=-1)
    dy = torch.cat([py[..., :1, :], py[..., 1:-1, :] - py[..., :-2, :], -py[..., -2:-1, :]],
                   dim=-2)
    return dx + dy


def warp_fields(fields, x_pix, y_pix):
    """Sample (B, H, W, C) at pixel coordinates clipped just inside the
    frame, the edge pixel included."""
    B, H, W, C = fields.shape
    x = x_pix.clamp(0.0, W - 1.0 - 1e-3)
    y = y_pix.clamp(0.0, H - 1.0 - 1e-3)
    out = geo.sample(fields, over(2.0 * x, W) - 1.0, over(2.0 * y, H) - 1.0, strict_edge=False)
    return out.to(fields.dtype)


def tvl1_level(i0, i1, u, *, num_warps, num_iters, tau, lam, theta):
    B, H, W = i0.shape
    dt, dev = i0.dtype, i0.device
    ys = torch.arange(H, dtype=dt, device=dev)[:, None]
    xs = torch.arange(W, dtype=dt, device=dev)
    g1x, g1y = grad_central(i1)
    fields = torch.stack([i1, g1x, g1y], dim=-1)
    l_t, sigma, eps = lam * theta, tau / theta, 1e-9
    p = torch.zeros((B, 2, 2, H, W), dtype=dt, device=dev)
    for _ in range(num_warps):
        u0x, u0y = u[:, 0], u[:, 1]
        w = warp_fields(fields, xs + u0x, ys + u0y).permute(3, 0, 1, 2).contiguous()
        i1w, gx, gy = w[0], w[1], w[2]
        grad_sq = gx * gx + gy * gy
        rho_c = i1w - gx * u0x - gy * u0y - i0
        g = w[1:]
        lo_thr, hi_thr = -l_t * grad_sq, l_t * grad_sq
        step_lo, step_hi = (l_t * g).transpose(0, 1), (-l_t * g).transpose(0, 1)
        g_b = g.transpose(0, 1)
        den_sq = grad_sq.clamp_min(eps)[:, None]
        for _ in range(num_iters):
            rho = rho_c + gx * u[:, 0] + gy * u[:, 1]
            case_lo = (rho < lo_thr)[:, None]
            case_hi = (rho > hi_thr)[:, None]
            d = torch.where(case_lo, step_lo,
                            torch.where(case_hi, step_hi, -rho[:, None] * g_b / den_sq))
            v = u + d
            u = v + theta * divergence(p[:, :, 0], p[:, :, 1])
            gux, guy = grad_forward(u)
            den = 1.0 + sigma * root(gux * gux + guy * guy)
            p = torch.stack([(p[:, :, 0] + sigma * gux) / den,
                             (p[:, :, 1] + sigma * guy) / den], dim=2)
    return u


def tvl1(i0, i1, *, num_levels=4, num_warps=5, num_iters=100, fine_iters=40, tau=0.25,
         lam=0.15, theta=0.3, dtype=torch.float32):
    """(B, H, W) pairs -> (B, H, W, 2) float32 displacement, i0(p) ~ i1(p + u).
    Intensities are rescaled to [0, 255] over the whole call."""
    B, H, W = i0.shape
    lo = torch.minimum(i0.min(), i1.min())
    hi = torch.maximum(i0.max(), i1.max())
    scale = 255.0 / torch.clamp_min(hi - lo, 1e-6)
    i0 = ((i0.float() - lo) * scale).to(dtype)
    i1 = ((i1.float() - lo) * scale).to(dtype)
    shapes = [(H, W)]
    for _ in range(num_levels - 1):
        h, w = shapes[-1]
        shapes.append((max(h // 2 // 8 * 8, 16), max(w // 2 // 8 * 8, 16)))
    pyr0, pyr1 = [i0], [i1]
    for hw in shapes[1:]:
        pyr0.append(resize(pyr0[-1], hw))
        pyr1.append(resize(pyr1[-1], hw))
    u = torch.zeros((B, 2) + shapes[-1], dtype=dtype, device=i0.device)
    for lvl in range(num_levels - 1, -1, -1):
        u = tvl1_level(pyr0[lvl], pyr1[lvl], u, num_warps=num_warps,
                       num_iters=fine_iters if lvl == 0 else num_iters,
                       tau=tau, lam=lam, theta=theta)
        if lvl > 0:
            h, w = shapes[lvl - 1]
            hs, ws = shapes[lvl]
            up = resize(u, (h, w))
            u = torch.stack([up[:, 0] * (w / ws), up[:, 1] * (h / hs)], dim=1)
    return u.permute(0, 2, 3, 1).float().contiguous()


# --- homographies and scores ------------------------------------------------

def matmul(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def grid_points(u):
    T, H, W = u.shape[:3]
    step = max(4, min(GRID_STEP, min(H, W) // 6))
    margin = max(4, min(GRID_MARGIN, min(H, W) // 6))
    ys = torch.arange(margin, H - margin, step, device=u.device)
    xs = torch.arange(margin, W - margin, step, device=u.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gy, gx = gy.reshape(-1), gx.reshape(-1)
    src = torch.stack([gx, gy], dim=-1).float()
    return src, src[None] + u[:, gy, gx]


def fit(src, dst, weights=None):
    """Hartley-normalised weighted least squares: (T, 3, 3) src -> dst."""
    T, N = dst.shape[:2]
    dev = dst.device
    if weights is None:
        weights = torch.ones((T, N), dtype=src.dtype, device=dev)
    r2 = math.sqrt(2.0)
    cs = src.mean(dim=0)
    ss = r2 / torch.clamp_min(((src - cs) ** 2).sum(-1).mean().sqrt(), 1e-6)
    sn = (src - cs) * ss
    x, y = sn[:, 0], sn[:, 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    z, o = zeros[0], ones[0]
    T_src = torch.stack([ss, z, -ss * cs[0], z, ss, -ss * cs[1], z, z, o]).reshape(3, 3)
    wi = torch.where((weights.sum(-1) >= 10.0)[:, None], weights, torch.ones_like(weights))
    wsum = torch.clamp_min(wi.sum(-1), 1e-6)
    cd = (dst * wi[..., None]).sum(1) / wsum[:, None]
    sd = r2 / torch.clamp_min(((((dst - cd[:, None]) ** 2).sum(-1) * wi).sum(-1) / wsum).sqrt(),
                              1e-6)
    dn = (dst - cd[:, None]) * sd[:, None, None]
    u, v = dn[..., 0], dn[..., 1]
    xb, yb = x.expand(T, N), y.expand(T, N)
    zb, ob = zeros.expand(T, N), ones.expand(T, N)
    A = torch.cat([torch.stack([xb, yb, ob, zb, zb, zb, -u * x, -u * y], dim=-1),
                   torch.stack([zb, zb, zb, xb, yb, ob, -v * x, -v * y], dim=-1)], dim=1)
    b = torch.cat([u, v], dim=1)
    ww = torch.cat([wi, wi], dim=1)
    Aw = A * ww[..., None]
    AtA = matmul(Aw.transpose(1, 2), A) + 1e-6 * torch.eye(8, device=dev)
    h = torch.linalg.solve_ex(AtA, matmul(Aw.transpose(1, 2), b[..., None]))[0][..., 0]
    Hn = torch.cat([h, torch.ones((T, 1), device=dev)], dim=-1).reshape(T, 3, 3)
    zt, ot = torch.zeros_like(sd), torch.ones_like(sd)
    T_dst_inv = torch.stack([torch.stack([1.0 / sd, zt, cd[:, 0]], -1),
                             torch.stack([zt, 1.0 / sd, cd[:, 1]], -1),
                             torch.stack([zt, zt, ot], -1)], 1)
    return matmul(matmul(T_dst_inv, Hn), T_src)


def rect_shrink(h, w):
    return float(max(2, min(8, min(h, w) // 16)))


def rect_mask(pts, rect, shrink):
    top, left, bot, right = rect[0], rect[1], rect[2], rect[3]
    x, y = pts[..., 0], pts[..., 1]
    return ((x >= left + shrink) & (x <= right - shrink)
            & (y >= top + shrink) & (y <= bot - shrink)).float()


def normalize(Hm):
    return Hm / Hm[..., 2:3, 2:3]


def stability(Hs):
    Hn = normalize(Hs)
    tx, ty = Hn[:, 0, 2], Hn[:, 1, 2]
    rot = torch.atan2(Hn[:, 1, 0], Hn[:, 0, 0])

    def score(delta, sigma0):
        n = delta.shape[0]
        spec = torch.fft.rfft(delta).abs() ** 2
        e0 = 0.5 * n * n * sigma0 * sigma0
        return (spec[1:BAND_EDGE].sum() + e0) / (spec[1:].sum() + e0)

    return torch.minimum(torch.minimum(score(tx, NOISE_PX), score(ty, NOISE_PX)),
                         score(rot, NOISE_RAD))


def distortion(Hs):
    s = torch.linalg.svdvals(normalize(Hs)[:, :2, :2])
    return (s[:, 1] / torch.clamp_min(s[:, 0], 1e-12)).min()


def cropping(Hs):
    A = normalize(Hs)[:, :2, :2]
    det = (A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]).abs()
    scale = torch.clamp_min(det, 1e-12).sqrt()
    return torch.clamp_max(1.0 / torch.clamp_min(scale, 1e-6), 1.0).mean()


def hann(n, device):
    k = torch.arange(n, dtype=torch.float32)
    w = (0.5 * (1 - torch.cos(2 * np.pi * k / (n - 1)))) if n > 1 else torch.ones(n)
    return w.to(device)


def global_shift(a, b):
    """Integer translation per pair by windowed phase correlation."""
    H, W = a.shape[1:]
    dev = a.device
    win = hann(H, dev)[:, None] * hann(W, dev)[None, :]
    fa, fb = torch.fft.rfft2(a * win), torch.fft.rfft2(b * win)
    cross = fb * fa.conj()
    r = torch.fft.irfft2(cross / (cross.abs() + 1e-9), s=(H, W))
    ky, kx = torch.arange(H, device=dev), torch.arange(W, device=dev)
    allowed = ((torch.minimum(ky, H - ky)[:, None] <= H * MAX_SHIFT_FRAC)
               & (torch.minimum(kx, W - kx)[None, :] <= W * MAX_SHIFT_FRAC))
    idx = torch.where(allowed, r, -math.inf).reshape(r.shape[0], -1).argmax(-1)
    sy, sx = idx // W, idx % W
    return (torch.where(sx > W // 2, sx - W, sx).int(), torch.where(sy > H // 2, sy - H, sy).int())


def roll2(x, sx, sy):
    C, H, W = x.shape
    iy = (torch.arange(H, device=x.device) + sy[:, None].long()) % H
    ix = (torch.arange(W, device=x.device) + sx[:, None].long()) % W
    c = torch.arange(C, device=x.device)[:, None, None]
    return x[c, iy[:, :, None], ix[:, None, :]]


def pairs_chunk(a, b, rect=None, prealign=False, dtype=torch.float32):
    H, W = a.shape[1:]
    w = None
    if prealign:
        sx, sy = global_shift(a, b)
        b = roll2(b, sx, sy)
    u = tvl1(a, b, fine_iters=FINE_ITERS, dtype=dtype)
    src, dst = grid_points(u)
    if prealign:
        dst = dst + torch.stack([sx, sy], dim=-1)[:, None, :].to(dst.dtype)
        x, y = src[:, 0], src[:, 1]
        w = ((x[None, :] + sx[:, None] >= 0) & (x[None, :] + sx[:, None] <= W - 1)
             & (y[None, :] + sy[:, None] >= 0) & (y[None, :] + sy[:, None] <= H - 1)).float()
    if rect is not None:
        wr = rect_mask(dst, rect, rect_shrink(H, W))
        w = wr if w is None else w * wr
    return fit(src, dst, w)


def pairs(a, b, rect=None, prealign=False, dtype=torch.float32):
    if rect is not None:
        rect = torch.tensor([float(v) for v in rect], dtype=torch.float32, device=a.device)
    out = []
    for s in range(0, a.shape[0], CHUNK):
        ca, cb = a[s:s + CHUNK], b[s:s + CHUNK]
        k = ca.shape[0]
        if k < CHUNK:
            ca = torch.cat([ca, ca[-1:].expand(CHUNK - k, -1, -1)])
            cb = torch.cat([cb, cb[-1:].expand(CHUNK - k, -1, -1)])
        out.append(pairs_chunk(ca, cb, rect, prealign, dtype)[:k])
    return torch.cat(out)


def rect_fill(frames, rect):
    top, left, bot, right = (int(v) for v in rect)
    iy = torch.arange(frames.shape[1], device=frames.device).clamp(top, bot)
    ix = torch.arange(frames.shape[2], device=frames.device).clamp(left, right)
    return frames[:, iy][:, :, ix]


def evaluate(out_gray, in_gray=None, rect=None, dtype=torch.float32) -> Dict[str, float]:
    frames = out_gray if rect is None else rect_fill(out_gray, rect)
    scores = {"stability": float(stability(pairs(frames[:-1], frames[1:], rect, True, dtype)))}
    if in_gray is not None:
        Hs = pairs(in_gray, out_gray, rect, False, dtype)
        scores["cropping"] = float(cropping(Hs))
        scores["distortion"] = float(distortion(Hs))
    return scores


def area_matrix(n_in, n_out):
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    j = np.arange(n_in)[None, :]
    return np.clip(np.minimum(lo + s, j + 1) - np.maximum(lo, j), 0.0, None) / s


@torch.no_grad()
def score_clip(frames: torch.Tensor, input_gray: torch.Tensor, model_hw: Tuple[int, int],
               crop_rect: Optional[Tuple[int, int, int, int]] = None,
               dtype=torch.float32) -> Dict[str, float]:
    """The scores of one stabilized clip: frames (T, Ho, Wo, 3) uint8 BGR on
    the device, input_gray (T, H, W) model-scale, crop_rect at model scale."""
    h, w = model_hw
    ds = 1
    while (h // ds) * (w // ds) > EVAL_MAX_AREA:
        ds *= 2
    eh, ew = h // ds, w // ds
    out = []
    for s in range(0, len(frames), CHUNK):
        c = frames[s:s + CHUNK].float()
        luma = 0.114 * c[..., 0] + 0.587 * c[..., 1] + 0.299 * c[..., 2]
        out.append(resize(luma, (eh, ew)) / 255.0 - 0.5)
    out_gray = torch.cat(out)
    in_gray = input_gray.float()
    if ds > 1:
        dev = in_gray.device
        Rr = torch.from_numpy(area_matrix(in_gray.shape[1], eh)).to(dev, torch.float64)
        Rc = torch.from_numpy(area_matrix(in_gray.shape[2], ew)).to(dev, torch.float64)
        in_gray = (Rr @ in_gray.double() @ Rc.T).float()
    n = min(len(out_gray), len(in_gray))
    rect = None
    if crop_rect is not None:
        top, left, bot, right = crop_rect
        rect = (top // ds, left // ds, bot // ds, right // ds)
    scores = evaluate(out_gray[:n], in_gray[:n], rect, dtype)
    scores["stability_input"] = evaluate(in_gray[:n], dtype=dtype)["stability"]
    if crop_rect is not None:
        top, left, bot, right = crop_rect
        scores["crop_area"] = float((bot - top + 1) * (right - left + 1) / (h * w))
    return scores
