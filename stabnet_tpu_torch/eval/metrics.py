"""Stabilization quality metrics: stability / cropping / distortion.

PyTorch port of stabnet_tpu/eval/metrics.py.  The StabNet paper evaluates
with the cropping, distortion and stability scores of Liu et al., "Bundled
Camera Paths for Video Stabilization" (SIGGRAPH 2013):

  * inter-frame and cross-video motion is measured with the port's TV-L1
    flow (ops/flow.py) sampled on a coarse grid and least-squares fitted to
    a homography, after a phase-correlation pre-alignment for inter-frame
    pairs;
  * the stability score is the JAX package's velocity-spectrum variant with
    a measurement-noise floor (see `stability_score`), not comparable to
    published BCP/StabNet absolute numbers;
  * distortion is the worst anisotropy of the input->output fit, cropping
    its mean retained scale.

Two deliberate differences from the JAX package: the chain runs on the
device it is given, CUDA by default (the JAX package pins it to the host
CPU), and `score_stabilized_clip` uses no OpenCV (the output frames go to
gray on the device through `stream.engine.gray_from_color`, the input's
down-scale is an area average, which is what OpenCV's INTER_AREA computes).

On the card each chunk of frame pairs (`_pairs_h_chunk`, the JAX package's
jitted chunk, stabnet_tpu/eval/metrics.py:399-444) replays one captured
CUDA graph per (prealign, rect given) and shape (utils/graphs.py); the CPU
runs the same body eagerly.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from stabnet_tpu_torch.ops.flow import tvl1_flow_eager
from stabnet_tpu_torch.utils import device_constant, resolve_device
from stabnet_tpu_torch.utils.graphs import GraphCache
from stabnet_tpu_torch.utils.profiling import span


# The correspondence grid's spacing and border margin, pixels.
_GRID_STEP = 16
_GRID_MARGIN = 16


def _grid_correspondences(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample (T, H, W, 2) flow on a coarse interior grid: returns (src (N, 2),
    dst (T, N, 2)) pixel coordinates."""
    T, H, W = u.shape[:3]
    # An 8-DOF fit needs a well-spread grid: never below ~5x5 points.
    step = max(4, min(_GRID_STEP, min(H, W) // 6))
    margin = max(4, min(_GRID_MARGIN, min(H, W) // 6))
    ys = torch.arange(margin, H - margin, step, device=u.device)
    xs = torch.arange(margin, W - margin, step, device=u.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gy, gx = gy.reshape(-1), gx.reshape(-1)
    src = torch.stack([gx, gy], dim=-1).float()
    return src, src[None] + u[:, gy, gx]


def _rect_fill(frames: torch.Tensor, rect) -> torch.Tensor:
    """Replace everything outside the delivered rect of (T, H, W) frames with
    the nearest inside-rect pixel (edge replication), so the static black
    canvas cannot anchor the motion estimators (the JAX package's
    `_rect_fill` gives the measurements behind this)."""
    top, left, bot, right = (int(v) for v in rect)
    iy = torch.arange(frames.shape[1], device=frames.device).clamp(top, bot)
    ix = torch.arange(frames.shape[2], device=frames.device).clamp(left, right)
    return frames[:, iy][:, :, ix]


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as elementwise products and a sum: full float32 whatever the
    process's TF32 setting for matrix products."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def fit_homographies(src: torch.Tensor, dst: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hartley-normalized weighted least-squares homography fit per frame.

    src (N, 2); dst (T, N, 2); weights optional (T, N), where a frame with
    fewer than 10 active points falls back to all points.  Returns (T, 3, 3)
    homographies mapping src -> dst, scale-unnormalized (H[2, 2] != 1 in
    general; `_normalize_h` divides it out).  One batched solve of the 8x8
    normal equations with a 1e-6 ridge (stabnet_tpu/eval/metrics.py:128-204).
    """
    T, N = dst.shape[:2]
    dev = dst.device
    if weights is None:
        weights = torch.ones((T, N), dtype=src.dtype, device=dev)
    root2 = math.sqrt(2.0)

    cs = src.mean(dim=0)
    ss = root2 / torch.clamp_min(((src - cs) ** 2).sum(-1).mean().sqrt(), 1e-6)
    sn = (src - cs) * ss
    x, y = sn[:, 0], sn[:, 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    z, o = zeros[0], ones[0]
    T_src = torch.stack([ss, z, -ss * cs[0], z, ss, -ss * cs[1], z, z, o]).reshape(3, 3)

    wi = torch.where((weights.sum(-1) >= 10.0)[:, None], weights,
                     torch.ones_like(weights))
    wsum = torch.clamp_min(wi.sum(-1), 1e-6)                       # (T,)
    cd = (dst * wi[..., None]).sum(1) / wsum[:, None]              # (T, 2)
    sd = root2 / torch.clamp_min(
        ((((dst - cd[:, None]) ** 2).sum(-1) * wi).sum(-1) / wsum).sqrt(), 1e-6)
    dn = (dst - cd[:, None]) * sd[:, None, None]
    u, v = dn[..., 0], dn[..., 1]                                  # (T, N)
    xb, yb = x.expand(T, N), y.expand(T, N)
    zb, ob = zeros.expand(T, N), ones.expand(T, N)
    rows_u = torch.stack([xb, yb, ob, zb, zb, zb, -u * x, -u * y], dim=-1)
    rows_v = torch.stack([zb, zb, zb, xb, yb, ob, -v * x, -v * y], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=1)                          # (T, 2N, 8)
    b = torch.cat([u, v], dim=1)
    ww = torch.cat([wi, wi], dim=1)
    Aw = A * ww[..., None]
    AtA = _matmul(Aw.transpose(1, 2), A) + 1e-6 * torch.eye(8, device=dev)
    h = torch.linalg.solve_ex(AtA, _matmul(Aw.transpose(1, 2), b[..., None]))[0][..., 0]
    Hn = torch.cat([h, torch.ones((T, 1), device=dev)], dim=-1).reshape(T, 3, 3)
    zt, ot = torch.zeros_like(sd), torch.ones_like(sd)
    T_dst_inv = torch.stack([torch.stack([1.0 / sd, zt, cd[:, 0]], -1),
                             torch.stack([zt, 1.0 / sd, cd[:, 1]], -1),
                             torch.stack([zt, zt, ot], -1)], 1)
    return _matmul(_matmul(T_dst_inv, Hn), T_src)


def _rect_shrink(h: int, w: int) -> float:
    """Pixels to shrink the delivered rect by before point inclusion (TV-L1's
    regularization bleeds the border's flow a few pixels into the content):
    8 px at frames of 128 px and more, less on tiny frames."""
    return float(max(2, min(8, min(h, w) // 16)))


def _rect_mask(pts: torch.Tensor, rect: torch.Tensor, shrink: float) -> torch.Tensor:
    """0/1 weights of points inside a (top, left, bottom, right) rect."""
    top, left, bot, right = rect[0], rect[1], rect[2], rect[3]
    x, y = pts[..., 0], pts[..., 1]
    inside = ((x >= left + shrink) & (x <= right - shrink)
              & (y >= top + shrink) & (y <= bot - shrink))
    return inside.float()


def _normalize_h(Hm: torch.Tensor) -> torch.Tensor:
    return Hm / Hm[..., 2:3, 2:3]


# Measurement-noise floors of the stability components (the JAX package
# measured its chain's per-frame error at 0.06-0.08 px and ~5e-4 rad): motion
# below them scores as smooth, not as white-noise shake.
_NOISE_FLOOR_PX = 0.1
_NOISE_FLOOR_RAD = 0.002
# The stability score's low band: the non-DC frequencies below this index.
_BAND_EDGE = 6


def stability_score(Hs: torch.Tensor) -> torch.Tensor:
    """Spectral smoothness of the camera motion (higher = steadier, (0, 1]).

    Hs: (T-1, 3, 3) inter-frame homographies of the output video.  Each of
    the translation (tx, ty) and rotation series is scored as the energy of
    its lowest `_BAND_EDGE - 1` non-DC frequencies over its total non-DC
    energy, both plus the energy of white noise at the component's floor;
    the score is the minimum of the three (stabnet_tpu/eval/metrics.py:241-295
    says why the velocity series and not the cumulative path).
    """
    Hn = _normalize_h(Hs)
    tx = Hn[:, 0, 2]
    ty = Hn[:, 1, 2]
    rot = torch.atan2(Hn[:, 1, 0], Hn[:, 0, 0])

    def score(delta, sigma0):
        n = delta.shape[0]
        spec = torch.fft.rfft(delta).abs() ** 2
        non_dc = spec[1:]
        low = non_dc[:_BAND_EDGE - 1].sum()
        total = non_dc.sum()
        e0 = 0.5 * n * n * sigma0 * sigma0
        return (low + e0) / (total + e0)

    return torch.minimum(
        torch.minimum(score(tx, _NOISE_FLOOR_PX), score(ty, _NOISE_FLOOR_PX)),
        score(rot, _NOISE_FLOOR_RAD))


def distortion_score(Hs: torch.Tensor) -> torch.Tensor:
    """Anisotropy of the input->output mapping (higher = less distortion):
    the worst frame's ratio of the two singular values of the fit's affine
    part.  Hs: (T, 3, 3) per-frame input->output homographies."""
    A = _normalize_h(Hs)[:, :2, :2]
    s = torch.linalg.svdvals(A)                                    # (T, 2), desc
    return (s[:, 1] / torch.clamp_min(s[:, 0], 1e-12)).min()


def cropping_score(Hs: torch.Tensor) -> torch.Tensor:
    """Retained scale of the input->output mapping (higher = less cropping):
    the mean over frames of 1 / sqrt(|det A|) of the fit's affine part,
    clipped at 1.  Hs: (T, 3, 3) per-frame input->output homographies."""
    A = _normalize_h(Hs)[:, :2, :2]
    det = (A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]).abs()
    scale = torch.clamp_min(det, 1e-12).sqrt()
    return torch.clamp_max(1.0 / torch.clamp_min(scale, 1e-6), 1.0).mean()


# Evaluation is offline: the flow runs at full quality at the finest level.
_FINE_ITERS = 100


@functools.lru_cache(maxsize=None)
def _hann(n: int) -> np.ndarray:
    """`jnp.hanning(n)` as the JAX package builds it, in float32:
    0.5 * (1 - cos(2 pi k / (n - 1)))."""
    if n <= 1:
        return np.ones((n,), np.float32)
    k = torch.arange(n, dtype=torch.float32)
    return (0.5 * (1 - torch.cos(2 * np.pi * k / (n - 1)))).numpy()


@functools.lru_cache(maxsize=None)
def _hann_on(n: int, device: torch.device) -> torch.Tensor:
    """`_hann(n)` as a device constant, made at the first call on `device`
    (an eager one: a captured chunk reads it, it never uploads it)."""
    return device_constant(_hann(n), device)


# Phase-correlation peaks farther than this fraction of a side are rejected.
_MAX_SHIFT_FRAC = 0.3


def _global_shift(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer global translation per frame pair by windowed phase
    correlation (TV-L1 alone saturates near ~4 px per frame).

    a, b: (C, H, W).  Returns (sx, sy), (C,) int32 each: content at p in `a`
    sits at p + s in `b`.  Peaks beyond `_MAX_SHIFT_FRAC` of a side are rejected.
    """
    H, W = a.shape[1:]
    dev = a.device
    win = (_hann_on(H, dev)[:, None] * _hann_on(W, dev)[None, :]).to(a.dtype)
    fa = torch.fft.rfft2(a * win)
    fb = torch.fft.rfft2(b * win)
    cross = fb * fa.conj()
    r = torch.fft.irfft2(cross / (cross.abs() + 1e-9), s=(H, W))   # (C, H, W)
    ky = torch.arange(H, device=dev)
    kx = torch.arange(W, device=dev)
    wrap_y = torch.minimum(ky, H - ky)
    wrap_x = torch.minimum(kx, W - kx)
    allowed = ((wrap_y[:, None] <= H * _MAX_SHIFT_FRAC)
               & (wrap_x[None, :] <= W * _MAX_SHIFT_FRAC))
    r = torch.where(allowed, r, -math.inf)
    idx = r.reshape(r.shape[0], -1).argmax(-1)
    sy = idx // W
    sx = idx % W
    sy = torch.where(sy > H // 2, sy - H, sy)
    sx = torch.where(sx > W // 2, sx - W, sx)
    return sx.int(), sy.int()


def _roll2(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Per-frame circular shift of (C, H, W) by per-frame amounts (C,):
    out[c, i, j] = x[c, (i + sy[c]) % H, (j + sx[c]) % W]."""
    C, H, W = x.shape
    iy = (torch.arange(H, device=x.device) + sy[:, None].long()) % H    # (C, H)
    ix = (torch.arange(W, device=x.device) + sx[:, None].long()) % W    # (C, W)
    c = torch.arange(C, device=x.device)[:, None, None]
    return x[c, iy[:, :, None], ix[:, None, :]]


# Frame pairs go through the flow in chunks of this size, the tail padded by
# repeating the last pair: the JAX package's chunks (it compiles the flow
# once for them).  The flow normalizes intensities over a whole call, so the
# scores match the JAX package's only with the same chunks.
_EVAL_CHUNK = 32


def _pairs_h_chunk_eager(a: torch.Tensor, b: torch.Tensor,
                         rect: Optional[torch.Tensor] = None,
                         prealign: bool = False) -> torch.Tensor:
    """(C, H, W) frame pairs -> (C, 3, 3) homographies mapping a -> b, one
    operation at a time (the CPU path, and the body the graphs capture).

    `rect` (a (4,) [top, left, bottom, right] tensor) restricts the fit to
    correspondences landing inside it.  `prealign` removes the global
    integer shift by phase correlation first and adds it back after the
    TV-L1 refinement; grid points whose pre-aligned source wraps around the
    frame edge are weighted out of the fit.  No value goes to the host, and
    the flow is `tvl1_flow_eager` (its own graph cannot be taken inside
    another's capture), so the whole chunk is one graph.
    """
    H, W = a.shape[1:]
    w = None
    if prealign:
        sx, sy = _global_shift(a, b)
        b = _roll2(b, sx, sy)
    u = tvl1_flow_eager(a, b, fine_iters=_FINE_ITERS)
    src, dst = _grid_correspondences(u)
    if prealign:
        dst = dst + torch.stack([sx, sy], dim=-1)[:, None, :].to(dst.dtype)
        x, y = src[:, 0], src[:, 1]
        valid = ((x[None, :] + sx[:, None] >= 0)
                 & (x[None, :] + sx[:, None] <= W - 1)
                 & (y[None, :] + sy[:, None] >= 0)
                 & (y[None, :] + sy[:, None] <= H - 1))
        w = valid.float()
    if rect is not None:
        wr = _rect_mask(dst, rect, _rect_shrink(H, W))               # (C, N)
        w = wr if w is None else w * wr
    return fit_homographies(src, dst, w)


# The metrics chunk's captured graphs, one per (prealign, rect given) and
# chunk shape, for the whole process (as the JAX package's jit cache is).
# One pool for all: the chunks run one at a time and each result is copied
# out before the next call.
GRAPHS = GraphCache(shared_pool=True)


def _pairs_h_chunk(a: torch.Tensor, b: torch.Tensor,
                   rect: Optional[torch.Tensor] = None,
                   prealign: bool = False) -> torch.Tensor:
    """`_pairs_h_chunk_eager`'s homographies (its arguments, its result bit
    for bit), copied out.

    On CUDA frames it replays the captured CUDA graph of the whole chunk
    (phase correlation, flow pyramid, grid and fit) for (prealign, whether
    a rect is given) and the frames' shape (`GRAPHS`, the counterpart of
    the JAX package's `jax.jit` of `_pairs_h_chunk`), captured at the first
    such call, which runs eagerly.  The rect is an input of the graph, as
    it is a traced argument in JAX, so per-clip rects share one graph; a
    host rect goes in through a pinned stage.  On CPU frames the cache runs
    `_pairs_h_chunk_eager`.
    """
    inputs = (a, b) if rect is None else (a, b, rect)

    def fn(a, b, rect=None):
        return (_pairs_h_chunk_eager(a, b, rect, prealign=prealign),)

    with torch.no_grad(), GRAPHS.lock:
        (h,) = GRAPHS(("pairs_h_chunk", prealign, rect is not None), fn, inputs, a.device)
        return h.clone()


def _pairs_h(a: torch.Tensor, b: torch.Tensor, rect=None,
             prealign: bool = False) -> torch.Tensor:
    with span("score.pairs") as kept:
        if rect is not None:
            rect = torch.tensor([float(v) for v in rect], dtype=torch.float32)
        out = []
        for s in range(0, a.shape[0], _EVAL_CHUNK):
            ca, cb = a[s:s + _EVAL_CHUNK], b[s:s + _EVAL_CHUNK]
            k = ca.shape[0]
            if k < _EVAL_CHUNK:
                ca = torch.cat([ca, ca[-1:].expand(_EVAL_CHUNK - k, -1, -1)])
                cb = torch.cat([cb, cb[-1:].expand(_EVAL_CHUNK - k, -1, -1)])
            out.append(_pairs_h_chunk(ca, cb, rect, prealign=prealign)[:k])
        if kept is not None:
            # The pairs scored, and the chunks' slots they were padded to.
            kept.counters.update(pairs=a.shape[0], slots=len(out) * _EVAL_CHUNK)
        return torch.cat(out)


def _interframe_h(frames: torch.Tensor, rect=None) -> torch.Tensor:
    """(T, H, W) gray frames -> (T-1, 3, 3) inter-frame homographies; with
    `rect`, the canvas outside it is edge-replicated first and the fit is
    restricted to points inside it."""
    if rect is not None:
        frames = _rect_fill(frames, rect)
    return _pairs_h(frames[:-1], frames[1:], rect, prealign=True)


def _crossvideo_h(a: torch.Tensor, b: torch.Tensor, rect=None) -> torch.Tensor:
    """Per-frame homographies mapping video `a`'s frames to video `b`'s."""
    return _pairs_h(a, b, rect)


def evaluate_clip(output_gray, input_gray=None, rect=None,
                  device=None) -> Dict[str, float]:
    """Score one stabilized clip.

    Args:
      output_gray: (T, H, W) stabilized grayscale frames (any affine range),
        an array or a tensor.
      input_gray: optional (T, H, W) original frames; enables the cropping
        and distortion scores (they compare input to output).
      rect: optional (top, left, bottom, right) delivered-crop bounds in
        output pixels: correspondences are restricted to it and the canvas
        outside it is edge-replicated for the stability measurement.
      device: where the chain runs; CUDA by default (raises without it),
        "cpu" for the CPU.

    Returns:
      dict with `stability` and, with input_gray, `cropping` and
      `distortion`, all in (0, 1], higher is better.
    """
    dev = resolve_device(device)
    out_t = torch.as_tensor(output_gray).to(dev, torch.float32)
    Hs = _interframe_h(out_t, rect)
    with span("score.reduce"):
        scores = {"stability": float(stability_score(Hs))}
    if input_gray is not None:
        in_t = torch.as_tensor(input_gray).to(dev, torch.float32)
        Hs_cross = _crossvideo_h(in_t, out_t, rect)
        with span("score.reduce"):
            scores["cropping"] = float(cropping_score(Hs_cross))
            scores["distortion"] = float(distortion_score(Hs_cross))
    return scores


# Scores are measured at a capped working resolution: the spectral ratio and
# the anisotropy and scale scores are resolution-normalized, and the flow's
# cost grows with the pixels.  57600 px = 180 x 320.
_EVAL_MAX_AREA = 180 * 320


def _eval_downscale(h: int, w: int) -> int:
    ds = 1
    while (h // ds) * (w // ds) > _EVAL_MAX_AREA:
        ds *= 2
    return ds


@functools.lru_cache(maxsize=None)
def _area_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) area-average resize weights: output pixel o averages the
    source interval [o s, (o + 1) s), s = n_in / n_out, by overlap (OpenCV's
    INTER_AREA; at an integer s the mean of s pixels)."""
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    j = np.arange(n_in)[None, :]
    overlap = np.clip(np.minimum(lo + s, j + 1) - np.maximum(lo, j), 0.0, None)
    return overlap / s


def _area_downscale(frames: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(T, H, W) -> (T, Ho, Wo) by area averaging along each axis (in
    float64, so no TF32 setting reaches it)."""
    dev = frames.device
    Rr = torch.from_numpy(_area_matrix(frames.shape[1], out_hw[0])).to(dev, torch.float64)
    Rc = torch.from_numpy(_area_matrix(frames.shape[2], out_hw[1])).to(dev, torch.float64)
    return (Rr @ frames.double() @ Rc.T).float()


def _eval_grays(output_frames, input_gray, model_hw: Tuple[int, int],
                dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """`score_stabilized_clip`'s inputs at the evaluation scale on `dev`:
    (out_gray (T, h, w), in_gray (T', h, w), ds), h, w = model_hw // ds."""
    from stabnet_tpu_torch.stream.engine import gray_from_color

    ds = _eval_downscale(*model_hw)
    eh, ew = model_hw[0] // ds, model_hw[1] // ds
    frames = np.asarray(output_frames)
    out_gray = torch.cat([
        gray_from_color(torch.from_numpy(frames[s:s + _EVAL_CHUNK]).to(dev)
                        .permute(0, 3, 1, 2), (eh, ew))
        for s in range(0, len(frames), _EVAL_CHUNK)])
    in_gray = torch.as_tensor(input_gray).to(dev, torch.float32)
    if ds > 1:
        in_gray = _area_downscale(in_gray, (eh, ew))
    return out_gray, in_gray, ds


def score_stabilized_clip(output_frames, input_gray, model_hw: Tuple[int, int],
                          crop_rect: Optional[Tuple[int, int, int, int]] = None,
                          device=None) -> Dict[str, float]:
    """The per-clip quality record of `stabilize --metrics`.

    The stabilized output is rescored at the evaluation scale (model scale,
    down-scaled by a power of 2 to at most `_EVAL_MAX_AREA` pixels) against
    the same-scale input, with the input's own stability as the improvement
    anchor and the retained crop area when the black-border rect is known.

    Args:
      output_frames: (T, Ho, Wo, 3) uint8 BGR stabilized frames (any size);
        made gray at the evaluation scale on the device
        (`stream.engine.gray_from_color`, within 1/255 of OpenCV's).
      input_gray: (T, H, W) model-scale grayscale input frames.
      model_hw: (H, W) model scale.
      crop_rect: optional (top, left, bottom, right) max-clear rect at model
        scale.
      device: CUDA by default (raises without it), "cpu" for the CPU.

    Returns:
      dict with stability / cropping / distortion / stability_input and,
      with crop_rect, crop_area, all in (0, 1], higher is better.
    """
    dev = resolve_device(device)
    h, w = model_hw
    with span("score.clip"):
        with span("score.grays"):
            out_gray, in_gray, ds = _eval_grays(output_frames, input_gray, model_hw, dev)
        n = min(len(out_gray), len(in_gray))
        rect = None
        if crop_rect is not None:
            top, left, bot, right = crop_rect
            rect = (top // ds, left // ds, bot // ds, right // ds)
        scores = evaluate_clip(out_gray[:n], in_gray[:n], rect=rect, device=dev)
        scores["stability_input"] = evaluate_clip(in_gray[:n], device=dev)["stability"]
        if crop_rect is not None:
            top, left, bot, right = crop_rect
            scores["crop_area"] = float((bot - top + 1) * (right - left + 1) / (h * w))
    return scores
