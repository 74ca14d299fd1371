// The reference bilinear tap geometry, shared by the sampler (warp.cu) and
// its two adjoints (warp_grad.cu), so forward and backward see the same
// corners and the same weight factors, rounded the same way.
//
// Reference semantics (stabnet_tpu/ops/warp.py:114-163): NDC -> pixel as
// (ndc + 1) * size / 2; corner indices are clamped to the image and the
// weight factors are built from the CLAMPED corners, so samples fade to zero
// outside the frame; with `strict` a sample at exactly W-1 (H-1) gives 0,
// without it the edge pixel is included (stabnet_tpu/ops/pallas_warp.py:184-189).
// Every product and sum is rounded separately (__fmul_rn / __fadd_rn, no FMA
// contraction), in the order of the plain PyTorch versions in
// stabnet_tpu_torch/ops/cuda_warp.py, so kernels and plain versions agree
// bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace stabnet {

// NDC -> pixel: (ndc + 1) * (size / 2), two roundings as in the plain version.
__device__ __forceinline__ float ndc_to_pixel(float ndc, int size) {
  return __fmul_rn(__fadd_rn(ndc, 1.0f), 0.5f * (float)size);
}

// The clamped corners of a sample at pixel coordinates (x, y): columns x0, x1
// and rows y0, y1 (integers in [0, W-1] and [0, H-1]) and the weight factors
// ax = x1c - x, bx = x - x0c, ay = y1c - y, by = y - y0c.  The bilinear
// weights are wa = ax*ay (tap (y0, x0)), wb = ax*by (y1, x0), wc = bx*ay
// (y0, x1), wd = bx*by (y1, x1).
struct Corners {
  int x0, x1, y0, y1;
  float ax, bx, ay, by;
};

// The conversions below avoid the card's conversion unit, which issues at a
// fraction of the float rate.  floor(v) for |v| < 2^22: v + 1.5 * 2^23
// rounded down lands on floor(v) + 1.5 * 2^23 exactly (one ulp is 1 there).
__device__ __forceinline__ float floor_small(float v) {
  return __fsub_rn(__fadd_rd(v, 12582912.0f), 12582912.0f);
}

// An integral float in [0, 2^23) as int: the low bits of 2^23 + v.
__device__ __forceinline__ int small_float_to_int(float v) {
  return __float_as_int(__fadd_rn(v, 8388608.0f)) - 0x4b000000;
}

__device__ __forceinline__ Corners clamped_corners(float x, float y, int H, int W,
                                                   bool strict) {
  // Clamping the coordinate to [-2, size + 1] first (a NaN to -2) gives the
  // same clamped corners as floor(x) itself, and keeps it within floor_small.
  float x0 = floor_small(fminf(fmaxf(x, -2.0f), (float)(W + 1)));
  float y0 = floor_small(fminf(fmaxf(y, -2.0f), (float)(H + 1)));
  if (!strict) {
    if (x == (float)(W - 1)) x0 = __fsub_rn(x0, 1.0f);
    if (y == (float)(H - 1)) y0 = __fsub_rn(y0, 1.0f);
  }
  const float wmax = (float)(W - 1);
  const float hmax = (float)(H - 1);
  const float x0c = fminf(fmaxf(x0, 0.0f), wmax);
  const float x1c = fminf(fmaxf(__fadd_rn(x0, 1.0f), 0.0f), wmax);
  const float y0c = fminf(fmaxf(y0, 0.0f), hmax);
  const float y1c = fminf(fmaxf(__fadd_rn(y0, 1.0f), 0.0f), hmax);

  Corners k;
  k.ax = __fsub_rn(x1c, x);
  k.bx = __fsub_rn(x, x0c);
  k.ay = __fsub_rn(y1c, y);
  k.by = __fsub_rn(y, y0c);
  k.x0 = small_float_to_int(x0c);
  k.x1 = small_float_to_int(x1c);
  k.y0 = small_float_to_int(y0c);
  k.y1 = small_float_to_int(y1c);
  return k;
}

// The four taps of a sample at pixel coordinates (x, y) of one plane whose
// column stride is `sx` and row stride `sy` elements: a = (y0, x0),
// b = (y1, x0), c = (y0, x1), d = (y1, x1) after clamping.
struct Taps {
  long long a, b, c, d;   // element offsets of the four taps
  float ax, bx, ay, by;   // x1c - x, x - x0c, y1c - y, y - y0c
};

__device__ __forceinline__ Taps clamped_taps(float x, float y, int H, int W,
                                             long long sx, long long sy,
                                             bool strict) {
  const Corners k = clamped_corners(x, y, H, W, strict);
  Taps t;
  t.ax = k.ax;
  t.bx = k.bx;
  t.ay = k.ay;
  t.by = k.by;
  const long long ix0 = k.x0 * sx, ix1 = k.x1 * sx;
  const long long iy0 = k.y0 * sy, iy1 = k.y1 * sy;
  t.a = iy0 + ix0;
  t.b = iy1 + ix0;
  t.c = iy0 + ix1;
  t.d = iy1 + ix1;
  return t;
}

// The same taps with 32-bit offsets, for kernels that index within one image
// in 32 bits (their wrappers check that every offset fits).
struct Taps32 {
  unsigned a, b, c, d;    // element offsets of the four taps
  float ax, bx, ay, by;   // x1c - x, x - x0c, y1c - y, y - y0c
};

__device__ __forceinline__ Taps32 clamped_taps32(float x, float y, int H, int W,
                                                 unsigned sx, unsigned sy,
                                                 bool strict) {
  const Corners k = clamped_corners(x, y, H, W, strict);
  Taps32 t;
  t.ax = k.ax;
  t.bx = k.bx;
  t.ay = k.ay;
  t.by = k.by;
  const unsigned ix0 = k.x0 * sx, ix1 = k.x1 * sx;
  const unsigned iy0 = k.y0 * sy, iy1 = k.y1 * sy;
  t.a = iy0 + ix0;
  t.b = iy1 + ix0;
  t.c = iy0 + ix1;
  t.d = iy1 + ix1;
  return t;
}

// The bilinear weights of taps a, b, c, d, rounded as the plain versions
// round them: wa = ax*ay, wb = ax*by, wc = bx*ay, wd = bx*by.
struct Weights {
  float a, b, c, d;
};

__device__ __forceinline__ Weights tap_weights(const Taps32& t) {
  return {__fmul_rn(t.ax, t.ay), __fmul_rn(t.ax, t.by),
          __fmul_rn(t.bx, t.ay), __fmul_rn(t.bx, t.by)};
}

// One plane's sample from its taps: ((wa Ia + wb Ib) + wc Ic) + wd Id.
__device__ __forceinline__ float sample_taps32(const float* __restrict__ plane,
                                               const Taps32& t, const Weights& w) {
  float v = __fmul_rn(w.a, __ldg(plane + t.a));
  v = __fadd_rn(v, __fmul_rn(w.b, __ldg(plane + t.b)));
  v = __fadd_rn(v, __fmul_rn(w.c, __ldg(plane + t.c)));
  v = __fadd_rn(v, __fmul_rn(w.d, __ldg(plane + t.d)));
  return v;
}

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace stabnet
