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

// The four taps of a sample at pixel coordinates (x, y) of one plane whose
// column stride is `sx` and row stride `sy` elements.  The taps are
// a = (y0, x0), b = (y1, x0), c = (y0, x1), d = (y1, x1) after clamping, and
// the bilinear weights are wa = ax*ay, wb = ax*by, wc = bx*ay, wd = bx*by.
struct Taps {
  long long a, b, c, d;   // element offsets of the four taps
  float ax, bx, ay, by;   // x1c - x, x - x0c, y1c - y, y - y0c
};

__device__ __forceinline__ Taps clamped_taps(float x, float y, int H, int W,
                                             long long sx, long long sy,
                                             bool strict) {
  float x0 = floorf(x);
  float y0 = floorf(y);
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

  Taps t;
  t.ax = __fsub_rn(x1c, x);
  t.bx = __fsub_rn(x, x0c);
  t.ay = __fsub_rn(y1c, y);
  t.by = __fsub_rn(y, y0c);
  const long long ix0 = (long long)x0c * sx, ix1 = (long long)x1c * sx;
  const long long iy0 = (long long)y0c * sy, iy1 = (long long)y1c * sy;
  t.a = iy0 + ix0;
  t.b = iy1 + ix0;
  t.c = iy0 + ix1;
  t.d = iy1 + ix1;
  return t;
}

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace stabnet
