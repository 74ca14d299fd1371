// Warp kernels of the serving path, for Hopper (sm_90a).
//
// K2  stabnet_bilinear_sample_f32
//     Replaces the JAX package's `bilinear_sample_pallas`
//     (stabnet_tpu/ops/pallas_warp.py:469, body `_warp_band_kernel` 94-254):
//     the f32 bilinear sampler with the reference semantics of
//     stabnet_tpu/ops/warp.py:114-163, at model scale (S, 288, 512, 1) on the
//     serving path, `refine` times per frame.
//
// K1  stabnet_warp_uint8_lowres
//     Replaces `warp_uint8_cf_lowres` (pallas_warp.py:575-667, same body):
//     the full-resolution uint8 color warp with the up-sample of the 4x-down
//     NDC maps fused in.  (S, 3, 720, 1280) uint8 in, (S, 720, 1280, 3) out,
//     once per frame.
//
// What bounds them on this card: bytes.  Each output pixel costs a few
// dozen flops against 4 tap reads per channel, far below the compute ridge.
// K2 at S=1 must move 2.36 MB (two f32 maps 1,179,648 B, output 589,824 B,
// image >= 589,824 B); K1 at S=1, 720p must move 5.60 MB (low-res maps
// 73,728 B, frame read 2,764,800 B, frame write 2,764,800 B): 0.7 us and
// 1.7 us at 3.35 TB/s.  At these sizes the launch itself is of the same
// order, so the design keeps one launch per call and no intermediate in
// device memory:
//   * one thread per output pixel; neighbouring threads own neighbouring
//     pixels, so map reads and output writes coalesce and the four taps of
//     a warp land in a few cache lines of the (L2-resident) frame;
//   * K1 evaluates the 2x2-tap map up-sample in registers from per-axis tap
//     tables (Ho + Wo entries, 32 KB at 720p, read from L2; the bound above
//     leaves them out), so no full-resolution map exists;
//   * none of the TPU kernel's machinery carries over: there are no one-hot
//     matrix products, no DMA windows that can overflow, hence no guard
//     tiers and no fallback.
//
// Numerics: every product and sum is rounded separately (__fmul_rn /
// __fadd_rn, no FMA contraction), in the order of the plain PyTorch versions
// in stabnet_tpu_torch/ops/cuda_warp.py, so kernel and plain version agree
// bit for bit.  That matters beyond tidiness: the reference sampler is
// discontinuous at its strict upper edge (a sample at exactly W-1 or H-1
// gives 0) and at 0, so one ulp of difference in a coordinate there can flip
// a whole pixel.  For the same reason K1 converts NDC to pixels AFTER the
// up-sample, as the plain version does (the TPU kernel rescaled the low-res
// map first, which saved work on its matrix unit and costs nothing here).
//
// Each entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"

using stabnet::blocks_for;
using stabnet::kThreads;
using stabnet::ndc_to_pixel;

namespace {

// Reference bilinear sample of one (batch, channel) plane at pixel
// coordinates (x, y) (see bilinear.cuh for the tap geometry).
template <typename T>
__device__ __forceinline__ float sample_plane(const T* __restrict__ plane,
                                              long long sx, long long sy,
                                              int H, int W, float x, float y,
                                              bool strict) {
  const stabnet::Taps t = stabnet::clamped_taps(x, y, H, W, sx, sy, strict);
  const float wa = __fmul_rn(t.ax, t.ay);
  const float wb = __fmul_rn(t.ax, t.by);
  const float wc = __fmul_rn(t.bx, t.ay);
  const float wd = __fmul_rn(t.bx, t.by);
  const float Ia = (float)plane[t.a];
  const float Ib = (float)plane[t.b];
  const float Ic = (float)plane[t.c];
  const float Id = (float)plane[t.d];

  float v = __fmul_rn(wa, Ia);
  v = __fadd_rn(v, __fmul_rn(wb, Ib));
  v = __fadd_rn(v, __fmul_rn(wc, Ic));
  v = __fadd_rn(v, __fmul_rn(wd, Id));
  return v;
}

// K2: im (B, H, W, C) f32, maps (B, Ho, Wo) f32 NDC -> out (B, Ho, Wo, C).
template <bool STRICT>
__global__ void bilinear_sample_kernel(const float* __restrict__ im,
                                       const float* __restrict__ xm,
                                       const float* __restrict__ ym,
                                       float* __restrict__ out,
                                       int H, int W, int C, int Ho, int Wo,
                                       long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / ((long long)Ho * Wo);
  const float x = ndc_to_pixel(xm[i], W);
  const float y = ndc_to_pixel(ym[i], H);
  const float* img = im + b * (long long)H * W * C;
  for (int c = 0; c < C; ++c) {
    out[i * C + c] = sample_plane(img + c, (long long)C, (long long)W * C,
                                  H, W, x, y, STRICT);
  }
}

// Two-tap half-pixel up-sample of one low-res map at output pixel (o, p):
// rows first, then columns, as resize_bilinear_bhw does.
__device__ __forceinline__ float upsample_tap(const float* __restrict__ m, int w,
                                             int rlo, int rhi, float rwl, float rwh,
                                             int clo, int chi, float cwl, float cwh) {
  const float v_lo = __fadd_rn(__fmul_rn(rwl, m[rlo * w + clo]),
                               __fmul_rn(rwh, m[rhi * w + clo]));
  const float v_hi = __fadd_rn(__fmul_rn(rwl, m[rlo * w + chi]),
                               __fmul_rn(rwh, m[rhi * w + chi]));
  return __fadd_rn(__fmul_rn(cwl, v_lo), __fmul_rn(cwh, v_hi));
}

// K1: imc (B, C, H, W) u8, low-res maps (B, h, w) f32 NDC, per-axis tap
// tables (row: Ho entries, col: Wo entries) -> out (B, Ho, Wo, C) u8.
__global__ void warp_uint8_lowres_kernel(const uint8_t* __restrict__ imc,
                                         const float* __restrict__ xlr,
                                         const float* __restrict__ ylr,
                                         const int* __restrict__ row_lo,
                                         const int* __restrict__ row_hi,
                                         const float* __restrict__ row_wlo,
                                         const float* __restrict__ row_whi,
                                         const int* __restrict__ col_lo,
                                         const int* __restrict__ col_hi,
                                         const float* __restrict__ col_wlo,
                                         const float* __restrict__ col_whi,
                                         uint8_t* __restrict__ out,
                                         int C, int H, int W, int h, int w,
                                         int Ho, int Wo, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long hw_out = (long long)Ho * Wo;
  const long long b = i / hw_out;
  const int r = (int)(i - b * hw_out);
  const int o = r / Wo;
  const int p = r - o * Wo;

  const int rlo = row_lo[o], rhi = row_hi[o];
  const float rwl = row_wlo[o], rwh = row_whi[o];
  const int clo = col_lo[p], chi = col_hi[p];
  const float cwl = col_wlo[p], cwh = col_whi[p];
  const long long moff = b * (long long)h * w;
  const float xn = upsample_tap(xlr + moff, w, rlo, rhi, rwl, rwh, clo, chi, cwl, cwh);
  const float yn = upsample_tap(ylr + moff, w, rlo, rhi, rwl, rwh, clo, chi, cwl, cwh);
  const float x = ndc_to_pixel(xn, W);
  const float y = ndc_to_pixel(yn, H);

  const long long plane = (long long)H * W;
  const uint8_t* img = imc + b * C * plane;
  for (int c = 0; c < C; ++c) {
    float v = sample_plane(img + c * plane, 1LL, (long long)W, H, W, x, y, true);
    v = fminf(fmaxf(rintf(v), 0.0f), 255.0f);  // round half to even, clip
    out[i * C + c] = (uint8_t)v;
  }
}

}  // namespace

extern "C" int stabnet_bilinear_sample_f32(const void* im, const void* xm,
                                           const void* ym, void* out,
                                           int B, int H, int W, int C,
                                           int Ho, int Wo, int strict_edge,
                                           void* stream) {
  const long long total = (long long)B * Ho * Wo;
  if (total == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (strict_edge) {
    bilinear_sample_kernel<true><<<blocks_for(total), kThreads, 0, s>>>(
        (const float*)im, (const float*)xm, (const float*)ym, (float*)out,
        H, W, C, Ho, Wo, total);
  } else {
    bilinear_sample_kernel<false><<<blocks_for(total), kThreads, 0, s>>>(
        (const float*)im, (const float*)xm, (const float*)ym, (float*)out,
        H, W, C, Ho, Wo, total);
  }
  return (int)cudaGetLastError();
}

extern "C" int stabnet_warp_uint8_lowres(const void* imc, const void* xlr,
                                         const void* ylr,
                                         const void* row_lo, const void* row_hi,
                                         const void* row_wlo, const void* row_whi,
                                         const void* col_lo, const void* col_hi,
                                         const void* col_wlo, const void* col_whi,
                                         void* out, int B, int C, int H, int W,
                                         int h, int w, int Ho, int Wo,
                                         void* stream) {
  const long long total = (long long)B * Ho * Wo;
  if (total == 0) return 0;
  warp_uint8_lowres_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)imc, (const float*)xlr, (const float*)ylr,
      (const int*)row_lo, (const int*)row_hi, (const float*)row_wlo,
      (const float*)row_whi, (const int*)col_lo, (const int*)col_hi,
      (const float*)col_wlo, (const float*)col_whi, (uint8_t*)out,
      C, H, W, h, w, Ho, Wo, total);
  return (int)cudaGetLastError();
}
