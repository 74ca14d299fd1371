// The sampler's two adjoints, for the training path on Hopper (sm_90a).
//
// K4  stabnet_bilinear_splat_f32
//     Replaces the JAX package's `bilinear_splat_pallas`
//     (stabnet_tpu/ops/pallas_warp.py:738, body `_splat_kernel` 672-735):
//     d out / d image of the strict sampler at fixed maps, i.e. the
//     scatter-add of the cotangent g (B, Ho, Wo, C), weighted by each
//     sample's four clamped-corner weights, into a (B, H, W, C) image.  It
//     is the backward of K5 (`bilinear_sample_const_maps`), the temporal
//     loss's warp of the sibling branch's output by the flow: (10, 288,
//     512, 2) at batch 10.
//
// K6b stabnet_sample_map_grad_f32
//     Replaces the backward of `bilinear_sample_pallas_const_image`
//     (pallas_warp.py:946-985), which on the TPU fetched the four corner
//     taps with four more sampler calls: d out / d x_ndc and d y_ndc at a
//     fixed image, the backward of K6 (`bilinear_sample_const_image`), the
//     training warp of the current frame: (20, 288, 512, 1) at batch 10.
//
// What bounds them on this card: bytes.  Per output pixel they do a few
// dozen flops against ~16 bytes of map and cotangent reads and 4 taps.
// K4 at batch 10 must move 35.4 MB (g 11,796,480 B, maps 11,796,480 B,
// image cotangent 11,796,480 B), 10.6 us at 3.35 TB/s; K6b at 2B = 20 must
// move 70.8 MB (g, the two maps, the image, gx and gy), 21.1 us.
//
// K4's design.  The TPU grid runs in order, so the Pallas splat could
// read-modify-write overlapping windows; here blocks run in no order, so the
// scatter needs atomics, and fp32 atomicAdd sums in an order that changes
// from run to run.  K4 is deterministic instead: it accumulates in 64-bit
// fixed point with integer atomics, whose sums are exact and so independent
// of order, in three passes:
//   1. the largest |w * g| over all contributions (integer atomicMax on the
//      bits of the non-negative float; a NaN wins);
//   2. each contribution w * g (rounded once in fp32, as the plain version
//      does) times 2^s, rounded half to even to an int64 and atomically
//      added, where s = 62 - ceil(log2(4 Ho Wo)) - e and 2^e bounds the
//      largest contribution: no sum of the at most 4 Ho Wo contributions to
//      one element can overflow, and each is quantised to 2^-s, below 2^-40
//      of the largest contribution;
//   3. each sum times 2^-s to fp32 (NaN everywhere if the maximum was not
//      finite).
// The result is the exactly rounded-to-quantum sum, the same on every run
// and bit for bit the plain version's, which does the same arithmetic with
// `index_add_` on int64.  It costs ~3.7x the bound's bytes (two reads of
// g and the maps, the zero-filled int64 accumulator written, updated in L2
// and read back) and a launch per pass.  Samples outside the frame have
// large weights whose contributions to the clamped edge tap cancel pairwise
// (wa = -wc there); in fixed point they cancel exactly.
//
// K6b's design.  One thread per output pixel gathers its four taps per
// channel and evaluates the exact derivative of the clamped-corner weights
// (linear in the coordinate; the corners are piecewise constant):
//   dodx = ay (Ic - Ia) + by (Id - Ib),  dody = ax (Ib - Ia) + bx (Id - Ic),
// sums g * dod* over the channels in order and scales by W/2 and H/2: one
// launch, no intermediate in device memory, no atomics (each thread owns
// its output).
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

constexpr int kFloatInf = 0x7f800000;  // bits of +inf; larger bits are NaN

// Pass 1: the bits of max |w * g| over every contribution, into *max_bits
// (zero-filled by the caller).  Bits of a non-negative float order as ints.
__global__ void splat_max_kernel(const float* __restrict__ g,
                                 const float* __restrict__ xm,
                                 const float* __restrict__ ym,
                                 int* __restrict__ max_bits,
                                 int H, int W, int C, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int m = 0;
  if (i < total) {
    const float x = ndc_to_pixel(xm[i], W);
    const float y = ndc_to_pixel(ym[i], H);
    const stabnet::Taps t = stabnet::clamped_taps(x, y, H, W, 1, W, true);
    const float w[4] = {__fmul_rn(t.ax, t.ay), __fmul_rn(t.ax, t.by),
                        __fmul_rn(t.bx, t.ay), __fmul_rn(t.bx, t.by)};
    for (int c = 0; c < C; ++c) {
      const float v = g[i * C + c];
      for (int k = 0; k < 4; ++k) {
        m = max(m, __float_as_int(fabsf(__fmul_rn(w[k], v))));
      }
    }
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m > 0) atomicMax(max_bits, m);
}

// The fixed-point exponent s of the largest contribution's bits.
__device__ __forceinline__ int quantum_exponent(int max_bits, int head) {
  int e;
  frexpf(__int_as_float(max_bits), &e);
  return head - e;
}

// Pass 2: scatter round(w * g * 2^s) into the int64 accumulator
// (B, H, W, C), zero-filled by the caller.
__global__ void splat_scatter_kernel(const float* __restrict__ g,
                                     const float* __restrict__ xm,
                                     const float* __restrict__ ym,
                                     const int* __restrict__ max_bits,
                                     unsigned long long* __restrict__ acc,
                                     int H, int W, int C, int Ho, int Wo,
                                     int head, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int mb = *max_bits;
  if (mb >= kFloatInf) return;           // non-finite: pass 3 writes NaN
  const double scale = ldexp(1.0, quantum_exponent(mb, head));
  const long long b = i / ((long long)Ho * Wo);
  const float x = ndc_to_pixel(xm[i], W);
  const float y = ndc_to_pixel(ym[i], H);
  const stabnet::Taps t = stabnet::clamped_taps(x, y, H, W, C, (long long)W * C, true);
  const float w[4] = {__fmul_rn(t.ax, t.ay), __fmul_rn(t.ax, t.by),
                      __fmul_rn(t.bx, t.ay), __fmul_rn(t.bx, t.by)};
  const long long off[4] = {t.a, t.b, t.c, t.d};
  unsigned long long* img = acc + b * (long long)H * W * C;
  for (int c = 0; c < C; ++c) {
    const float v = g[i * C + c];
    for (int k = 0; k < 4; ++k) {
      const long long q = __double2ll_rn((double)__fmul_rn(w[k], v) * scale);
      if (q != 0) atomicAdd(img + off[k] + c, (unsigned long long)q);
    }
  }
}

// Pass 3: out = acc * 2^-s in fp32.
__global__ void splat_convert_kernel(const long long* __restrict__ acc,
                                     const int* __restrict__ max_bits,
                                     float* __restrict__ out, int head,
                                     long long total) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const int mb = *max_bits;
  if (mb >= kFloatInf) {
    out[j] = __int_as_float(0x7fc00000);  // NaN
    return;
  }
  const double inv = ldexp(1.0, -quantum_exponent(mb, head));
  out[j] = __double2float_rn(__ll2double_rn(acc[j]) * inv);
}

// K6b: im (B, H, W, C), maps (B, Ho, Wo), g (B, Ho, Wo, C) -> gx, gy
// (B, Ho, Wo): the strict sampler's derivative in the NDC maps.
__global__ void sample_map_grad_kernel(const float* __restrict__ im,
                                       const float* __restrict__ xm,
                                       const float* __restrict__ ym,
                                       const float* __restrict__ g,
                                       float* __restrict__ gx,
                                       float* __restrict__ gy,
                                       int H, int W, int C, int Ho, int Wo,
                                       long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / ((long long)Ho * Wo);
  const float x = ndc_to_pixel(xm[i], W);
  const float y = ndc_to_pixel(ym[i], H);
  const stabnet::Taps t = stabnet::clamped_taps(x, y, H, W, C, (long long)W * C, true);
  const float* img = im + b * (long long)H * W * C;
  float sx = 0.0f, sy = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float Ia = img[t.a + c];
    const float Ib = img[t.b + c];
    const float Ic = img[t.c + c];
    const float Id = img[t.d + c];
    const float dodx = __fadd_rn(__fmul_rn(t.ay, __fsub_rn(Ic, Ia)),
                                 __fmul_rn(t.by, __fsub_rn(Id, Ib)));
    const float dody = __fadd_rn(__fmul_rn(t.ax, __fsub_rn(Ib, Ia)),
                                 __fmul_rn(t.bx, __fsub_rn(Id, Ic)));
    const float v = g[i * C + c];
    const float px = __fmul_rn(v, dodx);
    const float py = __fmul_rn(v, dody);
    sx = c == 0 ? px : __fadd_rn(sx, px);
    sy = c == 0 ? py : __fadd_rn(sy, py);
  }
  gx[i] = __fmul_rn(sx, 0.5f * (float)W);
  gy[i] = __fmul_rn(sy, 0.5f * (float)H);
}

}  // namespace

// K4.  acc: int64 (B, H, W, C) and max_bits: int32 [1], both zero-filled by
// the caller; out: f32 (B, H, W, C).  head = 62 - ceil(log2(4 Ho Wo)).
extern "C" int stabnet_bilinear_splat_f32(const void* g, const void* xm,
                                          const void* ym, void* acc,
                                          void* max_bits, void* out,
                                          int B, int Ho, int Wo, int C,
                                          int H, int W, int head,
                                          void* stream) {
  const long long total = (long long)B * Ho * Wo;
  const long long n_out = (long long)B * H * W * C;
  if (n_out == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (total > 0) {
    splat_max_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        (const float*)g, (const float*)xm, (const float*)ym, (int*)max_bits,
        H, W, C, total);
    splat_scatter_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        (const float*)g, (const float*)xm, (const float*)ym,
        (const int*)max_bits, (unsigned long long*)acc, H, W, C, Ho, Wo, head,
        total);
  }
  splat_convert_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
      (const long long*)acc, (const int*)max_bits, (float*)out, head, n_out);
  return (int)cudaGetLastError();
}

// K6b.  im f32 (B, H, W, C), maps f32 (B, Ho, Wo), g f32 (B, Ho, Wo, C);
// gx, gy f32 (B, Ho, Wo).
extern "C" int stabnet_sample_map_grad_f32(const void* im, const void* xm,
                                           const void* ym, const void* g,
                                           void* gx, void* gy,
                                           int B, int H, int W, int C,
                                           int Ho, int Wo, void* stream) {
  const long long total = (long long)B * Ho * Wo;
  if (total == 0) return 0;
  sample_map_grad_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)im, (const float*)xm, (const float*)ym, (const float*)g,
      (float*)gx, (float*)gy, H, W, C, Ho, Wo, total);
  return (int)cudaGetLastError();
}
