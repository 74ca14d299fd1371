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
// K3  stabnet_warp_uint8_cf
//     Replaces `warp_uint8_cf` (pallas_warp.py:524-554, same body): the same
//     color warp at full-resolution maps (B, Ho, Wo).  K1's kernel body,
//     templated on the map source.  No path of the system runs it, as in the
//     JAX package.
//
// What bounds them on this card: bytes, by the roofline.  Each output pixel
// costs a few dozen flops against 4 tap reads per channel, far below the
// compute ridge.  K2 at S=1 must move 2.36 MB (two f32 maps 1,179,648 B,
// output 589,824 B, image >= 589,824 B); K1 at S=1, 720p must move 5.60 MB
// (low-res maps 73,728 B, frame read 2,764,800 B, frame write 2,764,800 B):
// 0.7 us and 1.7 us at 3.35 TB/s.  At these sizes the launch itself is of
// the same order, so the design keeps one launch per call and no
// intermediate in device memory:
//   * K2: one thread per output pixel; neighbouring threads own neighbouring
//     pixels, so map reads and output writes coalesce and the four taps of
//     a warp land in a few cache lines of the (L2-resident) frame;
//   * K1 and K3 are in fact bound by the instructions they issue (about 200
//     per pixel at C = 3), not by bytes.  So a block owns an 8 x 128 output
//     tile, a thread 4 adjacent pixels of one row (12 bytes, written as three
//     32-bit stores), with no division by runtime sizes, no branch per pixel
//     and 32-bit offsets within an image; the byte-to-float, floor,
//     float-to-int and rounding steps use exact float bit tricks instead of
//     the conversion unit, which issues at a fraction of the float rate.
//     What remains is mostly the 12 byte gathers per pixel, each with its
//     own 64-bit address.  Staging each tile's source window in shared
//     memory (cp.async) was measured slower than gathering the taps through
//     L1, and is not done;
//   * K1 evaluates the 2x2-tap map up-sample on the fly from per-axis tap
//     tables (Ho + Wo entries, 32 KB at 720p, read from L2; the bound above
//     leaves them out), its row pass staged per output row in shared
//     memory, so no full-resolution map exists;
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

// The color warp's output tile: one warp per output row, kPix horizontally
// adjacent pixels per thread (kTileW = 32 * kPix columns), kTileH rows.
constexpr int kPix = 4;
constexpr int kTileW = 32 * kPix;
constexpr int kTileH = kThreads / 32;

// A byte as float, exactly, without the quarter-rate conversion unit:
// 2^23 + u as float bits, minus 2^23.
__device__ __forceinline__ float u8_to_float(uint8_t u) {
  return __fsub_rn(__int_as_float(0x4b000000 | u), 8388608.0f);
}

// rint(s) clipped to [0, 255], as a byte.  Clipping to integer bounds
// commutes with rounding, and adding 1.5 * 2^23 rounds t in [0, 255] to an
// integer half to even (one ulp is 1 there), leaving it in the low bits.
__device__ __forceinline__ uint32_t round_clip_u8(float s) {
  const float t = fminf(fmaxf(s, 0.0f), 255.0f);
  return (uint32_t)__float_as_int(__fadd_rn(t, 12582912.0f)) & 0xffu;
}

// Strict sample of C uint8 planes (pl[c], rows W bytes long) at pixel
// coordinates (x, y); rounded half to even and clipped.
template <int C>
__device__ __forceinline__ void sample_u8(const uint8_t* const* pl, int H, int W,
                                          float x, float y, uint32_t* v) {
  const stabnet::Corners k = stabnet::clamped_corners(x, y, H, W, true);
  const float wa = __fmul_rn(k.ax, k.ay);
  const float wb = __fmul_rn(k.ax, k.by);
  const float wc = __fmul_rn(k.bx, k.ay);
  const float wd = __fmul_rn(k.bx, k.by);
  // 32-bit offsets within one plane.
  const unsigned ra = k.y0 * W, rb = k.y1 * W;
  const unsigned oa = ra + k.x0, ob = rb + k.x0, oc = ra + k.x1, od = rb + k.x1;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float s = __fmul_rn(wa, u8_to_float(__ldg(pl[c] + oa)));
    s = __fadd_rn(s, __fmul_rn(wb, u8_to_float(__ldg(pl[c] + ob))));
    s = __fadd_rn(s, __fmul_rn(wc, u8_to_float(__ldg(pl[c] + oc))));
    s = __fadd_rn(s, __fmul_rn(wd, u8_to_float(__ldg(pl[c] + od))));
    v[c] = round_clip_u8(s);
  }
}

// K1's map up-sample runs rows first: a warp owns one output row, and where
// the low-res columns its tile reads number at most kLowCols, the warp first
// stages the row pass of both maps over those columns in shared memory.  A
// pixel then reads two staged values per map and does one column pass,
// instead of four low-res values and both passes.  The same products and
// sums in the same order, so staged or not, the bits are the same.
constexpr int kLowCols = 64;

// K1 (LOWRES) and K3: imc (B, C, H, W) u8 -> out (B, Ho, Wo, C) u8.  K1
// reads low-res maps (B, h, w) f32 NDC and up-samples them from the per-axis
// tap tables (row: Ho entries, col: Wo entries); K3 reads full-resolution
// maps (B, Ho, Wo) and no tables.  One block per kTileH x kTileW output tile
// of image blockIdx.z, so no thread divides by a runtime size; the taps are
// gathered from the frame through L1.  Offsets within one image are 32-bit
// (the wrapper checks that they fit).
template <int C, bool LOWRES>
__global__ void __launch_bounds__(kThreads)
warp_uint8_kernel(const uint8_t* __restrict__ imc,
                  const float* __restrict__ xm, const float* __restrict__ ym,
                  const int* __restrict__ row_lo, const int* __restrict__ row_hi,
                  const float* __restrict__ row_wlo, const float* __restrict__ row_whi,
                  const int* __restrict__ col_lo, const int* __restrict__ col_hi,
                  const float* __restrict__ col_wlo, const float* __restrict__ col_whi,
                  uint8_t* __restrict__ out, int H, int W, int h, int w, int Ho, int Wo) {
  __shared__ float staged[kTileH][2][kLowCols];  // K1: per warp, x then y
  const int row = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.y * kTileH + row;
  const int t0 = blockIdx.x * kTileW;  // the tile's first column
  const int p0 = t0 + lane * kPix;
  const int b = blockIdx.z;
  if (o >= Ho) return;                 // the whole warp

  int rlo = 0, rhi = 0, c0 = 0;
  float rwl = 0.0f, rwh = 0.0f;
  bool fits = false;
  const size_t moff = LOWRES ? (size_t)b * h * w : (size_t)b * Ho * Wo + o * Wo;
  if (LOWRES) {
    rlo = row_lo[o], rhi = row_hi[o], rwl = row_wlo[o], rwh = row_whi[o];
    // The tap tables are monotone: the tile reads columns c0 .. c0 + nc - 1.
    c0 = col_lo[t0];
    const int nc = col_hi[min(t0 + kTileW, Wo) - 1] - c0 + 1;
    fits = nc <= kLowCols;
    if (fits) {
      const float* xr = xm + moff;
      const float* yr = ym + moff;
      for (int j = lane; j < nc; j += 32) {
        const int c = c0 + j;
        staged[row][0][j] = __fadd_rn(__fmul_rn(rwl, xr[rlo * w + c]),
                                      __fmul_rn(rwh, xr[rhi * w + c]));
        staged[row][1][j] = __fadd_rn(__fmul_rn(rwl, yr[rlo * w + c]),
                                      __fmul_rn(rwh, yr[rhi * w + c]));
      }
      __syncwarp();
    }
  }
  if (p0 >= Wo) return;
  const int n = min(kPix, Wo - p0);  // pixels of this thread inside the output

  const uint8_t* pl[C];                // the image's planes
#pragma unroll
  for (int c = 0; c < C; ++c) pl[c] = imc + ((size_t)b * C + c) * H * W;
  // Every thread computes kPix pixels, those past the right edge as copies
  // of the last one, and stores only its n: no branch per pixel.
  uint32_t v[kPix][C];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = min(p0 + k, Wo - 1);
    float xn, yn;
    if (LOWRES) {
      const int clo = col_lo[p], chi = col_hi[p];
      const float cwl = col_wlo[p], cwh = col_whi[p];
      if (fits) {
        const float* sx = staged[row][0];
        const float* sy = staged[row][1];
        xn = __fadd_rn(__fmul_rn(cwl, sx[clo - c0]), __fmul_rn(cwh, sx[chi - c0]));
        yn = __fadd_rn(__fmul_rn(cwl, sy[clo - c0]), __fmul_rn(cwh, sy[chi - c0]));
      } else {
        xn = upsample_tap(xm + moff, w, rlo, rhi, rwl, rwh, clo, chi, cwl, cwh);
        yn = upsample_tap(ym + moff, w, rlo, rhi, rwl, rwh, clo, chi, cwl, cwh);
      }
    } else {
      xn = xm[moff + p];
      yn = ym[moff + p];
    }
    sample_u8<C>(pl, H, W, ndc_to_pixel(xn, W), ndc_to_pixel(yn, H), v[k]);
  }
  uint8_t* dst = out + (size_t)b * Ho * Wo * C + (o * Wo + p0) * C;
  if (n == kPix && ((Wo * C) & 3) == 0) {
    // kPix * C bytes at a 4-byte aligned offset: C 32-bit stores.
#pragma unroll
    for (int j = 0; j < C; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * j + q;
        word |= v[e / C][e % C] << (8 * q);
      }
      reinterpret_cast<uint32_t*>(dst)[j] = word;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (k < n) {
#pragma unroll
        for (int c = 0; c < C; ++c) dst[k * C + c] = (uint8_t)v[k][c];
      }
    }
  }
}

template <bool LOWRES>
int launch_warp_uint8(const void* imc, const void* xm, const void* ym,
                      const void* const* taps, void* out, int B, int C, int H,
                      int W, int h, int w, int Ho, int Wo, void* stream) {
  if ((long long)B * Ho * Wo == 0) return 0;
  const dim3 grid((Wo + kTileW - 1) / kTileW, (Ho + kTileH - 1) / kTileH, B);
  const int* ti[4] = {nullptr, nullptr, nullptr, nullptr};
  const float* tf[4] = {nullptr, nullptr, nullptr, nullptr};
  if (LOWRES) {
    ti[0] = (const int*)taps[0], ti[1] = (const int*)taps[1];
    tf[0] = (const float*)taps[2], tf[1] = (const float*)taps[3];
    ti[2] = (const int*)taps[4], ti[3] = (const int*)taps[5];
    tf[2] = (const float*)taps[6], tf[3] = (const float*)taps[7];
  }
#define STABNET_WARP_U8(CH)                                                      \
  warp_uint8_kernel<CH, LOWRES><<<grid, kThreads, 0, (cudaStream_t)stream>>>(     \
      (const uint8_t*)imc, (const float*)xm, (const float*)ym, ti[0], ti[1],      \
      tf[0], tf[1], ti[2], ti[3], tf[2], tf[3], (uint8_t*)out, H, W, h, w, Ho, Wo)
  switch (C) {
    case 1: STABNET_WARP_U8(1); break;
    case 2: STABNET_WARP_U8(2); break;
    case 3: STABNET_WARP_U8(3); break;
    case 4: STABNET_WARP_U8(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef STABNET_WARP_U8
  return (int)cudaGetLastError();
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
  const void* taps[8] = {row_lo, row_hi, row_wlo, row_whi,
                         col_lo, col_hi, col_wlo, col_whi};
  return launch_warp_uint8<true>(imc, xlr, ylr, taps, out, B, C, H, W, h, w,
                                 Ho, Wo, stream);
}

extern "C" int stabnet_warp_uint8_cf(const void* imc, const void* xm,
                                     const void* ym, void* out, int B, int C,
                                     int H, int W, int Ho, int Wo, void* stream) {
  return launch_warp_uint8<false>(imc, xm, ym, nullptr, out, B, C, H, W, 0, 0,
                                  Ho, Wo, stream);
}
