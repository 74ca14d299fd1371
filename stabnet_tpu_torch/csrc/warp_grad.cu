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
//      bits of the non-negative float, one per block; a NaN wins), and the
//      zero-fill of the int64 accumulator in the same launch;
//   2. each contribution w * g (rounded once in fp32, as the plain version
//      does) times 2^s, rounded half to even to an int64 and added, where
//      s = 62 - ceil(log2(4 Ho Wo)) - e and 2^e bounds the largest
//      contribution: no sum of the at most 4 Ho Wo contributions to one
//      element can overflow, and each is quantised to 2^-s, below 2^-40 of
//      the largest contribution;
//   3. each sum times 2^-s to fp32 (NaN everywhere if the maximum was not
//      finite).
// The result is the exactly rounded-to-quantum sum, the same on every run
// and bit for bit the plain version's, which does the same arithmetic with
// `index_add_` on int64.  Samples outside the frame have large weights
// whose contributions to the clamped edge tap cancel pairwise (wa = -wc
// there); in fixed point they cancel exactly.
//
// What held the first three-pass design back was atomics, not bytes: one
// global 64-bit atomic per contribution (8 per output pixel at C = 2), and
// a same-address atomicMax per warp in pass 1.  Pass 2 therefore runs one
// block per 32 x 32 output tile and sums the tile's contributions in a
// shared-memory window over the bounding box of its taps, then adds each
// non-zero window element to the accumulator with one global atomic: about
// 1.1 global atomics per touched image element for the near-identity flow
// maps of the temporal loss.  The card has no native 64-bit shared-memory
// atomic add (it loops on compare-and-swap), so a window element is two
// 32-bit words with a carry (shared_add64).  A tile whose window does not
// fit (adversarial maps, large flows) adds every contribution globally, as
// before; integer sums are exact, so the branch changes no bit.
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

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"

using stabnet::blocks_for;
using stabnet::kThreads;
using stabnet::ndc_to_pixel;

namespace {

constexpr int kFloatInf = 0x7f800000;  // bits of +inf; larger bits are NaN

// Pass 1: the bits of max |w * g| over every contribution, into *max_bits
// (zero-filled by the caller; bits of a non-negative float order as ints):
// grid-stride over the pixels, reduced over the block, one atomic per block.
// Also the zero-fill of the n_acc-element int64 accumulator, grid-stride in
// 16-byte stores.
__global__ void __launch_bounds__(kThreads)
splat_max_kernel(const float* __restrict__ g, const float* __restrict__ xm,
                 const float* __restrict__ ym, int* __restrict__ max_bits,
                 long long* __restrict__ acc, long long n_acc,
                 int H, int W, int C, long long total) {
  __shared__ int warp_max[kThreads / 32];
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = i0; j < n_acc / 2; j += stride) {
    reinterpret_cast<longlong2*>(acc)[j] = make_longlong2(0, 0);
  }
  if (i0 == 0 && (n_acc & 1)) acc[n_acc - 1] = 0;
  int m = 0;
  for (long long i = i0; i < total; i += stride) {
    const float x = ndc_to_pixel(xm[i], W);
    const float y = ndc_to_pixel(ym[i], H);
    const stabnet::Corners t = stabnet::clamped_corners(x, y, H, W, true);
    const float w[4] = {__fmul_rn(t.ax, t.ay), __fmul_rn(t.ax, t.by),
                        __fmul_rn(t.bx, t.ay), __fmul_rn(t.bx, t.by)};
    for (int c = 0; c < C; ++c) {
      const float v = g[i * C + c];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m = max(m, __float_as_int(fabsf(__fmul_rn(w[k], v))));
      }
    }
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0;
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x == 0 && m > 0) atomicMax(max_bits, m);
  }
}

// The fixed-point exponent s of the largest contribution's bits.
__device__ __forceinline__ int quantum_exponent(int max_bits, int head) {
  int e;
  frexpf(__int_as_float(max_bits), &e);
  return head - e;
}

// Pass 1's grid: enough blocks to fill the card, few enough atomics.
constexpr int kMaxBlocks = 1024;
// Pass 2's output tile: kSplatTile x kSplatTile pixels; a warp's lanes own
// adjacent columns (so their shared-memory atomics fall in distinct banks),
// each thread kPix rows, kThreads / 32 rows apart.  The shared-memory window
// budget is in int64 elements (32 KB: a 45 x 45 pixel window at C = 2).
constexpr int kSplatTile = 32;
constexpr int kPix = kSplatTile * kSplatTile / kThreads;
constexpr int kSplatWin = 4096;

// Block-wide min of a and b, max of c and d (one value per thread each), for
// a block of kThreads threads; `red` is 4 ints of shared memory that the
// caller has set to (INT_MAX, INT_MAX, INT_MIN, INT_MIN) before a
// __syncthreads().  Every thread reads the result after the trailing sync.
__device__ __forceinline__ void block_bounds(int a, int b, int c, int d, int* red) {
  a = __reduce_min_sync(0xffffffffu, a);
  b = __reduce_min_sync(0xffffffffu, b);
  c = __reduce_max_sync(0xffffffffu, c);
  d = __reduce_max_sync(0xffffffffu, d);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(red + 0, a);
    atomicMin(red + 1, b);
    atomicMax(red + 2, c);
    atomicMax(red + 3, d);
  }
  __syncthreads();
}

// Adds q to the 64-bit integer (*hi, *lo) of shared memory with two 32-bit
// atomics, which the card does natively there: the low words wrap, and each
// wrap, read from the old value, carries one into the high word.  The total
// of the wraps is the same in any order, so the sum is exact.
__device__ __forceinline__ void shared_add64(unsigned* lo, unsigned* hi,
                                             unsigned long long q) {
  const unsigned ql = (unsigned)q;
  const unsigned old = atomicAdd(lo, ql);
  const unsigned qh = (unsigned)(q >> 32) + (old + ql < old ? 1u : 0u);
  if (qh != 0u) atomicAdd(hi, qh);
}

// Pass 2: scatter round(w * g * 2^s) into the int64 accumulator
// (B, H, W, C), zero-filled by pass 1.  One block per output tile of image
// blockIdx.z.  The block finds the bounding box of its pixels' clamped taps;
// where that window fits kSplatWin, the block sums its contributions there
// with shared-memory atomics and then adds each non-zero window element to
// the accumulator with one global atomic; otherwise every contribution is a
// global atomic.  Integer sums are exact, so the branch changes no bit.  A
// thread issues all its loads (maps and cotangent) before the block's first
// barrier, so the block waits on device memory once.
template <int C>
__global__ void __launch_bounds__(kThreads)
splat_scatter_kernel(const float* __restrict__ g, const float* __restrict__ xm,
                     const float* __restrict__ ym, const int* __restrict__ max_bits,
                     unsigned long long* __restrict__ acc,
                     int H, int W, int Ho, int Wo, int head) {
  __shared__ unsigned win_lo[kSplatWin], win_hi[kSplatWin];
  __shared__ int red[4];
  const int mb = *max_bits;
  if (mb >= kFloatInf) return;           // non-finite: pass 3 writes NaN
  const double scale = ldexp(1.0, quantum_exponent(mb, head));
  const int p = blockIdx.x * kSplatTile + (threadIdx.x & 31);
  const int o0 = blockIdx.y * kSplatTile + (threadIdx.x >> 5);
  const int b = blockIdx.z;
  if (threadIdx.x == 0) {
    red[0] = red[1] = INT_MAX;
    red[2] = red[3] = INT_MIN;
  }
  constexpr int kRowStep = kThreads / 32;
  // Rows o0 + k * kRowStep for k < n are inside the output.
  const int n = p < Wo ? min(kPix, (Ho - o0 + kRowStep - 1) / kRowStep) : 0;
  const size_t pix0 = (size_t)b * Ho * Wo + (size_t)o0 * Wo + p;
  float xs[kPix], ys[kPix], gv[kPix][C];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (k < n) {
      const size_t i = pix0 + (size_t)k * kRowStep * Wo;
      xs[k] = xm[i];
      ys[k] = ym[i];
#pragma unroll
      for (int c = 0; c < C; ++c) gv[k][c] = g[i * C + c];
    }
  }
  int bx0 = INT_MAX, by0 = INT_MAX, bx1 = INT_MIN, by1 = INT_MIN;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (k < n) {
      xs[k] = ndc_to_pixel(xs[k], W);
      ys[k] = ndc_to_pixel(ys[k], H);
      const stabnet::Corners t = stabnet::clamped_corners(xs[k], ys[k], H, W, true);
      bx0 = min(bx0, t.x0);
      by0 = min(by0, t.y0);
      bx1 = max(bx1, t.x1);
      by1 = max(by1, t.y1);
    }
  }
  __syncthreads();
  block_bounds(bx0, by0, bx1, by1, red);
  const int wx0 = red[0], wy0 = red[1];
  const int row = (red[2] - wx0 + 1) * C;          // elements per window row
  const int wh = red[3] - wy0 + 1;
  const bool fits = (long long)row * wh <= kSplatWin;
  if (fits) {
    for (int e = threadIdx.x; e < row * wh; e += kThreads) win_lo[e] = win_hi[e] = 0u;
  }
  __syncthreads();

  unsigned long long* img = acc + (size_t)b * H * W * C;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (k < n) {
      const stabnet::Corners t = stabnet::clamped_corners(xs[k], ys[k], H, W, true);
      const float w[4] = {__fmul_rn(t.ax, t.ay), __fmul_rn(t.ax, t.by),
                          __fmul_rn(t.bx, t.ay), __fmul_rn(t.bx, t.by)};
      int off[4];
      if (fits) {
        const int ra = (t.y0 - wy0) * row, rb = (t.y1 - wy0) * row;
        const int ca = (t.x0 - wx0) * C, cc = (t.x1 - wx0) * C;
        off[0] = ra + ca, off[1] = rb + ca, off[2] = ra + cc, off[3] = rb + cc;
      } else {
        const int ra = t.y0 * W, rb = t.y1 * W;
        off[0] = (ra + t.x0) * C, off[1] = (rb + t.x0) * C;
        off[2] = (ra + t.x1) * C, off[3] = (rb + t.x1) * C;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float v = gv[k][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long q = __double2ll_rn((double)__fmul_rn(w[j], v) * scale);
          if (q == 0) continue;
          if (fits) {
            shared_add64(win_lo + off[j] + c, win_hi + off[j] + c, (unsigned long long)q);
          } else {
            atomicAdd(img + off[j] + c, (unsigned long long)q);
          }
        }
      }
    }
  }
  if (!fits) return;
  __syncthreads();
  // Flush: window row r is `row` contiguous elements of the image's row wy0 + r.
  for (int r = threadIdx.x >> 5; r < wh; r += kThreads / 32) {
    unsigned long long* d = img + ((wy0 + r) * W + wx0) * C;
    for (int j = threadIdx.x & 31; j < row; j += 32) {
      const unsigned long long q =
          (unsigned long long)win_hi[r * row + j] << 32 | win_lo[r * row + j];
      if (q != 0ull) atomicAdd(d + j, q);
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

// K4.  acc: int64 (B, H, W, C), any contents (pass 1 zero-fills it);
// max_bits: int32 [1], zero-filled by the caller; out: f32 (B, H, W, C).
// head = 62 - ceil(log2(4 Ho Wo)).
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
  const unsigned int p1_blocks = blocks_for(total > 0 ? total : 1);
  splat_max_kernel<<<p1_blocks < kMaxBlocks ? p1_blocks : kMaxBlocks, kThreads, 0, s>>>(
      (const float*)g, (const float*)xm, (const float*)ym, (int*)max_bits,
      (long long*)acc, n_out, H, W, C, total);
  if (total > 0) {
    const dim3 grid((Wo + kSplatTile - 1) / kSplatTile,
                    (Ho + kSplatTile - 1) / kSplatTile, B);
#define STABNET_SPLAT(CH)                                                 \
  splat_scatter_kernel<CH><<<grid, kThreads, 0, s>>>(                     \
      (const float*)g, (const float*)xm, (const float*)ym,                \
      (const int*)max_bits, (unsigned long long*)acc, H, W, Ho, Wo, head)
    switch (C) {
      case 1: STABNET_SPLAT(1); break;
      case 2: STABNET_SPLAT(2); break;
      case 3: STABNET_SPLAT(3); break;
      case 4: STABNET_SPLAT(4); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef STABNET_SPLAT
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
