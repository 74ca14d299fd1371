// Warp kernels of the serving and training paths, for Hopper (sm_90a).
//
// K2  stabnet_bilinear_sample_f32 (map mode)
//     Replaces the JAX package's `bilinear_sample_pallas`
//     (stabnet_tpu/ops/pallas_warp.py:469, body `_warp_band_kernel` 94-254):
//     the f32 bilinear sampler with the reference semantics of
//     stabnet_tpu/ops/warp.py:114-163, at given (B, Ho, Wo) NDC maps, both
//     `strict_edge` modes.  On the training path: the forwards of K5
//     (10, 288, 512, 2) and K6 (20, 288, 512, 1), once each per step.
//
// K2m stabnet_warp_mesh_f32 (mesh mode)
//     Replaces the same sampler together with the dense maps and the black
//     mask that feed it (stabnet_tpu/ops/warp.py:70-111, `dense_maps` and
//     `black_mask`): the serving warp of the current frame at model scale,
//     (S, 288, 512, 1), `refine` times per frame: S=1 online, S=6 in the
//     bench's batch, S=10 in the debug forward.  Each pixel's map value
//     needs only its cell's 3x3 homography and its own grid coordinate, so
//     the maps are computed in registers (on the TPU, Mosaic's in-kernel
//     reshape rule kept them out of the kernel).  One launch writes the
//     warped frame, the mask and both maps, which the color warp and the
//     caller read; the frame is read in place from the 13-channel input
//     stack at its own strides.
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
// compute ridge.  K2 at (20, 288, 512, 1) must move 35.4 MB (two f32 maps,
// output, image); K2m at S=1 2.96 MB (frame, output, mask, two maps, the
// homographies and the grid tables); K1 at S=1, 720p 5.60 MB (low-res maps
// 73,728 B, frame read 2,764,800 B, frame write 2,764,800 B): 10.6 us,
// 0.9 us and 1.7 us at 3.35 TB/s.  At these sizes the launch itself is of
// the same order, so the design keeps one launch per call and no
// intermediate in device memory.  K1, K2 and K3 share one layout: a block
// owns 8 output rows of image blockIdx.z, a warp one row of 128 pixels, 4
// per thread, so no thread divides by a runtime size and offsets within an
// image are 32-bit (the wrappers check that they fit).  K2m takes that
// layout or one pixel per thread, by the size of its grid:
//   * K2 was bound by the instructions it issued: one thread per pixel with
//     a 64-bit division, 64-bit tap offsets and a loop over the channels
//     with stride-C stores.  Now the channels are a template argument (1 to
//     4, and one instantiation that reads C at run time), the maps are
//     read and the 4 * C output floats written as 16-byte accesses where
//     aligned;
//   * K2m reads each pixel's grid coordinate and cell from per-axis tables
//     (W + H entries each) and its cell's homography through L1, and writes
//     its four planes: nothing of the unfused chain (a (S, H, W, 3) product,
//     the sign guard and divides, the mask's compares, a copy of the frame)
//     reaches device memory, and 19 launches per refine pass become one.
//     At S=1 (576 blocks, under one wave) the launch and each pixel's chain
//     of dependent loads bound it: the tables, then its cell's homography,
//     then the frame's four taps.  An empty kernel at its grid takes about
//     1.4-1.6 us of its ~3.0 (PERF.md, the K2m rows), and one pixel per
//     thread in 8-row blocks (its first layout) keeps the most warps to hide
//     the loads.  From S=4 up (more than two waves) bytes bound it: four
//     pixels per thread in 4-row blocks (a smaller last wave than 8 rows),
//     the tables read and the four planes written as 16-byte accesses, and
//     each cell's homography and its products with gy loaded once per
//     thread; at S=6 its time less the empty kernel's at its grid is within
//     a tenth of the byte bound.  A strided frame (the channels-last stack
//     of a refine pass and the debug forward, pixels 52 bytes apart) puts
//     each tap in its own 32-byte sector, so its gathers bound it and it
//     keeps one pixel per thread.  Tried, slower at every shape, and
//     dropped (PERF.md, the K2m rows): each warp staging its image's
//     homographies in shared memory beside the table loads (the L1 loads
//     it replaced hit after an SM's first warp, so it only added a copy),
//     two pixels per thread, and a register cap for more resident blocks;
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
// Numerics: every product, sum and quotient is rounded separately
// (__fmul_rn / __fadd_rn / __fdiv_rn, no FMA contraction), in the order of
// the plain PyTorch versions in stabnet_tpu_torch/ops/cuda_warp.py, so kernel
// and plain version agree
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

using stabnet::kThreads;
using stabnet::ndc_to_pixel;

namespace {

// The output tile of K1, K2 and K3: one warp per output row, kPix
// horizontally adjacent pixels per thread (kTileW = 32 * kPix columns),
// kTileH rows; one grid layer (blockIdx.z) per image.  K2m: 1 or 4 pixels
// per thread (mesh_rows below).
constexpr int kPix = 4;
constexpr int kTileW = 32 * kPix;
constexpr int kTileH = kThreads / 32;

// kPix consecutive floats of a row at element p0 into v, those past the
// row's end (at n and beyond) as copies of the last one: one 16-byte load
// where `vec` says the kPix values lie aligned inside the row.
__device__ __forceinline__ void load_row4(const float* __restrict__ row, int p0, int n,
                                          bool vec, float* v) {
  static_assert(kPix == 4, "16-byte row loads");
  if (vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + p0));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) v[k] = __ldg(row + p0 + min(k, n - 1));
  }
}

// K2: im (B, H, W, C) f32, maps (B, Ho, Wo) f32 NDC -> out (B, Ho, Wo, C).
// C is a template argument for 1 to 4 channels; CT = 0 reads it at run time
// (any C).  `vec`: both maps are 16-byte aligned and Wo % 4 == 0, so every
// thread's 4 map values are one aligned load each.  Offsets within one image
// are 32-bit (the wrapper checks that they fit).
template <int CT, bool STRICT>
__global__ void __launch_bounds__(kThreads)
bilinear_sample_kernel(const float* __restrict__ im, const float* __restrict__ xm,
                       const float* __restrict__ ym, float* __restrict__ out,
                       int H, int W, int c_rt, int Ho, int Wo, int vec) {
  const int C = CT > 0 ? CT : c_rt;
  const int o = blockIdx.y * kTileH + (threadIdx.x >> 5);
  const int p0 = blockIdx.x * kTileW + (threadIdx.x & 31) * kPix;
  const int b = blockIdx.z;
  if (o >= Ho || p0 >= Wo) return;
  const int n = min(kPix, Wo - p0);   // pixels of this thread inside the output
  const size_t mrow = ((size_t)b * Ho + o) * Wo;
  float xn[kPix], yn[kPix];
  load_row4(xm + mrow, p0, n, vec, xn);
  load_row4(ym + mrow, p0, n, vec, yn);
  const float* img = im + (size_t)b * H * W * C;
  float* dst = out + (mrow + p0) * C;
  const unsigned sx = C, sy = (unsigned)W * C;

  if constexpr (CT > 0) {
    // Every thread computes kPix pixels, those past the right edge as
    // copies of the last one, and stores only its n.
    float v[kPix][CT];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const stabnet::Taps32 t = stabnet::clamped_taps32(
          ndc_to_pixel(xn[k], W), ndc_to_pixel(yn[k], H), H, W, sx, sy, STRICT);
      const stabnet::Weights w = stabnet::tap_weights(t);
#pragma unroll
      for (int c = 0; c < CT; ++c) v[k][c] = stabnet::sample_taps32(img + c, t, w);
    }
    if (n == kPix && ((Wo * CT) & 3) == 0) {
      // kPix * C floats at a 16-byte aligned offset: C 16-byte stores.
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int e = 4 * j;
        reinterpret_cast<float4*>(dst)[j] = make_float4(
            v[e / CT][e % CT], v[(e + 1) / CT][(e + 1) % CT],
            v[(e + 2) / CT][(e + 2) % CT], v[(e + 3) / CT][(e + 3) % CT]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (k < n) {
#pragma unroll
          for (int c = 0; c < CT; ++c) dst[k * CT + c] = v[k][c];
        }
      }
    }
  } else {
    for (int k = 0; k < n; ++k) {
      const stabnet::Taps32 t = stabnet::clamped_taps32(
          ndc_to_pixel(xn[k], W), ndc_to_pixel(yn[k], H), H, W, sx, sy, STRICT);
      const stabnet::Weights w = stabnet::tap_weights(t);
      for (int c = 0; c < C; ++c) dst[k * C + c] = stabnet::sample_taps32(img + c, t, w);
    }
  }
}

// The vector type of four 4-byte elements T (float or int).
template <typename T> struct VecOf;
template <> struct VecOf<float> { using type = float4; };
template <> struct VecOf<int> { using type = int4; };

// PIX consecutive elements of a row at element p0 into v, those past the
// row's end (at n and beyond) as copies of the last one: one 4 * PIX byte
// load where `vec` says they lie aligned inside the row.
template <int PIX, typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ row, int p0, int n,
                                         bool vec, T* v) {
  static_assert(PIX == 1 || PIX == 4, "runs of 1 or 4");
  if constexpr (PIX == 1) {
    v[0] = __ldg(row + p0);
  } else if (vec) {
    const auto q = __ldg(reinterpret_cast<const typename VecOf<T>::type*>(row + p0));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < PIX; ++k) v[k] = __ldg(row + p0 + min(k, n - 1));
  }
}

// PIX floats of a row at element p0: one 4 * PIX byte store where `vec`
// says they lie aligned inside the row, else the first n of them.
template <int PIX>
__device__ __forceinline__ void store_run(float* __restrict__ row, int p0, int n, bool vec,
                                          const float* v) {
  if constexpr (PIX == 1) {
    row[p0] = v[0];
  } else if (vec) {
    *reinterpret_cast<float4*>(row + p0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < PIX; ++k)
      if (k < n) row[p0 + k] = v[k];
  }
}

// K2m's rows per block at PIX pixels per thread: 8 rows of one pixel per
// thread (its first layout), 4 of four, which leave a smaller tail of blocks
// than 8 (PERF.md, the K2m layouts).
__host__ __device__ constexpr int mesh_rows(int pix) { return pix == 1 ? 8 : 4; }

// K2m: the serving warp of the current frame in one pass.  hs (B, gh, gw,
// 3, 3) f32 per-cell homographies; im the (B, H, W, 1) f32 frame at element
// strides (sb, sr, sc), read in place; the NDC grid's axes gx (W) and gy (H)
// and each column's and row's mesh cell, cell_c (W) and cell_r (H).  Writes
// out (the strict sample), black, x and y, each (B, H, W).  Per pixel, with
// the pixel's cell homography h: X = (h00 gx + h01 gy) + h02 (likewise Y, Z),
// z = Z +/- 1e-8 by Z's sign, x = X / z, y = Y / z, black where (x, y)
// leaves [-1, 1]^2, then K2's strict sample at (x, y).
//
// A warp owns 32 * PIX columns of one row, a thread PIX adjacent pixels, a
// block mesh_rows(PIX) rows; the wrapper picks PIX (csrc header, K2m).  The
// homographies are read through L1: a thread loads its cell's nine values
// and their three products with gy once for all of its pixels in that
// cell.  `vec`: W % PIX == 0 and the tables and planes are aligned, so runs
// of PIX are single loads and stores.
template <int PIX>
__global__ void __launch_bounds__(32 * mesh_rows(PIX))
warp_mesh_kernel(const float* __restrict__ hs, const float* __restrict__ im,
                 long long sb, int sr, int sc,
                 const float* __restrict__ gx_t, const float* __restrict__ gy_t,
                 const int* __restrict__ cell_c, const int* __restrict__ cell_r,
                 float* __restrict__ out, float* __restrict__ black,
                 float* __restrict__ xo, float* __restrict__ yo,
                 int H, int W, int ncells, int grid_w, int vec) {
  const int o = blockIdx.y * mesh_rows(PIX) + (threadIdx.x >> 5);
  const int p0 = blockIdx.x * (32 * PIX) + (threadIdx.x & 31) * PIX;
  const int b = blockIdx.z;
  if (o >= H || p0 >= W) return;
  const int n = min(PIX, W - p0);            // pixels of this thread inside the row
  const bool run = vec && n == PIX;
  const float gy = __ldg(gy_t + o);
  const int cr = __ldg(cell_r + o) * grid_w;
  float gx[PIX];
  int cc[PIX];
  load_run<PIX>(gx_t, p0, n, run, gx);
  load_run<PIX>(cell_c, p0, n, run, cc);
  const float* hb = hs + (size_t)b * ncells * 9;
  const float* img = im + b * sb;
  float v_out[PIX], v_black[PIX], v_x[PIX], v_y[PIX];
  float hh[9], hy[3];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    if (k == 0 || cc[k] != cc[k - 1]) {      // a new cell: its homography
      const float* h = hb + (cr + cc[k]) * 9;
#pragma unroll
      for (int i = 0; i < 9; ++i) hh[i] = __ldg(h + i);
#pragma unroll
      for (int r = 0; r < 3; ++r) hy[r] = __fmul_rn(hh[3 * r + 1], gy);
    }
    const float X = __fadd_rn(__fadd_rn(__fmul_rn(hh[0], gx[k]), hy[0]), hh[2]);
    const float Y = __fadd_rn(__fadd_rn(__fmul_rn(hh[3], gx[k]), hy[1]), hh[5]);
    const float Z = __fadd_rn(__fadd_rn(__fmul_rn(hh[6], gx[k]), hy[2]), hh[8]);
    const float z = __fadd_rn(Z, Z >= 0.0f ? 1e-8f : -1e-8f);
    const float x = __fdiv_rn(X, z);
    const float y = __fdiv_rn(Y, z);
    const stabnet::Taps32 t = stabnet::clamped_taps32(
        ndc_to_pixel(x, W), ndc_to_pixel(y, H), H, W, (unsigned)sc, (unsigned)sr, true);
    v_out[k] = stabnet::sample_taps32(img, t, stabnet::tap_weights(t));
    v_black[k] = (x < -1.0f || x > 1.0f || y < -1.0f || y > 1.0f) ? 1.0f : 0.0f;
    v_x[k] = x;
    v_y[k] = y;
  }
  const size_t e = ((size_t)b * H + o) * W;
  store_run<PIX>(out + e, p0, n, run, v_out);
  store_run<PIX>(black + e, p0, n, run, v_black);
  store_run<PIX>(xo + e, p0, n, run, v_x);
  store_run<PIX>(yo + e, p0, n, run, v_y);
}

// K2m's grid: one block per mesh_rows(pix) rows and 32 * pix columns of an
// image.
dim3 mesh_grid(int B, int H, int W, int pix) {
  const int rows = mesh_rows(pix);
  return dim3((W + 32 * pix - 1) / (32 * pix), (H + rows - 1) / rows, B);
}

// An empty kernel, launched at K2m's grid: what any launch of that size
// costs on the card, the floor under K2m's time at S=1.
__global__ void empty_kernel() {}

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

namespace {

template <bool STRICT>
void launch_bilinear_sample(const float* im, const float* xm, const float* ym,
                            float* out, int B, int H, int W, int C, int Ho, int Wo,
                            cudaStream_t s) {
  const dim3 grid((Wo + kTileW - 1) / kTileW, (Ho + kTileH - 1) / kTileH, B);
  const int vec = (Wo & 3) == 0 && (((uintptr_t)xm | (uintptr_t)ym) & 15) == 0;
#define STABNET_SAMPLE(CH) \
  bilinear_sample_kernel<CH, STRICT><<<grid, kThreads, 0, s>>>(im, xm, ym, out, H, W, C, Ho, Wo, vec)
  switch (C) {
    case 1: STABNET_SAMPLE(1); break;
    case 2: STABNET_SAMPLE(2); break;
    case 3: STABNET_SAMPLE(3); break;
    case 4: STABNET_SAMPLE(4); break;
    default: STABNET_SAMPLE(0); break;
  }
#undef STABNET_SAMPLE
}

}  // namespace

extern "C" int stabnet_bilinear_sample_f32(const void* im, const void* xm,
                                           const void* ym, void* out,
                                           int B, int H, int W, int C,
                                           int Ho, int Wo, int strict_edge,
                                           void* stream) {
  if ((long long)B * Ho * Wo * C == 0) return 0;
  auto launch = strict_edge ? &launch_bilinear_sample<true> : &launch_bilinear_sample<false>;
  launch((const float*)im, (const float*)xm, (const float*)ym, (float*)out, B, H, W, C,
         Ho, Wo, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K2m with `pix` pixels per thread, 1 or 4: the wrapper's choice
// (ops/cuda_warp.py, `warp_mesh_pix`).
extern "C" int stabnet_warp_mesh_f32(const void* hs, const void* im, long long sb,
                                     int sr, int sc, const void* gx, const void* gy,
                                     const void* cell_c, const void* cell_r,
                                     void* out, void* black, void* xo, void* yo,
                                     int B, int H, int W, int grid_h, int grid_w,
                                     int pix, void* stream) {
  if (pix != 1 && pix != 4) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  const uintptr_t ptrs = (uintptr_t)gx | (uintptr_t)cell_c | (uintptr_t)out |
                         (uintptr_t)black | (uintptr_t)xo | (uintptr_t)yo;
  const int vec = W % pix == 0 && ptrs % (4 * pix) == 0;
  const dim3 grid = mesh_grid(B, H, W, pix);
#define STABNET_MESH(P)                                                               \
  warp_mesh_kernel<P><<<grid, 32 * mesh_rows(P), 0, (cudaStream_t)stream>>>(          \
      (const float*)hs, (const float*)im, sb, sr, sc, (const float*)gx,               \
      (const float*)gy, (const int*)cell_c, (const int*)cell_r, (float*)out,          \
      (float*)black, (float*)xo, (float*)yo, H, W, grid_h * grid_w, grid_w, vec)
  if (pix == 1) {
    STABNET_MESH(1);
  } else {
    STABNET_MESH(4);
  }
#undef STABNET_MESH
  return (int)cudaGetLastError();
}

// The empty kernel at K2m's grid for (B, H, W) frames at `pix` pixels per
// thread: the launch floor that chip_smoke times beside K2m.
extern "C" int stabnet_empty_launch(int B, int H, int W, int pix, void* stream) {
  if (pix != 1 && pix != 4) return (int)cudaErrorInvalidValue;
  empty_kernel<<<mesh_grid(B, H, W, pix), 32 * mesh_rows(pix), 0, (cudaStream_t)stream>>>();
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
