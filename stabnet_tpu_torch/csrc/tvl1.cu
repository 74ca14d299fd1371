// TV-L1's primal-dual iteration for Hopper (sm_90a).
//
// K7  stabnet_tvl1_iterate_f32 (one iteration a launch) and
//     stabnet_tvl1_iterate_n_f32 (a whole warp's n iterations a launch,
//     the image held on chip)
//     Replace no TPU kernel: the JAX package runs the iteration as XLA's
//     fusion of the loop body of `_tvl1_level` (stabnet_tpu/ops/flow.py).
//     In the port each iteration was some forty tensor operations
//     (`tvl1_iterate_plain`, ops/flow.py), each a kernel of its own: at the
//     coarse pyramid levels every one sat at the launch floor, at the fine
//     level every one moved a whole (B, 2, H, W) tensor through device
//     memory.  One launch now does the whole iteration: the data term's
//     thresholding, the primal step with the divergence of p, the forward
//     gradient of the new u and the dual step.
//
// What bounds it on this card: bytes at the fine levels, the instruction
// rate at the coarse ones.  Per pixel an iteration reads u (2 floats), p
// (4), rho_c, gx and gy and writes u and p: 60 B against some sixty float
// operations, far below the compute ridge; but the six correctly rounded
// quotients and two square roots are instruction sequences.  At the metrics' finest level,
// (32, 144, 256), the 60 B are 70.8 MB, 21.1 us at 3.35 TB/s, and one
// launch an iteration streams them.  At the coarse levels a launch is of
// the order of its data: there `tvl1_iterate_kernel_onchip` runs all n
// iterations of a warp in one launch, the image's u and p in shared memory
// and its data term in registers, so the state reaches device memory once
// a warp instead of n times, and the instruction rate bounds it.  Which
// levels go on chip, and over how many blocks, ops/flow.py's `onchip_rows`
// decides by shape alone.
//
// K7's layout: a block owns a tile of 8 rows x 32 columns of one image
// (blockIdx.z), a warp one tile row, one pixel a thread.  The dual step at
// a pixel needs the NEW u of its right and lower neighbours, so the block
// first computes the primal step on its tile and on a halo of one row below
// and one column to the right (recomputed from the inputs, never read back
// from another block's output; two more warps take it, so no warp takes two
// steps while the others wait) into shared memory, then the dual step on
// its tile.  The primal step reads p at the left and upper neighbours
// through the read-only cache.
//
// The on-chip layout: one image is a thread-block cluster of 1 to 3 blocks
// (blockIdx.y the image, blockIdx.x the block's rank in it), each owning a
// band of `rows` whole rows; a thread owns the band's pixels j = tid +
// m * blockDim.x, m < kSlots, and keeps their data term in registers.
// Shared memory holds the band's u and p, updated in place: the primal step
// writes u at its own pixel and reads p at its own, left and upper pixels;
// a barrier; the dual step writes p at its own pixel and reads u at its
// own, right and lower pixels; a barrier.  Across a band's edge the p of
// the row above and the new u of the row below are read from the
// neighbouring block's shared memory (distributed shared memory), after the
// cluster's barrier, whose release and acquire order those reads; the rest
// of the band is computed while the barrier completes.  On the card (us an
// iteration, 32 images): (72, 128) in 3 blocks 4.28, in 4 blocks 7.49 (the
// card does not hold 32 clusters of 4 at once); (32, 64) in 1 block 2.16,
// in 2 blocks 2.00; (16, 32) in 1 block 1.06, in 2 blocks 1.79: a
// cluster's barriers cost about 0.7 us an iteration, so an image takes
// the fewest blocks that hold it.
//
// Both kernels write fresh u and p buffers and never their inputs, so a
// captured CUDA graph takes their addresses from its pool like any other
// output.
//
// Arithmetic: every product, sum, quotient and square root is rounded
// separately (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn,
// no FMA contraction), in the order of `tvl1_iterate_plain`, and each of
// its Python numbers (lam * theta, theta, tau / theta, 1e-9) arrives
// rounded to float32 once, as PyTorch hands a scalar to a float32 kernel.
// So either kernel and the plain version agree bit for bit, which the data
// term's discontinuous thresholding needs: a one-ulp drift can flip a
// case.  The on-chip kernel's value functions (`data_term`, `primal_px`,
// `dual_px`) repeat K7's `primal` and dual step operation for operation,
// with selects where K7 branches, so one launch of n iterations equals n
// launches of K7.  The borders follow `_divergence` and `_grad_forward`:
// dx = px[0] at x = 0, px[x] - px[x-1] inside, -px[W-2] at x = W-1
// (likewise dy down the rows); the gradient 0 at the far border.
// clamp_min keeps a NaN, as PyTorch's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
// Threads a block: a warp per tile row, one for the row below the tile and
// one whose first kTileY lanes take the column right of it.
constexpr int kThreads = kTileX * (kTileY + 2);

// The on-chip kernel: at most this many threads a block and pixels a
// thread, so a block's band holds at most 3,072 pixels (ops/flow.py
// `ONCHIP_BLOCK_PX`), their u and p 24 B each in shared memory.
constexpr int kOnchipThreads = 1024;
constexpr int kOnchipSlots = 3;
constexpr int kOnchipFloats = 6;   // a pixel's u and p
constexpr int kOnchipSmemMax = 232448;   // all a block may have
// A thread keeps a pixel's index in the band in 16 bits.
static_assert(kOnchipThreads * kOnchipSlots <= 0xffff, "a band's index fits 16 bits");

struct Tvl1Consts {
  float l_t;     // lam * theta
  float theta;
  float sigma;   // tau / theta
  float eps;     // 1e-9
};

// One image's planes: u (2, H, W), p (2, 2, H, W) (component, direction),
// rho_c, gx, gy (H, W).
struct Tvl1Image {
  const float* __restrict__ u;
  const float* __restrict__ p;
  const float* __restrict__ rho_c;
  const float* __restrict__ gx;
  const float* __restrict__ gy;
};

// The primal step at (y, x): the new u of both components into `un`, and
// p's four values at the pixel into `pv` (x then y direction of each
// component).
__device__ __forceinline__ void primal(const Tvl1Image& im, int H, int W, int y, int x,
                                       const Tvl1Consts& k, float un[2], float pv[4]) {
  const int HW = H * W;
  const int i = y * W + x;
  const float gxv = __ldg(im.gx + i);
  const float gyv = __ldg(im.gy + i);
  const float uv[2] = {__ldg(im.u + i), __ldg(im.u + HW + i)};
  // grad_sq = gx * gx + gy * gy; rho = rho_c + gx * u0 + gy * u1.
  const float grad_sq = __fadd_rn(__fmul_rn(gxv, gxv), __fmul_rn(gyv, gyv));
  const float rho = __fadd_rn(__fadd_rn(__ldg(im.rho_c + i), __fmul_rn(gxv, uv[0])),
                              __fmul_rn(gyv, uv[1]));
  const bool lo = rho < __fmul_rn(-k.l_t, grad_sq);
  const bool hi = rho > __fmul_rn(k.l_t, grad_sq);
  const float den_sq = isnan(grad_sq) ? grad_sq : fmaxf(grad_sq, k.eps);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float g = c == 0 ? gxv : gyv;
    const float d = lo ? __fmul_rn(k.l_t, g)
                  : hi ? __fmul_rn(-k.l_t, g)
                       : __fdiv_rn(__fmul_rn(-rho, g), den_sq);
    const float v = __fadd_rn(uv[c], d);
    const float* px = im.p + 2 * c * HW;
    const float* py = px + HW;
    const float pxv = __ldg(px + i);
    const float pyv = __ldg(py + i);
    const float dx = x == 0 ? pxv
                   : x == W - 1 ? -__ldg(px + i - 1)
                                : __fsub_rn(pxv, __ldg(px + i - 1));
    const float dy = y == 0 ? pyv
                   : y == H - 1 ? -__ldg(py + i - W)
                                : __fsub_rn(pyv, __ldg(py + i - W));
    un[c] = __fadd_rn(v, __fmul_rn(k.theta, __fadd_rn(dx, dy)));
    pv[2 * c] = pxv;
    pv[2 * c + 1] = pyv;
  }
}

// Six blocks an SM, so at most 32 registers a thread: the kernel waits on
// its loads, and more warps in flight hide more of that.  On the card this
// layout took 37.1, 8.6, 4.2 and 3.5 us an iteration at the metrics' four
// levels; without the bound (44 registers) 40.3 us at the finest; with the
// halo taken by two of the tile's warps 37.5, 9.7, 4.8 and 3.8 us.
__global__ void __launch_bounds__(kThreads, 6)
tvl1_iterate_kernel(const float* __restrict__ u, const float* __restrict__ p,
                    const float* __restrict__ rho_c, const float* __restrict__ gx,
                    const float* __restrict__ gy, float* __restrict__ u_out,
                    float* __restrict__ p_out, int H, int W, Tvl1Consts k) {
  // The new u of the tile, its right column and its lower row.
  __shared__ float su[2][kTileY + 1][kTileX + 1];
  const int HW = H * W;
  const long long img = (long long)blockIdx.z * HW;
  const Tvl1Image im{u + 2 * img, p + 4 * img, rho_c + img, gx + img, gy + img};
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  // (ly, lx): the pixel whose primal step this thread takes, in the tile's
  // frame: its own for the tile's warps, else the halo's.
  const int ly = ty < kTileY ? ty : ty == kTileY ? kTileY : tx;
  const int lx = ty <= kTileY ? tx : kTileX;
  const int x = x0 + lx, y = y0 + ly;
  const bool active = ty <= kTileY || tx < kTileY;
  float un[2], pv[4];
  if (active && x < W && y < H) {
    primal(im, H, W, y, x, k, un, pv);
    su[0][ly][lx] = un[0];
    su[1][ly][lx] = un[1];
  }
  __syncthreads();
  if (ty >= kTileY || x >= W || y >= H) return;
  const int i = y * W + x;
  float* uo = u_out + 2 * img;
  float* po = p_out + 4 * img;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float uc = su[c][ty][tx];
    // Forward differences of the new u, 0 at the far border.
    const float gux = x < W - 1 ? __fsub_rn(su[c][ty][tx + 1], uc) : 0.0f;
    const float guy = y < H - 1 ? __fsub_rn(su[c][ty + 1][tx], uc) : 0.0f;
    // den = 1 + sigma * sqrt(gux * gux + guy * guy)
    const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(gux, gux), __fmul_rn(guy, guy)));
    const float den = __fadd_rn(__fmul_rn(k.sigma, mag), 1.0f);
    uo[c * HW + i] = uc;
    po[2 * c * HW + i] = __fdiv_rn(__fadd_rn(pv[2 * c], __fmul_rn(k.sigma, gux)), den);
    po[(2 * c + 1) * HW + i] = __fdiv_rn(__fadd_rn(pv[2 * c + 1], __fmul_rn(k.sigma, guy)),
                                         den);
  }
}

// a ? b : c without a branch: both values are computed anyway, and a
// branch would keep the compiler from interleaving independent pixels.
__device__ __forceinline__ float sel(bool a, float b, float c) {
  float r;
  asm("{.reg .pred q; setp.ne.b32 q, %3, 0; selp.f32 %0, %1, %2, q;}"
      : "=f"(r) : "f"(b), "f"(c), "r"((int)a));
  return r;
}

// The data term's factors at one pixel, fixed for a warp: rho_c, gx, gy,
// the threshold lam * theta * |grad|^2 (its negative is the lower one:
// rounding to nearest is symmetric, so (-a) * b rounds to -(a * b)), the
// divisor |grad|^2 clamped to eps, and lam * theta * g of each component
// (the step below the band; its negative, rounded alike, above it).
struct DataTerm {
  float rc, gx, gy, thr, den_sq, step[2];
};

__device__ __forceinline__ DataTerm data_term(float rcv, float gxv, float gyv,
                                              const Tvl1Consts& k) {
  const float grad_sq = __fadd_rn(__fmul_rn(gxv, gxv), __fmul_rn(gyv, gyv));
  return {rcv, gxv, gyv, __fmul_rn(k.l_t, grad_sq),
          isnan(grad_sq) ? grad_sq : fmaxf(grad_sq, k.eps),
          {__fmul_rn(k.l_t, gxv), __fmul_rn(k.l_t, gyv)}};
}

// The primal step at one pixel: its data term and u; p's four values there
// (x then y direction of each component), px of each component at the left
// neighbour and py at the upper one (ignored on the left and top edges);
// whether the pixel lies on the image's left, right, top and bottom edges.
// The new u of both components into `un`.
__device__ __forceinline__ void primal_px(const DataTerm& t, const float uv[2],
                                          const float pv[4], const float pl[2],
                                          const float pu[2], bool left, bool right, bool top,
                                          bool bottom, const Tvl1Consts& k, float un[2]) {
  // rho = rho_c + gx * u0 + gy * u1.
  const float rho = __fadd_rn(__fadd_rn(t.rc, __fmul_rn(t.gx, uv[0])), __fmul_rn(t.gy, uv[1]));
  const bool lo = rho < -t.thr;
  const bool hi = rho > t.thr;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float g = c == 0 ? t.gx : t.gy;
    const float d =
        sel(lo, t.step[c], sel(hi, -t.step[c], __fdiv_rn(__fmul_rn(-rho, g), t.den_sq)));
    const float v = __fadd_rn(uv[c], d);
    const float pxv = pv[2 * c], pyv = pv[2 * c + 1];
    const float dx = sel(left, pxv, sel(right, -pl[c], __fsub_rn(pxv, pl[c])));
    const float dy = sel(top, pyv, sel(bottom, -pu[c], __fsub_rn(pyv, pu[c])));
    un[c] = __fadd_rn(v, __fmul_rn(k.theta, __fadd_rn(dx, dy)));
  }
}

// The dual step of one component at one pixel: its new u `uc`, those of
// its right and lower neighbours (ignored where it has none) and its p (x
// then y direction) in; the new p out.
__device__ __forceinline__ void dual_px(float uc, float ur, float ud, bool has_right,
                                        bool has_below, float pxv, float pyv,
                                        const Tvl1Consts& k, float& px_out, float& py_out) {
  // Forward differences of the new u, 0 at the far border.
  const float gux = sel(has_right, __fsub_rn(ur, uc), 0.0f);
  const float guy = sel(has_below, __fsub_rn(ud, uc), 0.0f);
  // den = 1 + sigma * sqrt(gux * gux + guy * guy)
  const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(gux, gux), __fmul_rn(guy, guy)));
  const float den = __fadd_rn(__fmul_rn(k.sigma, mag), 1.0f);
  px_out = __fdiv_rn(__fadd_rn(pxv, __fmul_rn(k.sigma, gux)), den);
  py_out = __fdiv_rn(__fadd_rn(pyv, __fmul_rn(k.sigma, guy)), den);
}

// The cluster's barrier, split: every thread of the cluster arrives, then
// waits for all to have arrived.  A warp that arrives with `release` has
// its shared-memory reads and writes before the arrival ordered before
// whatever any block does after its wait (which acquires); the others
// arrive relaxed, which costs no fence (a fence at cluster scope is a
// device-wide memory barrier on this card).  Warp-uniform, so `.aligned`.
__device__ __forceinline__ void cluster_arrive(bool release) {
  if (release) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  } else {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// All n iterations of B images, each a cluster of gridDim.x blocks of
// `rows` rows (the last may hold fewer), on chip between the first read
// and the last write.  kSlots: pixels a thread.
template <int kSlots>
__global__ void __launch_bounds__(kOnchipThreads, 1)
tvl1_iterate_kernel_onchip(const float* __restrict__ u, const float* __restrict__ p,
                           const float* __restrict__ rho_c, const float* __restrict__ gx,
                           const float* __restrict__ gy, float* __restrict__ u_out,
                           float* __restrict__ p_out, int H, int W, int rows, int n,
                           Tvl1Consts k) {
  // A pixel's state in shared memory: u0 u1 px0 py0 px1 py1, 24 B, so one
  // address and three 8-byte accesses reach all of it.  The band's pixels
  // follow a row of padding and are followed by one: a neighbour's address
  // across the band's edge stays in the block's memory, and what is read
  // there is one of the border cases' ignored values.
  extern __shared__ float2 smem2[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = gridDim.x, rank = blockIdx.x;
  const int T = blockDim.x, tid = threadIdx.x;
  const int HW = H * W;
  const int band = rows * W;              // the band's pixels, all but the last block
  const int off = rank * band;            // the band's first pixel in the image
  const int npx = min(band, HW - off);    // this band's pixels
  const long long img = (long long)blockIdx.y * HW;
  float2* st = smem2 + 3 * W;             // pixel j's state at st[3 j .. 3 j + 2]
  // The neighbouring bands: the state of the band above's last row and of
  // the band below's first row (this block's own where there is none; then
  // never read).
  const bool above = rank > 0, below = rank + 1 < nblk;
  const float2* st_up = above ? cluster.map_shared_rank(st, rank - 1) + 3 * (band - W) : st;
  const float2* st_dn = below ? cluster.map_shared_rank(st, rank + 1) : st;

  // The thread's pixels: their index in the band in the low 16 bits (a
  // band holds at most kOnchipThreads * kOnchipSlots pixels), where they
  // lie in the bits above, and the warp's fixed data term; 0 past the
  // band's end.  kUp / kDown: the pixel's upper / lower neighbour lies in
  // the band above / below.
  enum { kIn = 1 << 16, kLeft = 2 << 16, kRight = 4 << 16, kTop = 8 << 16, kBottom = 16 << 16,
         kUp = 32 << 16, kDown = 64 << 16 };
  int at[kSlots];
  DataTerm dt[kSlots];
  bool up = false, down = false;
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int j = tid + m * T;
    at[m] = 0;
    if (j < npx) {
      const int x = j % W;
      at[m] = j | kIn | (x == 0 ? kLeft : 0) | (x == W - 1 ? kRight : 0) |
              (off + j < W ? kTop : 0) | (off + j >= HW - W ? kBottom : 0) |
              (above && j < W ? kUp : 0) | (below && j >= npx - W ? kDown : 0);
      up |= (at[m] & kUp) != 0;
      down |= (at[m] & kDown) != 0;
      const long long i = img + off + j;
      dt[m] = data_term(__ldg(rho_c + i), __ldg(gx + i), __ldg(gy + i), k);
      const float* ui = u + 2 * img + off + j;
      const float* pi = p + 4 * img + off + j;
      st[3 * j] = make_float2(__ldg(ui), __ldg(ui + HW));
      st[3 * j + 1] = make_float2(__ldg(pi), __ldg(pi + HW));
      st[3 * j + 2] = make_float2(__ldg(pi + 2 * HW), __ldg(pi + 3 * HW));
    }
  }
  // Warps whose pixels read or write what another block reads arrive with
  // release: the first row's (p of the band above in, new u out) at the
  // barrier after the primal step, the last row's (u of the band below in,
  // new p out) at the one after the dual step.
  const bool up_warp = __any_sync(0xffffffffu, up), down_warp = __any_sync(0xffffffffu, down);
  const bool cl = nblk > 1;
  __syncthreads();
  if (cl) cluster_arrive(true);

  // `remote`: the pixel's upper (primal) or lower (dual) neighbour lies in
  // another block's band (std::true_type) or in this one's.
  auto primal = [&](int m, auto remote) {
    const int a = at[m], j = a & 0xffff;
    float2* s = st + 3 * j;
    const float2 uu = s[0], p0 = s[1], p1 = s[2];
    // px of the left neighbour, py of the upper one, each component.
    const float* l = reinterpret_cast<const float*>(s - 3);
    const float* t = reinterpret_cast<const float*>(
        decltype(remote)::value ? st_up + 3 * j : s - 3 * W);
    const float uv[2] = {uu.x, uu.y}, pv[4] = {p0.x, p0.y, p1.x, p1.y};
    const float pl[2] = {l[2], l[4]}, pu[2] = {t[3], t[5]};
    float un[2];
    primal_px(dt[m], uv, pv, pl, pu, a & kLeft, a & kRight, a & kTop, a & kBottom, k, un);
    s[0] = make_float2(un[0], un[1]);
  };
  auto dual = [&](int m, auto remote) {
    const int a = at[m], j = a & 0xffff;
    float2* s = st + 3 * j;
    const float2 uu = s[0], ur = s[3], p0 = s[1], p1 = s[2];
    const float2 ud = decltype(remote)::value ? st_dn[3 * (j - (npx - W))] : s[3 * W];
    float2 q0, q1;
    dual_px(uu.x, ur.x, ud.x, !(a & kRight), !(a & kBottom), p0.x, p0.y, k, q0.x, q0.y);
    dual_px(uu.y, ur.y, ud.y, !(a & kRight), !(a & kBottom), p1.x, p1.y, k, q1.x, q1.y);
    s[1] = q0;
    s[2] = q1;
  };
  // An iteration: the primal step of the pixels that need nothing of
  // another block, the wait for the band above's p, the first row's primal
  // step; then the dual step likewise around the band below's new u.  The
  // barriers' latency hides behind the rest of the band.
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int m = 0; m < kSlots; ++m)
      if ((at[m] & kIn) && !(at[m] & kUp)) primal(m, std::false_type{});
    if (cl) {
      cluster_wait();
#pragma unroll
      for (int m = 0; m < kSlots; ++m)
        if (at[m] & kUp) primal(m, std::true_type{});
      cluster_arrive(up_warp);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kSlots; ++m)
      if ((at[m] & kIn) && !(at[m] & kDown)) dual(m, std::false_type{});
    if (cl) {
      cluster_wait();
#pragma unroll
      for (int m = 0; m < kSlots; ++m)
        if (at[m] & kDown) dual(m, std::true_type{});
      cluster_arrive(down_warp);
    }
    __syncthreads();
  }
  // No block leaves while another may still read its shared memory.
  if (cl) cluster_wait();

#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    if (!(at[m] & kIn)) continue;
    const int j = at[m] & 0xffff;
    const float2 uu = st[3 * j], p0 = st[3 * j + 1], p1 = st[3 * j + 2];
    float* uo = u_out + 2 * img + off + j;
    float* po = p_out + 4 * img + off + j;
    uo[0] = uu.x;
    uo[HW] = uu.y;
    po[0] = p0.x;
    po[HW] = p0.y;
    po[2 * HW] = p1.x;
    po[3 * HW] = p1.y;
  }
}

template <int kSlots>
cudaError_t launch_onchip(int threads, const float* u, const float* p, const float* rho_c,
                          const float* gx, const float* gy, float* u_out, float* p_out,
                          int B, int H, int W, int rows, int n, Tvl1Consts k,
                          cudaStream_t stream) {
  const int blocks = (H + rows - 1) / rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)kOnchipFloats * (rows + 2) * W * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, tvl1_iterate_kernel_onchip<kSlots>, u, p, rho_c, gx, gy,
                            u_out, p_out, H, W, rows, n, k);
}

template <int kSlots>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(tvl1_iterate_kernel_onchip<kSlots>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kOnchipSmemMax);
}

}  // namespace

// One iteration of B images of H x W on `stream`: u (B, 2, H, W), p (B, 2,
// 2, H, W), rho_c, gx, gy (B, H, W) in; u_out, p_out, fresh buffers of u's
// and p's shapes, out.  The wrapper (ops/flow.py) checks shapes, types,
// contiguity and the 32-bit index range.
extern "C" int stabnet_tvl1_iterate_f32(const void* u, const void* p, const void* rho_c,
                                        const void* gx, const void* gy, void* u_out,
                                        void* p_out, int B, int H, int W, float l_t,
                                        float theta, float sigma, float eps, void* stream) {
  if ((long long)B * H * W == 0) return 0;
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, B);
  tvl1_iterate_kernel<<<grid, dim3(kTileX, kTileY + 2), 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)p, (const float*)rho_c, (const float*)gx,
      (const float*)gy, (float*)u_out, (float*)p_out, H, W, Tvl1Consts{l_t, theta, sigma, eps});
  return (int)cudaGetLastError();
}

// Lets the on-chip kernel take its shared memory on the current device;
// called once a device before its first launch, outside any graph capture.
extern "C" int stabnet_tvl1_onchip_init(void) {
  const cudaError_t errs[] = {allow_smem<1>(), allow_smem<2>(), allow_smem<3>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

// n iterations of B images of H x W in one launch, each image a cluster of
// ceil(H / rows) blocks of `rows` rows (ops/flow.py `onchip_rows`, which
// keeps a band within 3,072 pixels); arguments otherwise as
// stabnet_tvl1_iterate_f32.
extern "C" int stabnet_tvl1_iterate_n_f32(const void* u, const void* p, const void* rho_c,
                                          const void* gx, const void* gy, void* u_out,
                                          void* p_out, int B, int H, int W, int rows, int n,
                                          float l_t, float theta, float sigma, float eps,
                                          void* stream) {
  if ((long long)B * H * W == 0) return 0;
  const int band = rows * W;
  const int slots = (band + kOnchipThreads - 1) / kOnchipThreads;
  const int threads = ((band + slots - 1) / slots + 31) / 32 * 32;
  const Tvl1Consts k{l_t, theta, sigma, eps};
  const float* args[5] = {(const float*)u, (const float*)p, (const float*)rho_c,
                          (const float*)gx, (const float*)gy};
  cudaError_t e;
#define STABNET_TVL1_ONCHIP(S)                                                              \
  case S:                                                                                   \
    e = launch_onchip<S>(threads, args[0], args[1], args[2], args[3], args[4],             \
                         (float*)u_out, (float*)p_out, B, H, W, rows, n, k,                 \
                         (cudaStream_t)stream);                                             \
    break;
  switch (slots) {
    STABNET_TVL1_ONCHIP(1)
    STABNET_TVL1_ONCHIP(2)
    STABNET_TVL1_ONCHIP(3)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef STABNET_TVL1_ONCHIP
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
