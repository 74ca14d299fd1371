// TV-L1's primal-dual iteration for Hopper (sm_90a).
//
// K7  stabnet_tvl1_iterate_f32
//     Replaces no TPU kernel: the JAX package runs the iteration as XLA's
//     fusion of the loop body of `_tvl1_level` (stabnet_tpu/ops/flow.py).
//     In the port each iteration was some forty tensor operations
//     (`tvl1_iterate_plain`, ops/flow.py), each a kernel of its own: at the
//     coarse pyramid levels every one sat at the launch floor, at the fine
//     level every one moved a whole (B, 2, H, W) tensor through device
//     memory.  A scored clip runs 14,000 iterations (7 chunks of 32 pairs,
//     4 levels of 5 warps x 100 iterations), a flow-fed training batch
//     1,700.  One launch now does the whole iteration: the data term's
//     thresholding, the primal step with the divergence of p, the forward
//     gradient of the new u and the dual step.
//
// What bounds it on this card: bytes.  Per pixel it reads u (2 floats), p
// (4), rho_c, gx and gy and writes u and p: 60 B against some sixty float
// operations, far below the compute ridge.  At the metrics' finest level,
// (32, 144, 256), that is 70.8 MB, 21.1 us at 3.35 TB/s; at the coarse
// levels a launch is of the order of its data, so the design keeps one
// launch per iteration and no intermediate in device memory.
//
// Layout: a block owns a tile of 8 rows x 32 columns of one image
// (blockIdx.z), a warp one tile row, one pixel a thread.  The dual step at
// a pixel needs the NEW u of its right and lower neighbours, so the block
// first computes the primal step on its tile and on a halo of one row below
// and one column to the right (recomputed from the inputs, never read back
// from another block's output; two more warps take it, so no warp takes two
// steps while the others wait) into shared memory, then the dual step on
// its tile.  The primal step reads p at the left and upper neighbours
// through the read-only cache.  The kernel writes fresh u and p buffers and
// never its inputs, so a captured CUDA graph takes their addresses from its
// pool like any other output.
//
// Arithmetic: every product, sum, quotient and square root is rounded
// separately (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn,
// no FMA contraction), in the order of `tvl1_iterate_plain`, and each of
// its Python numbers (lam * theta, theta, tau / theta, 1e-9) arrives
// rounded to float32 once, as PyTorch hands a scalar to a float32 kernel.
// So kernel and plain version agree bit for bit, which the data term's
// discontinuous thresholding needs: a one-ulp drift can flip a case.  The
// borders follow `_divergence` and `_grad_forward`: dx = px[0] at x = 0,
// px[x] - px[x-1] inside, -px[W-2] at x = W-1 (likewise dy down the rows);
// the gradient 0 at the far border.  clamp_min keeps a NaN, as PyTorch's.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
// Threads a block: a warp per tile row, one for the row below the tile and
// one whose first kTileY lanes take the column right of it.
constexpr int kThreads = kTileX * (kTileY + 2);

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
