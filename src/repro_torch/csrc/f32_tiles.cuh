// The f32 row-tile bodies of the expert kernels moe_gmm.cu and, with int8
// / int4 weights widened as they are staged, moe_gmm_quant.cu (moe_ffn.cu
// has bodies of its own, f32_sgemm.cuh's among them),
// for f32 operands: the reference's Pallas kernels take any float dtype
// and compute in f32, and f32 x f32 has no tensor-core form (wgmma and
// mma.sync take bf16, fp16, fp8 or TF32, which keeps about three digits),
// so these run f32 FFMA on the CUDA cores.
//
// A block of F32_NT threads owns up to F32_TM rows of one expert's row
// tile by F32_TN output columns; each thread keeps a 4 x 4 patch of the
// block's outputs in registers (pass 1: a gate and an up patch).  Per
// F32_TK-deep step the block stages the rows' activations, transposed
// ([k][row], so a thread reads its four rows as one float4), and the
// weight columns ([k][col]) in shared memory, every load a float4, and
// each thread adds 4 x 4 (x2) products a k.  Rows past the tile's height
// and columns past the matrix's width load zeros and are never stored.
// Every output sums its k in order, so a row's result does not depend on
// the other rows of its tile.
//   f32_up_tile:   dst[r, f0 + c] = silu(x @ w1[e] gate) * (x @ w1[e] up)
//   f32_down_tile: dst[r, d0 + c] = h @ w2[e]
// h stays f32 between the two, as the f32 plain version keeps it.
// What bounds them: the FFMA rate (67 TFLOP/s f32 on the H100) at the
// forward's rows, the weight bytes (4 B an element) at a decode step's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32t {

constexpr int F32_TM = 64;      // rows a block
constexpr int F32_TN = 64;      // output columns a block
constexpr int F32_TK = 16;      // contraction step
constexpr int F32_NT = 256;     // 16 x 16 threads, 4 x 4 outputs each

// x rows [row0, row0 + rows) of a [*, K] matrix (row pitch ldx), k in
// [k0, k0 + F32_TK), into xs_t[k][row]; zeros past ``rows`` (K is a
// multiple of F32_TK)
__device__ __forceinline__ void stage_rows(float* xs_t,
                                           const float* __restrict__ x,
                                           size_t ldx, int rows, int k0) {
  const int r = threadIdx.x / 4, kq = (threadIdx.x % 4) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < rows)
    v = __ldg(reinterpret_cast<const float4*>(x + r * ldx + k0 + kq));
  xs_t[(kq + 0) * F32_TM + r] = v.x;
  xs_t[(kq + 1) * F32_TM + r] = v.y;
  xs_t[(kq + 2) * F32_TM + r] = v.z;
  xs_t[(kq + 3) * F32_TM + r] = v.w;
}

// weight rows [k0, k0 + F32_TK) of a [K, *] matrix (row pitch ldw),
// columns [col0, col0 + F32_TN), into ws[k][col]; zeros past ``ncols``
// (a multiple of 4)
__device__ __forceinline__ void stage_cols(float* ws,
                                           const float* __restrict__ w,
                                           size_t ldw, int col0, int ncols,
                                           int k0) {
  const int k = threadIdx.x / 16, c = (threadIdx.x % 16) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col0 + c < ncols)
    v = __ldg(reinterpret_cast<const float4*>(w + (size_t)(k0 + k) * ldw +
                                              col0 + c));
  *reinterpret_cast<float4*>(ws + k * F32_TN + c) = v;
}

__device__ __forceinline__ void fma_patch(float (&acc)[4][4], float4 a,
                                          float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// Pass 1 over K = D: acc_g / acc_u += rows (1..F32_TM) rows of x (row
// pitch D) times the gate / up columns that ``stage_w(wg, wu, k0)``
// stages for contraction rows [k0, k0 + F32_TK) ([k][col], as
// stage_cols); ``act(g, u, f)`` makes h[r, f] of the sums, stored at
// dst[r * F + f0 + c] for the block's F32_TN columns.
template <class StageW, class Act>
__device__ __forceinline__ void f32_up_tile_with(const float* __restrict__ x,
                                                 int rows,
                                                 float* __restrict__ dst,
                                                 int D, int F, int f0,
                                                 StageW stage_w, Act act) {
  __shared__ __align__(16) float xs_t[F32_TK * F32_TM];
  __shared__ __align__(16) float wg[F32_TK * F32_TN];
  __shared__ __align__(16) float wu[F32_TK * F32_TN];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float ag[4][4] = {}, au[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += F32_TK) {
    __syncthreads();                    // the previous step is consumed
    stage_rows(xs_t, x, D, rows, k0);
    stage_w(wg, wu, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F32_TK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(xs_t + k * F32_TM +
                                                        tr * 4);
      fma_patch(ag, a, *reinterpret_cast<const float4*>(wg + k * F32_TN +
                                                        tc * 4));
      fma_patch(au, a, *reinterpret_cast<const float4*>(wu + k * F32_TN +
                                                        tc * 4));
    }
  }
  const int c = f0 + tc * 4;
  if (c >= F) return;                   // F % 32 == 0: all 4 or none
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (r >= rows) break;
    float h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = act(ag[i][j], au[i][j], c + j);
    *reinterpret_cast<float4*>(dst + (size_t)r * F + c) =
        make_float4(h[0], h[1], h[2], h[3]);
  }
}

// Pass 1 on f32 weights: rows of x against expert w1e [D, 2F],
// dst[r * F + f0 + c] = silu(gate) * up.
__device__ __forceinline__ void f32_up_tile(const float* __restrict__ x,
                                            int rows,
                                            const float* __restrict__ w1e,
                                            float* __restrict__ dst, int D,
                                            int F, int f0) {
  f32_up_tile_with(
      x, rows, dst, D, F, f0,
      [=](float* wg, float* wu, int k0) {
        stage_cols(wg, w1e, 2 * (size_t)F, f0, F, k0);
        stage_cols(wu, w1e + F, 2 * (size_t)F, f0, F, k0);
      },
      [](float g, float u, int) { return g / (1.0f + expf(-g)) * u; });
}

// Pass 2 over K = F: rows of h (row pitch F) times the columns that
// ``stage_w(ws, k0)`` stages ([k][col]); dst[r * D + d0 + c] for the
// block's F32_TN columns.
template <class StageW>
__device__ __forceinline__ void f32_down_tile_with(
    const float* __restrict__ h, int rows, float* __restrict__ dst, int D,
    int F, int d0, StageW stage_w) {
  __shared__ __align__(16) float hs_t[F32_TK * F32_TM];
  __shared__ __align__(16) float ws[F32_TK * F32_TN];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < F; k0 += F32_TK) {
    __syncthreads();
    stage_rows(hs_t, h, F, rows, k0);
    stage_w(ws, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F32_TK; ++k)
      fma_patch(acc,
                *reinterpret_cast<const float4*>(hs_t + k * F32_TM + tr * 4),
                *reinterpret_cast<const float4*>(ws + k * F32_TN + tc * 4));
  }
  const int c = d0 + tc * 4;
  if (c >= D) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (r >= rows) break;
    *reinterpret_cast<float4*>(dst + (size_t)r * D + c) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// Pass 2 on f32 weights: rows of h against expert w2e [F, D].
__device__ __forceinline__ void f32_down_tile(const float* __restrict__ h,
                                              int rows,
                                              const float* __restrict__ w2e,
                                              float* __restrict__ dst, int D,
                                              int F, int d0) {
  f32_down_tile_with(h, rows, dst, D, F, d0, [=](float* ws, int k0) {
    stage_cols(ws, w2e, D, d0, D, k0);
  });
}

// A block's rows of a row tile of block_m rows: F32_TM rows a block, the
// tile's parts along the grid's y (block_m > F32_TM); sets the tile and
// the block's first row, returns its row count.
__device__ __forceinline__ int f32_part_rows(int block_m, int& tile,
                                             int& row0) {
  const int parts = (block_m + F32_TM - 1) / F32_TM;
  tile = blockIdx.y / parts;
  const int part = blockIdx.y % parts;
  row0 = tile * block_m + part * F32_TM;
  return min(F32_TM, block_m - part * F32_TM);
}

}  // namespace f32t
