// moe_ffn: per-expert SwiGLU over capacity buffers (the dense MoE path).
//
// Replaces the TPU kernel src/repro/kernels/moe_ffn.py::moe_ffn_pallas.
// Contract (identical): xe [E, C, D], w1 [E, D, 2F] (gate = first F
// columns, up = next F), w2 [E, F, D] -> out [E, C, D] in xe's dtype (bf16,
// or f32 with f32 weights: the f32 bodies below, h kept in f32),
// out[e] = (silu(xe[e] @ w1[e][:, :F]) * (xe[e] @ w1[e][:, F:])) @ w2[e]
// with f32 products.  It walks every expert, empty or not, and every
// capacity row: a row no token copy filled is zero in xe, and comes out
// exactly zero (silu(0) * 0 = 0, and 0 @ w2 = 0).
//
// What bounds it on the H100: bytes.  Every expert's weights are read,
// whatever the routing: at OLMoE-1B-7B's experts (E 64, D 2048, F 1024)
// 805 MB of bf16, 0.24 ms at 3.35 TB/s, plus the [E, C, D] buffers in and
// out (C 4 at a decode step of 8 slots, 80 in a chunk of 8 x 64 tokens,
// 320 in a 4 x 512-token forward, at top-8).  At C 320 the tensor-core
// work (258 GFLOP, 0.26 ms at 989 TFLOP/s) is about as long as the bytes.
//
// Design.  The TPU grid (E, C/bc, F/bf) carries an f32 [bc, D] accumulator
// across its sequential F steps in VMEM (1-5 MB); that does not fit the
// 227 KB of shared memory a CUDA block may use, and CUDA blocks run in no
// order.  So it is B1's (moe_gmm.cu) two passes over a bf16 [E, C, F]
// scratch h, on the same row-tile bodies of wgmma_tiles.cuh:
//   pass 1 (ffn_up):   h[e, rows, f0:f0+128] =
//                          silu(xe[e] @ gate) * (xe[e] @ up)
//   pass 2 (ffn_down): out[e, rows, d0:d0+256] = h[e, rows] @ w2[e][:, d0:]
// A producer thread keeps TMA loads in flight through a 4-stage ring (48
// KB a stage: the rows' boxes and 256 weight columns), two consumer
// warpgroups run wgmma m64n128k16 on each stage as it lands, pass 1
// applies SwiGLU in registers, and h is rounded to bf16 between the
// passes, as the tensor cores take it -- the TPU kernel keeps it in f32 --
// so the result differs from the f32 reference by about bf16's relative
// step on each row.
//
// Rows.  A block owns one row tile of one expert: C is cut into tiles of
// 128 rows (two warpgroups) and a last one of the rest (C 320: 128, 128,
// 64; C 80: one of 80; C 4: one of 4, in one warpgroup).  The expert comes
// from the grid (the buffers are in expert order; there is no routing
// table).  xe and h are described to TMA as 3-D maps [E, C, D] and [E, C,
// F], so a box past C is zero-filled and never reads the next expert's
// rows, and the epilogue stores only rows below C, whatever C is.  F may
// be any multiple of 32 (an intra-pruned DeepSeek-V2-Lite expert has F =
// 1056): w1 is described as [E * D, 2, F] and w2 as [E, F, D], so a box
// past F reads zeros.
//
// Grid order.  The row tile is the fastest index, then the column block,
// then the expert: the row tiles of one expert's column block run
// together, so the second and third read their weight boxes from the L2,
// and the blocks in flight cover whole weight rows of a few experts.
// Pass 2 takes 256 output columns a block (two B operands), so at a decode
// step (C 4), where the time is all weight bytes, each block streams 512
// KB of w2 and 1 MB of w1 and the ring's fill is paid half as often.
// Clusters of the row tiles of one column block, with the weight boxes
// multicast to them, were slower at every C measured (2-4 row tiles, with
// or without the multicast), and are not used.

#include "f32_sgemm.cuh"
#include "wgmma_tiles.cuh"

using namespace wgt;

// the launch's shape (tools/expert_kernel_variants.py times others)
constexpr int UP_STAGES = 4;
constexpr int DOWN_STAGES = 4;
constexpr int DOWN_NB = 2;        // B operands of 128 output columns
constexpr int UP_COLS = BN;
constexpr int DOWN_COLS = BN * DOWN_NB;

// the block's row tile, column block and expert; rows of the tile
struct Tile {
  int r0, rows, col0, e;
};

__device__ __forceinline__ Tile block_tile(int C, int cols) {
  const int n_rt = (C + ROWS - 1) / ROWS;
  Tile t;
  t.r0 = (blockIdx.x % n_rt) * ROWS;
  t.rows = min(ROWS, C - t.r0);
  t.col0 = (blockIdx.x / n_rt) * cols;
  t.e = blockIdx.y;
  return t;
}

__global__ void __launch_bounds__(THREADS, 1)
ffn_up_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w1,
              bf16* __restrict__ h, int C, int D, int F) {
  extern __shared__ uint8_t dyn_smem[];
  const Tile t = block_tile(C, UP_COLS);
  up_tile<UP_STAGES>(dyn_smem, &tm_x, &tm_w1, t.e, t.e, t.r0, t.rows,
                     h + ((size_t)t.e * C + t.r0) * F, D, F, t.col0);
}

__global__ void __launch_bounds__(THREADS, 1)
ffn_down_kernel(const __grid_constant__ CUtensorMap tm_h,
                const __grid_constant__ CUtensorMap tm_w2,
                bf16* __restrict__ out, int C, int D, int F) {
  extern __shared__ uint8_t dyn_smem[];
  const Tile t = block_tile(C, DOWN_COLS);
  down_tile<DOWN_STAGES, DOWN_NB>(dyn_smem, &tm_h, &tm_w2, t.e, t.e, t.r0,
                             t.rows, out + ((size_t)t.e * C + t.r0) * D, D,
                             F, t.col0);
}

// ---- f32 operands: two bodies of B9's own, chosen by C ------------------
// (h stays f32 between the passes, as the f32 plain version keeps it)
//
// The decode body (C <= DEC_MAX_C, 24: up to three row groups of 8 it
// beats the tile body's 32-row tile, PERF.md): what bounds it is the
// weight bytes
// (every expert's 24 MB of f32 weights at OLMoE's widths, 0.48 ms at 3.35
// TB/s), so it streams them once and computes no padding row.  A block
// owns RG rows of one expert's capacity buffer (RG 4 up to C 4, else 8:
// C 24 is three row groups, which run side by side and share the weights
// through the L2) by 128 output columns, 4 a lane.  It stages its rows
// in shared memory, transposed ([k][RG], so a lane reads the RG values of
// one k as LDS.128 broadcasts): at once where they fit DEC_XS_FLOATS (64
// KB; OLMoE's widths), else in chunks of every warp's slice with a
// barrier between (llama4-scout's D 5120 and F 8192: 3 and 4 chunks at RG
// 8), each warp's k in the same order.  Its DEC_WARPS warps split the
// contraction into equal slices, and each lane streams its weight float4s
// straight into registers, DEC_LOADS of them in flight a batch, each used
// for RG (x 4 columns) FFMAs.  The warps' partial sums meet in shared
// memory and are summed in warp order, so the result is fixed and a
// row's does not depend on the other rows.  Grid: the row group fastest,
// then the column block, then the expert (OLMoE at C 4: 512 blocks in
// pass 1, 1024 in pass 2).
//
// The tile body (C > DEC_MAX_C): the FFMA rate bounds it (at C 80 the
// real work is 64 GFLOP, 0.96 ms at 67 TFLOP/s), so it is
// f32_sgemm.cuh's register-tiled SGEMM with the row tile cut to C: the
// fewest padded rows over tiles of 16 TM rows (TM <= TILE_MAX_TM; C 80:
// one tile of TM 5, C 320: four; ``tile_shape``).  Grid: the row tile fastest (a column
// block's row tiles share its weights through the L2), then the column
// block (64 h columns in pass 1, 128 output columns in pass 2), then the
// expert.
//
// Both sum every output's k in an order fixed by C alone, so a row's
// output does not depend on the other rows of the buffer, and an empty
// row comes out exactly 0.

// the launch's shape (tools/expert_kernel_variants.py times others)
constexpr int DEC_MAX_C = 24;     // the largest C the decode body takes
constexpr int DEC_WARPS = 8;      // warps a decode block: the K split
constexpr int DEC_LOADS = 16;     // weight float4s a lane loads a batch
constexpr int DEC_XS_FLOATS = 16384;  // staged activations at most: 64 KB
constexpr int DEC_MIN_BLOCKS = 2;
constexpr int TILE_STAGES = 2;    // the tile body's cp.async ring
constexpr int TILE_BK = 16;       // contraction rows a stage
constexpr int TILE_MAX_TM = 8;    // a tile body thread's rows, at most
constexpr int TILE_MIN_BLOCKS = 2;

namespace dec {

constexpr int NT = 32 * DEC_WARPS;
constexpr int COLS = 128;         // a block's output columns, 4 a lane

// n contraction rows of every warp's slice (kw rows of x [*, K], row
// pitch K, the warp's first at w kw), from row k1 of the slice, into
// xs[w n + i][RG]; zeros past rows.  One chunk (k1 0, n kw) is x's rows
// transposed, xs[k][RG]
template <int RG>
__device__ __forceinline__ void stage_t(float* xs, const float* __restrict__ x,
                                        int rows, int K, int kw, int k1,
                                        int n) {
  const int q = n / 4;                    // float4s of a warp's chunk row
  for (int idx = threadIdx.x; idx < RG * DEC_WARPS * q; idx += NT) {
    const int r = idx / (DEC_WARPS * q), wi = idx % (DEC_WARPS * q);
    const int w = wi / q, i = (wi % q) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      v = __ldg(reinterpret_cast<const float4*>(
          x + (size_t)r * K + w * kw + k1 + i));
    float* xw = xs + (w * n + i) * RG + r;
    xw[0] = v.x;
    xw[RG] = v.y;
    xw[2 * RG] = v.z;
    xw[3 * RG] = v.w;
  }
}

// N contraction rows from k: acc[g][r][j] += xs[k'][r] * w[g][k' ldw + j]
template <int RG, int NB, int N>
__device__ __forceinline__ void steps(const float* xs,
                                      const float* const (&w)[NB],
                                      size_t ldw, int k,
                                      float (&acc)[NB][RG][4]) {
  float4 wv[N][NB];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int g = 0; g < NB; ++g)
      wv[j][g] = __ldg(reinterpret_cast<const float4*>(
          w[g] + (size_t)(k + j) * ldw));
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float xv[RG];
#pragma unroll
    for (int r = 0; r < RG; r += 4) {
      const float4 v =
          *reinterpret_cast<const float4*>(xs + (k + j) * RG + r);
      xv[r] = v.x, xv[r + 1] = v.y, xv[r + 2] = v.z, xv[r + 3] = v.w;
    }
#pragma unroll
    for (int g = 0; g < NB; ++g)
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        acc[g][r][0] = fmaf(xv[r], wv[j][g].x, acc[g][r][0]);
        acc[g][r][1] = fmaf(xv[r], wv[j][g].y, acc[g][r][1]);
        acc[g][r][2] = fmaf(xv[r], wv[j][g].z, acc[g][r][2]);
        acc[g][r][3] = fmaf(xv[r], wv[j][g].w, acc[g][r][3]);
      }
  }
}

// this warp's slice of the contraction: kw rows from xs (already at the
// slice's first row) and w[g] (its first row, the lane's column)
template <int RG, int NB>
__device__ __forceinline__ void contract(const float* xs,
                                         const float* const (&w)[NB],
                                         size_t ldw, int kw,
                                         float (&acc)[NB][RG][4]) {
  constexpr int U = DEC_LOADS * 4 / (NB * RG);
  int k = 0;
  for (; k + U <= kw; k += U) steps<RG, NB, U>(xs, w, ldw, k, acc);
  for (; k < kw; ++k) steps<RG, NB, 1>(xs, w, ldw, k, acc);
}

// the warps' partial sums into red[warp][g][r][COLS] (after a barrier:
// red takes xs's space)
template <int RG, int NB>
__device__ __forceinline__ void put_partials(float* red,
                                             const float (&acc)[NB][RG][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < NB; ++g)
#pragma unroll
    for (int r = 0; r < RG; ++r)
      *reinterpret_cast<float4*>(
          red + ((warp * NB + g) * RG + r) * COLS + lane * 4) =
          make_float4(acc[g][r][0], acc[g][r][1], acc[g][r][2],
                      acc[g][r][3]);
}

// sum over the warps, in warp order, of output (g, r, c)
template <int RG, int NB>
__device__ __forceinline__ float sum_partials(const float* red, int g, int r,
                                              int c) {
  float s = red[(g * RG + r) * COLS + c];
#pragma unroll
  for (int w = 1; w < DEC_WARPS; ++w)
    s += red[((w * NB + g) * RG + r) * COLS + c];
  return s;
}

// a warp's chunk of contraction rows: its whole slice where RG rows of K
// fit DEC_XS_FLOATS (OLMoE's D 2048 and F 1024 at RG 8), else chunks
template <int RG>
__host__ __device__ constexpr int chunk(int K) {
  return K / DEC_WARPS < DEC_XS_FLOATS / (DEC_WARPS * RG)
             ? K / DEC_WARPS
             : DEC_XS_FLOATS / (DEC_WARPS * RG);
}

// the staged rows, then the warps' partial sums, in one space
template <int RG>
constexpr int smem_floats(int K, int NB) {
  return RG * DEC_WARPS * chunk<RG>(K) > DEC_WARPS * NB * RG * COLS
             ? RG * DEC_WARPS * chunk<RG>(K)
             : DEC_WARPS * NB * RG * COLS;
}

// the block's row group, rows in it and first output column
struct Block {
  int r0, rows, c0, e;
};

template <int RG>
__device__ __forceinline__ Block block(int C) {
  const int n_rg = (C + RG - 1) / RG;
  Block b;
  b.r0 = (blockIdx.x % n_rg) * RG;
  b.rows = min(RG, C - b.r0);
  b.c0 = (blockIdx.x / n_rg) * COLS;
  b.e = blockIdx.y;
  return b;
}

}  // namespace dec

template <int RG>
__global__ void __launch_bounds__(dec::NT, DEC_MIN_BLOCKS)
ffn_up_dec_kernel(const float* __restrict__ xe, const float* __restrict__ w1,
                  float* __restrict__ h, int C, int D, int F) {
  extern __shared__ __align__(16) float dsm[];
  const dec::Block b = dec::block<RG>(C);
  const float* x = xe + ((size_t)b.e * C + b.r0) * D;
  const int warp = threadIdx.x / 32, c = b.c0 + (threadIdx.x % 32) * 4;
  const int kw = D / DEC_WARPS, k0 = warp * kw, kc = dec::chunk<RG>(D);
  float acc[2][RG][4] = {};
  for (int k1 = 0; k1 < kw; k1 += kc) {
    const int n = min(kc, kw - k1);
    if (k1) __syncthreads();              // the last chunk is read
    dec::stage_t<RG>(dsm, x, b.rows, D, kw, k1, n);
    __syncthreads();
    if (c < F) {                          // F % 32 == 0: all 4 or none
      const float* wg = w1 + ((size_t)b.e * D + k0 + k1) * 2 * F + c;
      const float* const w[2] = {wg, wg + F};
      dec::contract<RG, 2>(dsm + warp * n * RG, w, 2 * (size_t)F, n, acc);
    }
  }
  __syncthreads();                        // xs is read
  dec::put_partials<RG, 2>(dsm, acc);
  __syncthreads();
  for (int o = threadIdx.x; o < RG * dec::COLS; o += dec::NT) {
    const int r = o / dec::COLS, cc = o % dec::COLS;
    if (r >= b.rows || b.c0 + cc >= F) continue;
    const float g = dec::sum_partials<RG, 2>(dsm, 0, r, cc);
    const float u = dec::sum_partials<RG, 2>(dsm, 1, r, cc);
    h[((size_t)b.e * C + b.r0 + r) * F + b.c0 + cc] =
        g / (1.0f + expf(-g)) * u;
  }
}

template <int RG>
__global__ void __launch_bounds__(dec::NT, DEC_MIN_BLOCKS)
ffn_down_dec_kernel(const float* __restrict__ h, const float* __restrict__ w2,
                    float* __restrict__ out, int C, int D, int F) {
  extern __shared__ __align__(16) float dsm[];
  const dec::Block b = dec::block<RG>(C);
  const float* x = h + ((size_t)b.e * C + b.r0) * F;
  const int warp = threadIdx.x / 32, c = b.c0 + (threadIdx.x % 32) * 4;
  const int kw = F / DEC_WARPS, k0 = warp * kw, kc = dec::chunk<RG>(F);
  float acc[1][RG][4] = {};
  for (int k1 = 0; k1 < kw; k1 += kc) {
    const int n = min(kc, kw - k1);
    if (k1) __syncthreads();              // the last chunk is read
    dec::stage_t<RG>(dsm, x, b.rows, F, kw, k1, n);
    __syncthreads();
    if (c < D) {                          // D % 64 == 0: all 4 or none
      const float* const w[1] = {w2 + ((size_t)b.e * F + k0 + k1) * D + c};
      dec::contract<RG, 1>(dsm + warp * n * RG, w, (size_t)D, n, acc);
    }
  }
  __syncthreads();
  dec::put_partials<RG, 1>(dsm, acc);
  __syncthreads();
  for (int o = threadIdx.x; o < RG * dec::COLS; o += dec::NT) {
    const int r = o / dec::COLS, cc = o % dec::COLS;
    if (r >= b.rows || b.c0 + cc >= D) continue;
    out[((size_t)b.e * C + b.r0 + r) * D + b.c0 + cc] =
        dec::sum_partials<RG, 1>(dsm, 0, r, cc);
  }
}

template <int RG>
static int launch_dec(const float* xe, const float* w1, const float* w2,
                      float* h, float* out, int E, int C, int D, int F,
                      cudaStream_t s) {
  const int n_rg = (C + RG - 1) / RG;
  const int up = dec::smem_floats<RG>(D, 2) * 4;
  const int down = dec::smem_floats<RG>(F, 1) * 4;
  int err;
  if ((err = allow_smem(ffn_up_dec_kernel<RG>, up)) ||
      (err = allow_smem(ffn_down_dec_kernel<RG>, down)))
    return err;
  ffn_up_dec_kernel<RG><<<dim3(n_rg * ((F + dec::COLS - 1) / dec::COLS), E),
                          dec::NT, up, s>>>(xe, w1, h, C, D, F);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ffn_down_dec_kernel<RG><<<dim3(n_rg * ((D + dec::COLS - 1) / dec::COLS), E),
                            dec::NT, down, s>>>(h, w2, out, C, D, F);
  return (int)cudaGetLastError();
}

// the tile body's grid: the row tile fastest, then the column block
template <int TM>
__global__ void __launch_bounds__(f32g::NT, TILE_MIN_BLOCKS)
ffn_up_tile_kernel(const float* __restrict__ xe,
                   const float* __restrict__ w1, float* __restrict__ h,
                   int C, int D, int F, int n_t) {
  extern __shared__ __align__(16) float tsm[];
  constexpr int BM = 16 * TM;
  const int r0 = (blockIdx.x % n_t) * BM, e = blockIdx.y;
  f32g::up_tile<TM, TILE_STAGES, TILE_BK>(
      tsm, xe + ((size_t)e * C + r0) * D, min(BM, C - r0),
      w1 + (size_t)e * D * 2 * F, h + ((size_t)e * C + r0) * F, D, F,
      (blockIdx.x / n_t) * f32g::GW);
}

template <int TM>
__global__ void __launch_bounds__(f32g::NT, TILE_MIN_BLOCKS)
ffn_down_tile_kernel(const float* __restrict__ h,
                     const float* __restrict__ w2, float* __restrict__ out,
                     int C, int D, int F, int n_t) {
  extern __shared__ __align__(16) float tsm[];
  constexpr int BM = 16 * TM;
  const int r0 = (blockIdx.x % n_t) * BM, e = blockIdx.y;
  f32g::down_tile<TM, TILE_STAGES, TILE_BK>(
      tsm, h + ((size_t)e * C + r0) * F, min(BM, C - r0),
      w2 + (size_t)e * F * D, out + ((size_t)e * C + r0) * D, D, F,
      (blockIdx.x / n_t) * 2 * f32g::GW);
}

template <int TM>
static int launch_tile(const float* xe, const float* w1, const float* w2,
                       float* h, float* out, int E, int C, int D, int F,
                       int n_t, cudaStream_t s) {
  constexpr int smem = f32g::Tile<TM, TILE_STAGES, TILE_BK>::BYTES;
  int err;
  if ((err = allow_smem(ffn_up_tile_kernel<TM>, smem)) ||
      (err = allow_smem(ffn_down_tile_kernel<TM>, smem)))
    return err;
  ffn_up_tile_kernel<TM><<<dim3(n_t * ((F + f32g::GW - 1) / f32g::GW), E),
                           f32g::NT, smem, s>>>(xe, w1, h, C, D, F, n_t);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ffn_down_tile_kernel<TM>
      <<<dim3(n_t * ((D + 2 * f32g::GW - 1) / (2 * f32g::GW)), E), f32g::NT,
         smem, s>>>(h, w2, out, C, D, F, n_t);
  return (int)cudaGetLastError();
}

// the tile body's row tiles: the fewest padded rows over n_t tiles of
// 16 TM rows (TM 2..TILE_MAX_TM), ties to the fewer tiles (C 320: four
// of TM 5, not three of TM 7, which took 6.7085 ms against 6.3805)
static void tile_shape(int C, int& tm, int& n_t) {
  const int lo = (C + 16 * TILE_MAX_TM - 1) / (16 * TILE_MAX_TM);
  int best = 0;
  for (int n = lo; n < lo + 4; ++n) {
    int t = ((C + n - 1) / n + 15) / 16;
    t = t < 2 ? 2 : t;
    if (best == 0 || n * t < best) best = n * t, tm = t, n_t = n;
  }
}

static int launch_f32(const void* xe_, const void* w1_, const void* w2_,
                      void* h_, void* out_, int E, int C, int D, int F,
                      cudaStream_t s) {
  const float* xe = static_cast<const float*>(xe_);
  const float* w1 = static_cast<const float*>(w1_);
  const float* w2 = static_cast<const float*>(w2_);
  float* h = static_cast<float*>(h_);
  float* out = static_cast<float*>(out_);
  if (C <= DEC_MAX_C)
    return C <= 4 ? launch_dec<4>(xe, w1, w2, h, out, E, C, D, F, s)
                  : launch_dec<8>(xe, w1, w2, h, out, E, C, D, F, s);
  int tm = 0, n_t = 0;
  tile_shape(C, tm, n_t);
  switch (tm) {
    case 2: return launch_tile<2>(xe, w1, w2, h, out, E, C, D, F, n_t, s);
    case 3: return launch_tile<3>(xe, w1, w2, h, out, E, C, D, F, n_t, s);
    case 4: return launch_tile<4>(xe, w1, w2, h, out, E, C, D, F, n_t, s);
    case 5: return launch_tile<5>(xe, w1, w2, h, out, E, C, D, F, n_t, s);
    case 6: return launch_tile<6>(xe, w1, w2, h, out, E, C, D, F, n_t, s);
    case 7: return launch_tile<7>(xe, w1, w2, h, out, E, C, D, F, n_t, s);
    case 8: return launch_tile<8>(xe, w1, w2, h, out, E, C, D, F, n_t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// xe [E, C, D], w1 [E, D, 2F], w2 [E, F, D], out [E, C, D] bf16 (f32 when
// f32 is nonzero); h [E, C, F] scratch of the same type.  Needs D % 64 ==
// 0, F % 32 == 0 and 16-byte aligned bases, nothing more of D, F or C
// (every body's shared memory is bounded whatever the widths).  Returns
// cudaGetLastError()
// after launch, or the error of encoding a tensor map.
extern "C" int moe_ffn_launch(const void* xe, const void* w1, const void* w2,
                              void* h, void* out, int E, int C, int D, int F,
                              int f32, void* stream) {
  if (D % 64 || F % 32 || C <= 0 || E <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (f32)
    return launch_f32(xe, w1, w2, h, out, E, C, D, F,
                      reinterpret_cast<cudaStream_t>(stream));
  CUtensorMap tx, tw1, th, tw2;
  int err;
  if ((err = activation_map(&tx, xe, E, C, D)) ||
      (err = activation_map(&th, h, E, C, F)) ||
      (err = weight_maps(&tw1, &tw2, w1, w2, E, D, F)))
    return err;
  constexpr int smem_up = smem_bytes(UP_STAGES, 2);
  constexpr int smem_down = smem_bytes(DOWN_STAGES, DOWN_NB);
  if ((err = allow_smem(ffn_up_kernel, smem_up)) ||
      (err = allow_smem(ffn_down_kernel, smem_down)))
    return err;
  const int n_rt = (C + ROWS - 1) / ROWS;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  ffn_up_kernel<<<dim3(n_rt * ((F + UP_COLS - 1) / UP_COLS), E), THREADS,
                  smem_up, s>>>(tx, tw1, static_cast<bf16*>(h), C, D, F);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ffn_down_kernel<<<dim3(n_rt * ((D + DOWN_COLS - 1) / DOWN_COLS), E),
                    THREADS, smem_down, s>>>(th, tw2, static_cast<bf16*>(out),
                                             C, D, F);
  return (int)cudaGetLastError();
}
