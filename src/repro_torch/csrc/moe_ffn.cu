// moe_ffn: per-expert SwiGLU over capacity buffers (the dense MoE path).
//
// Replaces the TPU kernel src/repro/kernels/moe_ffn.py::moe_ffn_pallas.
// Contract (identical): xe [E, C, D], w1 [E, D, 2F] (gate = first F
// columns, up = next F), w2 [E, F, D] -> out [E, C, D] in xe's dtype (bf16,
// or f32 with f32 weights: f32_tiles.cuh's bodies, h kept in f32),
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

#include "f32_tiles.cuh"
#include "wgmma_tiles.cuh"

using namespace wgt;
using namespace f32t;

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

// f32 operands (f32_tiles.cuh): grid (column block, F32_TM-row tile of C,
// expert); h stays f32 between the passes.
__global__ void __launch_bounds__(F32_NT)
ffn_up_f32_kernel(const float* __restrict__ xe, const float* __restrict__ w1,
                  float* __restrict__ h, int C, int D, int F) {
  const int e = blockIdx.z, r0 = blockIdx.y * F32_TM;
  f32_up_tile(xe + ((size_t)e * C + r0) * D, min(F32_TM, C - r0),
              w1 + (size_t)e * D * 2 * F, h + ((size_t)e * C + r0) * F, D, F,
              blockIdx.x * F32_TN);
}

__global__ void __launch_bounds__(F32_NT)
ffn_down_f32_kernel(const float* __restrict__ h,
                    const float* __restrict__ w2, float* __restrict__ out,
                    int C, int D, int F) {
  const int e = blockIdx.z, r0 = blockIdx.y * F32_TM;
  f32_down_tile(h + ((size_t)e * C + r0) * F, min(F32_TM, C - r0),
                w2 + (size_t)e * F * D, out + ((size_t)e * C + r0) * D, D, F,
                blockIdx.x * F32_TN);
}

static int launch_f32(const void* xe, const void* w1, const void* w2,
                      void* h, void* out, int E, int C, int D, int F,
                      cudaStream_t s) {
  const int n_rt = (C + F32_TM - 1) / F32_TM;
  if (n_rt > 65535) return (int)cudaErrorInvalidValue;
  ffn_up_f32_kernel<<<dim3((F + F32_TN - 1) / F32_TN, n_rt, E), F32_NT, 0,
                      s>>>(static_cast<const float*>(xe),
                           static_cast<const float*>(w1),
                           static_cast<float*>(h), C, D, F);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ffn_down_f32_kernel<<<dim3(D / F32_TN, n_rt, E), F32_NT, 0, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w2),
      static_cast<float*>(out), C, D, F);
  return (int)cudaGetLastError();
}

// xe [E, C, D], w1 [E, D, 2F], w2 [E, F, D], out [E, C, D] bf16 (f32 when
// f32 is nonzero); h [E, C, F] scratch of the same type.  Needs D % 64 ==
// 0, F % 32 == 0 and 16-byte aligned bases.  Returns cudaGetLastError()
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
