// moe_gmm: ragged grouped SwiGLU over the sorted, tile-aligned MoE buffer.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py::moe_gmm_pallas.
// Contract (identical): xs [M, D] rows sorted by expert, each row tile of
// block_m rows belongs to one expert; tile_expert[i] names tile i's expert
// (clamped into [0, E) for dead tiles) and tile_valid[i] is 1 iff the tile
// holds a real row.  out = SwiGLU(xs; w1[e], w2[e]) per tile, with
// w1 [E, D, 2F] (gate = first F columns, up = next F) and w2 [E, F, D];
// dead tiles write zeros and do no math.  Operands bf16, or all f32 (the
// reference's kernel takes any float dtype): f32 runs f32_tiles.cuh's
// row-tile bodies, FFMA on the CUDA cores, h kept in f32.
//
// What bounds it on the H100: at the serving shapes (D 2048, F 1024, 64
// experts, 512 tokens x top-8) every expert is routed, so one call must
// stream all 64 experts' weights, 805 MB of bf16: about 0.24 ms at
// 3.35 TB/s, against about 0.05 ms of tensor-core work on the real rows.
// It is bound by bytes, and near the ridge at the forward's 16384 copies
// (206 GFLOP, 0.21 ms).
//
// Design.  The TPU kernel keeps a whole [block_m, D] f32 accumulator in
// VMEM across the F loop (1 MB at block_m 128); that does not fit the
// 227 KB of shared memory a block may use.  So the work is split in two
// passes over a [M, F] bf16 scratch buffer h:
//   pass 1 (gmm_up):   h = silu(xs @ w1[e][:, :F]) * (xs @ w1[e][:, F:])
//   pass 2 (gmm_down): out = h @ w2[e]
// Each block reads its own tile_expert / tile_valid entries (they stand in
// for the TPU's scalar prefetch) and owns one whole row tile (block_m <=
// 128 rows, two consumer warpgroups of 64) by 128 columns, so each weight
// tile is read from device memory once per row tile.  The column block is
// the grid's fastest index: the blocks in flight together cover whole
// weight rows of one expert (full DRAM pages, one x tile in the L2)
// rather than the same 256-byte strip of many experts.  The loads and the
// products are wgmma_tiles.cuh's row-tile bodies (up_tile, down_tile): a
// producer thread keeps TMA loads of 64-deep steps in flight through a
// ring of stages (pass 1: the rows' x box and the gate and up columns, 48
// KB a stage, 4 stages; pass 2: the rows' h box and the w2 columns, 32 KB,
// 6 stages), and the consumers run wgmma m64n128k16 on each stage as it
// lands.  Pass 1 keeps gate and up side by side in registers and applies
// SwiGLU there; h is rounded to bf16 between the passes, as the tensor
// cores take it.  Ragged edges cost no masks in the main loop: xs and h
// are one plane of a 3-D map ([1, M, D], [1, M, F]), w1 is described as
// [E * D, 2, F] and w2 as [E, F, D], so a box past F (F any multiple of
// 32: an intra-pruned DeepSeek-V2-Lite expert has F = 1056) reads zeros
// and not the up columns or the next expert's rows; rows past the tile's
// end (block_m any multiple of 8 up to 128) are computed from the next
// tile's rows or zeros and never stored.  A warpgroup with no rows of the
// tile (block_m <= 64) sits out.

#include "f32_tiles.cuh"
#include "wgmma_tiles.cuh"

using namespace wgt;
using namespace f32t;

constexpr int UP_STAGES = 4;      // x box(es) + gate and up columns
constexpr int DOWN_STAGES = 6;    // h box(es) + w2 columns
constexpr int DOWN_NB = 1;        // 128 output columns a block

__global__ void __launch_bounds__(THREADS, 1)
gmm_up_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w1,
              const int* __restrict__ tile_expert,
              const int* __restrict__ tile_valid, bf16* __restrict__ h,
              int D, int F, int block_m) {
  const int tile = blockIdx.y;
  if (!tile_valid[tile]) return;                // pass 2 writes the zeros
  extern __shared__ uint8_t dyn_smem[];
  const int row0 = tile * block_m;
  up_tile<UP_STAGES>(dyn_smem, &tm_x, &tm_w1, tile_expert[tile], 0, row0,
                     block_m, h + (size_t)row0 * F, D, F, blockIdx.x * BN);
}

__global__ void __launch_bounds__(THREADS, 1)
gmm_down_kernel(const __grid_constant__ CUtensorMap tm_h,
                const __grid_constant__ CUtensorMap tm_w2,
                const int* __restrict__ tile_expert,
                const int* __restrict__ tile_valid, bf16* __restrict__ out,
                int D, int F, int block_m) {
  const int tile = blockIdx.y;
  const int d0 = blockIdx.x * BN * DOWN_NB, row0 = tile * block_m;
  if (!tile_valid[tile]) {                      // dead tile: zeros, no math
    const int vecs = min(BN * DOWN_NB, D - d0) / 8;   // D % 64 == 0
    for (int i = threadIdx.x; i < block_m * vecs; i += THREADS)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + i / vecs) * D + d0 +
                                (i % vecs) * 8) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  extern __shared__ uint8_t dyn_smem[];
  down_tile<DOWN_STAGES, DOWN_NB>(dyn_smem, &tm_h, &tm_w2, tile_expert[tile],
                                  0, row0, block_m,
                                  out + (size_t)row0 * D, D, F, d0);
}

// f32 operands (f32_tiles.cuh): a block takes F32_TM rows of a row tile
// (block_m > F32_TM: the tile's parts along the grid's y,
// f32_part_rows) by F32_TN columns; h stays f32 between the passes.
__global__ void __launch_bounds__(F32_NT)
gmm_up_f32_kernel(const float* __restrict__ xs, const float* __restrict__ w1,
                  const int* __restrict__ tile_expert,
                  const int* __restrict__ tile_valid, float* __restrict__ h,
                  int D, int F, int block_m) {
  int tile, row0;
  const int rows = f32_part_rows(block_m, tile, row0);
  if (!tile_valid[tile]) return;                // pass 2 writes the zeros
  f32_up_tile(xs + (size_t)row0 * D, rows,
              w1 + (size_t)tile_expert[tile] * D * 2 * F,
              h + (size_t)row0 * F, D, F, blockIdx.x * F32_TN);
}

__global__ void __launch_bounds__(F32_NT)
gmm_down_f32_kernel(const float* __restrict__ h,
                    const float* __restrict__ w2,
                    const int* __restrict__ tile_expert,
                    const int* __restrict__ tile_valid,
                    float* __restrict__ out, int D, int F, int block_m) {
  int tile, row0;
  const int rows = f32_part_rows(block_m, tile, row0);
  const int d0 = blockIdx.x * F32_TN;
  if (!tile_valid[tile]) {                      // dead tile: zeros, no math
    for (int i = threadIdx.x; i < rows * (F32_TN / 4); i += F32_NT)
      *reinterpret_cast<float4*>(out + (size_t)(row0 + i / (F32_TN / 4)) * D +
                                 d0 + (i % (F32_TN / 4)) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  f32_down_tile(h + (size_t)row0 * F, rows,
                w2 + (size_t)tile_expert[tile] * F * D,
                out + (size_t)row0 * D, D, F, d0);
}

static int launch_f32(const void* xs, const void* w1, const void* w2,
                      const void* tile_expert, const void* tile_valid,
                      void* h, void* out, int M, int D, int F, int block_m,
                      cudaStream_t s) {
  const int parts = (block_m + F32_TM - 1) / F32_TM;
  const int blocks_y = M / block_m * parts;
  if (blocks_y > 65535) return (int)cudaErrorInvalidValue;
  gmm_up_f32_kernel<<<dim3((F + F32_TN - 1) / F32_TN, blocks_y), F32_NT, 0,
                      s>>>(
      static_cast<const float*>(xs), static_cast<const float*>(w1),
      static_cast<const int*>(tile_expert),
      static_cast<const int*>(tile_valid), static_cast<float*>(h), D, F,
      block_m);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gmm_down_f32_kernel<<<dim3(D / F32_TN, blocks_y), F32_NT, 0, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w2),
      static_cast<const int*>(tile_expert),
      static_cast<const int*>(tile_valid), static_cast<float*>(out), D, F,
      block_m);
  return (int)cudaGetLastError();
}

// xs [M, D], w1 [E, D, 2F], w2 [E, F, D], out [M, D] bf16 (f32 when f32 is
// nonzero); tile_expert, tile_valid [M / block_m] int32; h [M, F] scratch
// of the same type.  Needs D % 64 == 0, F % 32 == 0, block_m % 8 == 0 and
// <= 128, 16-byte aligned bases.  Returns cudaGetLastError() after launch,
// or the error of encoding a tensor map.
extern "C" int moe_gmm_launch(const void* xs, const void* w1, const void* w2,
                              const void* tile_expert, const void* tile_valid,
                              void* h, void* out, int M, int D, int F,
                              int block_m, int E, int f32, void* stream) {
  if (D % 64 || F % 32 || block_m % 8 || block_m > ROWS || block_m <= 0 ||
      M % block_m)
    return (int)cudaErrorInvalidValue;
  if (f32)
    return launch_f32(xs, w1, w2, tile_expert, tile_valid, h, out, M, D, F,
                      block_m, reinterpret_cast<cudaStream_t>(stream));
  CUtensorMap tx, tw1, th, tw2;
  int err;
  if ((err = activation_map(&tx, xs, 1, M, D)) ||
      (err = activation_map(&th, h, 1, M, F)) ||
      (err = weight_maps(&tw1, &tw2, w1, w2, E, D, F)))
    return err;
  constexpr int smem_up = smem_bytes(UP_STAGES, 2);
  constexpr int smem_down = smem_bytes(DOWN_STAGES, DOWN_NB);
  if ((err = allow_smem(gmm_up_kernel, smem_up)) ||
      (err = allow_smem(gmm_down_kernel, smem_down)))
    return err;
  const int n_tiles = M / block_m;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  gmm_up_kernel<<<dim3((F + BN - 1) / BN, n_tiles), THREADS, smem_up, s>>>(
      tx, tw1, static_cast<const int*>(tile_expert),
      static_cast<const int*>(tile_valid), static_cast<bf16*>(h), D, F,
      block_m);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gmm_down_kernel<<<dim3((D + BN * DOWN_NB - 1) / (BN * DOWN_NB), n_tiles),
                    THREADS, smem_down, s>>>(
      th, tw2, static_cast<const int*>(tile_expert),
      static_cast<const int*>(tile_valid), static_cast<bf16*>(out), D, F,
      block_m);
  return (int)cudaGetLastError();
}
