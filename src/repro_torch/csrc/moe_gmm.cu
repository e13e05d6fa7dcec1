// moe_gmm: ragged grouped SwiGLU over the sorted, tile-aligned MoE buffer.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py::moe_gmm_pallas.
// Contract (identical): xs [M, D] rows sorted by expert, each row tile of
// block_m rows belongs to one expert; tile_expert[i] names tile i's expert
// (clamped into [0, E) for dead tiles) and tile_valid[i] is 1 iff the tile
// holds a real row.  out = SwiGLU(xs; w1[e], w2[e]) per tile, with
// w1 [E, D, 2F] (gate = first F columns, up = next F) and w2 [E, F, D];
// dead tiles write zeros and do no math.  Operands bf16, or all f32 (the
// reference's kernel takes any float dtype): f32 runs f32_sgemm.cuh's
// register-tiled row-tile body, FFMA on the CUDA cores, on the rows each
// tile really holds (below), h kept in f32.
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

#include "f32_sgemm.cuh"
#include "wgmma_tiles.cuh"

using namespace wgt;

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

// f32 operands: f32_sgemm.cuh's row-tile body on the rows each tile
// really holds.  A count pass (f32g::count_rows) first finds them (1 +
// the tile's last row that is not all zero; 0 for a dead tile) into the
// ``tile_rows`` scratch, by segments of 16 rows; a block of pass 1
// computes 16 TM rows (f32g::with_tile_rows picks TM from the count) by
// 64 h columns, a block of pass 2 by 128 output columns, and writes +0
// for the rows past the count (all of a dead tile's), which is what their
// products give: a padding row is all zero.  The launch's shape
// (tools/expert_kernel_variants.py times others):
constexpr int F32_STAGES = 3;     // the cp.async ring's stages
constexpr int F32_BK = 16;        // contraction rows a stage
constexpr int F32_MIN_TM = 4;     // rows a thread at least past 16 rows
constexpr int F32_MIN_BLOCKS = 2;
constexpr bool F32_SKIP = true;   // warps past a tile's rows skip FFMAs

// the shared memory of the largest TM
using F32Tile = f32g::Tile<f32g::MAX_TM, F32_STAGES, F32_BK>;

__global__ void __launch_bounds__(f32g::NT, F32_MIN_BLOCKS)
gmm_up_f32_kernel(const float* __restrict__ xs, const float* __restrict__ w1,
                  const int* __restrict__ tile_expert,
                  const int* __restrict__ tile_rows, float* __restrict__ h,
                  int D, int F, int block_m) {
  const int tile = blockIdx.y, rows = f32g::tile_count(tile_rows, tile);
  if (rows == 0) return;                        // pass 2 writes the zeros
  extern __shared__ __align__(16) float fsm[];
  const size_t row0 = (size_t)tile * block_m;
  const float* w1e = w1 + (size_t)tile_expert[tile] * D * 2 * F;
  f32g::with_tile_rows<F32_MIN_TM>(rows, [&](auto tm) {
    f32g::up_tile<decltype(tm)::value, F32_STAGES, F32_BK, F32_SKIP>(
        fsm, xs + row0 * D, rows, w1e, h + row0 * F, D, F,
        blockIdx.x * f32g::GW);
  });
}

__global__ void __launch_bounds__(f32g::NT, F32_MIN_BLOCKS)
gmm_down_f32_kernel(const float* __restrict__ h,
                    const float* __restrict__ w2,
                    const int* __restrict__ tile_expert,
                    const int* __restrict__ tile_rows,
                    float* __restrict__ out, int D, int F, int block_m) {
  const int tile = blockIdx.y, rows = f32g::tile_count(tile_rows, tile);
  const int d0 = blockIdx.x * 2 * f32g::GW;
  extern __shared__ __align__(16) float fsm[];
  const size_t row0 = (size_t)tile * block_m;
  float* dst = out + row0 * D;
  if (rows > 0) {
    const float* w2e = w2 + (size_t)tile_expert[tile] * F * D;
    f32g::with_tile_rows<F32_MIN_TM>(rows, [&](auto tm) {
      f32g::down_tile<decltype(tm)::value, F32_STAGES, F32_BK, F32_SKIP>(
          fsm, h + row0 * F, rows, w2e, dst, D, F, d0);
    });
  }
  f32g::zero_rows(dst, D, rows, block_m, d0, min(2 * f32g::GW, D - d0));
}

static int launch_f32(const void* xs, const void* w1, const void* w2,
                      const void* tile_expert, const void* tile_valid,
                      void* tile_rows, void* h, void* out, int M, int D,
                      int F, int block_m, cudaStream_t s) {
  constexpr int smem = F32Tile::BYTES;
  int err;
  if ((err = allow_smem(gmm_up_f32_kernel, smem)) ||
      (err = allow_smem(gmm_down_f32_kernel, smem)))
    return err;
  const int n_tiles = M / block_m;
  int* rows = static_cast<int*>(tile_rows);
  cudaError_t e = f32g::count_rows(
      static_cast<const float*>(xs), static_cast<const int*>(tile_valid),
      rows, n_tiles, D, block_m, s);
  if (e != cudaSuccess) return (int)e;
  gmm_up_f32_kernel<<<dim3((F + f32g::GW - 1) / f32g::GW, n_tiles),
                      f32g::NT, smem, s>>>(
      static_cast<const float*>(xs), static_cast<const float*>(w1),
      static_cast<const int*>(tile_expert), rows, static_cast<float*>(h), D,
      F, block_m);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gmm_down_f32_kernel<<<dim3((D + 2 * f32g::GW - 1) / (2 * f32g::GW),
                             n_tiles), f32g::NT, smem, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w2),
      static_cast<const int*>(tile_expert), rows, static_cast<float*>(out),
      D, F, block_m);
  return (int)cudaGetLastError();
}

// The f32 instance's count pass alone (tools/expert_kernel_variants.py
// times it): tile_rows [M / block_m, 8] int32 (each tile's count the
// largest of its 8) of xs [M, D] f32.
extern "C" int moe_gmm_tile_rows_launch(const void* xs,
                                        const void* tile_valid,
                                        void* tile_rows, int M, int D,
                                        int block_m, void* stream) {
  if (D % 64 || block_m <= 0 || M % block_m)
    return (int)cudaErrorInvalidValue;
  return (int)f32g::count_rows(
      static_cast<const float*>(xs), static_cast<const int*>(tile_valid),
      static_cast<int*>(tile_rows), M / block_m, D, block_m,
      reinterpret_cast<cudaStream_t>(stream));
}

// xs [M, D], w1 [E, D, 2F], w2 [E, F, D], out [M, D] bf16 (f32 when f32 is
// nonzero); tile_expert, tile_valid [M / block_m] int32; h [M, F] scratch
// of the same type; f32: tile_rows [M / block_m, 8] int32 scratch (the
// count pass's; bf16: unused).  Needs D % 64 == 0, F % 32 == 0, block_m % 8 == 0 and
// <= 128, 16-byte aligned bases.  Returns cudaGetLastError() after launch,
// or the error of encoding a tensor map.
extern "C" int moe_gmm_launch(const void* xs, const void* w1, const void* w2,
                              const void* tile_expert, const void* tile_valid,
                              void* tile_rows, void* h, void* out, int M,
                              int D, int F, int block_m, int E, int f32,
                              void* stream) {
  if (D % 64 || F % 32 || block_m % 8 || block_m > ROWS || block_m <= 0 ||
      M % block_m || M / block_m > 65535)
    return (int)cudaErrorInvalidValue;
  if (f32)
    return launch_f32(xs, w1, w2, tile_expert, tile_valid, tile_rows, h, out,
                      M, D, F, block_m,
                      reinterpret_cast<cudaStream_t>(stream));
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
