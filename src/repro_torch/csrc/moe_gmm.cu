// moe_gmm: ragged grouped SwiGLU over the sorted, tile-aligned MoE buffer.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py::moe_gmm_pallas.
// Contract (identical): xs [M, D] rows sorted by expert, each row tile of
// block_m rows belongs to one expert; tile_expert[i] names tile i's expert
// (clamped into [0, E) for dead tiles) and tile_valid[i] is 1 iff the tile
// holds a real row.  out = SwiGLU(xs; w1[e], w2[e]) per tile, with
// w1 [E, D, 2F] (gate = first F columns, up = next F) and w2 [E, F, D];
// dead tiles write zeros and do no math.
//
// What bounds it on the H100: at the serving shapes (D 2048, F 1024, 64
// experts, 512 tokens x top-8) every expert is routed, so one call must
// stream all 64 experts' weights, 805 MB of bf16: about 0.24 ms at
// 3.35 TB/s, against about 0.05 ms of tensor-core work on the real rows.
// It is bound by bytes.
//
// Design.  The TPU kernel keeps a whole [block_m, D] f32 accumulator in
// VMEM across the F loop (1 MB at block_m 128); that does not fit the
// 227 KB of shared memory a block may use.  So the work is split in two
// passes over a [M, F] bf16 scratch buffer h:
//   pass 1 (gmm_up):   h = silu(xs @ w1[e][:, :F]) * (xs @ w1[e][:, F:])
//   pass 2 (gmm_down): out = h @ w2[e]
// Each CUDA block reads its own tile_expert / tile_valid entries (they
// stand in for the TPU's scalar prefetch) and owns a 64-row by 64-column
// output block, so nothing is carried between blocks.  Products run on
// the tensor cores through WMMA (bf16 in, f32 accumulate); h is rounded to
// bf16 between the passes, as the tensor cores take it.  A block loads
// 16-byte vectors into shared memory and synchronises once per 32-deep
// step: no double buffering, no TMA, no wgmma yet -- that is later work.
// block_m may be any multiple of 8 up to 128: rows past the tile's end are
// zero-filled on load and never stored.  F may be any multiple of 32 (an
// intra-pruned DeepSeek-V2-Lite expert has F = 1056): pass 1's last column
// block loads zeros past F and stores only the columns below it.  The
// tile loads and both passes' block bodies are wmma_tiles.cuh's, shared
// with moe_ffn.cu.

#include "wmma_tiles.cuh"

__global__ void __launch_bounds__(NT)
gmm_up_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ w1,
              const int* __restrict__ tile_expert,
              const int* __restrict__ tile_valid, bf16* __restrict__ h,
              int D, int F, int block_m, int chunks) {
  const int tile = blockIdx.x / chunks;
  if (!tile_valid[tile]) return;               // pass 2 writes the zeros
  const int chunk = blockIdx.x % chunks;
  const int row0 = tile * block_m + chunk * BM;
  up_block(xs + (size_t)row0 * D, w1 + (size_t)tile_expert[tile] * D * 2 * F,
           h + (size_t)row0 * F, min(BM, block_m - chunk * BM), D, F,
           blockIdx.y * BN);
}

__global__ void __launch_bounds__(NT)
gmm_down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2,
                const int* __restrict__ tile_expert,
                const int* __restrict__ tile_valid, bf16* __restrict__ out,
                int D, int F, int block_m, int chunks) {
  const int tile = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int row0 = tile * block_m + chunk * BM;
  const int nrows = min(BM, block_m - chunk * BM);
  const int d0 = blockIdx.y * BN;
  if (!tile_valid[tile]) {                      // dead tile: zeros, no math
    for (int i = threadIdx.x; i < nrows * BN; i += NT)
      out[(size_t)(row0 + i / BN) * D + d0 + i % BN] = __float2bfloat16(0.0f);
    return;
  }
  down_block(h + (size_t)row0 * F, w2 + (size_t)tile_expert[tile] * F * D,
             out + (size_t)row0 * D, nrows, D, F, d0);
}

// xs [M, D], w1 [E, D, 2F], w2 [E, F, D], out [M, D] bf16; tile_expert,
// tile_valid [M / block_m] int32; h [M, F] bf16 scratch.  Needs D % 64 == 0,
// F % 32 == 0, block_m % 8 == 0.  Returns cudaGetLastError() after launch.
extern "C" int moe_gmm_launch(const void* xs, const void* w1, const void* w2,
                              const void* tile_expert, const void* tile_valid,
                              void* h, void* out, int M, int D, int F,
                              int block_m, void* stream) {
  const int n_tiles = M / block_m;
  const int chunks = (block_m + BM - 1) / BM;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 g1(n_tiles * chunks, (F + BN - 1) / BN);
  gmm_up_kernel<<<g1, NT, 0, s>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(w1),
      static_cast<const int*>(tile_expert), static_cast<const int*>(tile_valid),
      static_cast<bf16*>(h), D, F, block_m, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2(n_tiles * chunks, D / BN);
  gmm_down_kernel<<<g2, NT, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
      static_cast<const int*>(tile_expert), static_cast<const int*>(tile_valid),
      static_cast<bf16*>(out), D, F, block_m, chunks);
  return (int)cudaGetLastError();
}
