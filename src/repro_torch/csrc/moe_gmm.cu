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
// products are wgmma_tiles.cuh's: a producer thread keeps TMA loads of
// 64-deep steps in flight through a ring of stages (pass 1: the rows'
// x box and the gate and up columns, 48 KB a stage, 4 stages; pass 2: the
// rows' h box and the w2 columns, 32 KB, 6 stages), and the consumers run
// wgmma m64n128k16 on each stage as it lands.  Pass 1 keeps gate and up
// side by side in registers and applies SwiGLU there; h is rounded to bf16
// between the passes, as the tensor cores take it.  Ragged edges cost no
// masks in the main loop: w1 is described as [E * D, 2, F] and w2 as
// [E, F, D], so a box past F (F any multiple of 32: an intra-pruned
// DeepSeek-V2-Lite expert has F = 1056) reads zeros and not the up
// columns or the next expert's rows; rows past the tile's end (block_m
// any multiple of 8 up to 128) are computed from the next tile's rows or
// zeros and never stored.  A warpgroup with no rows of the tile (block_m
// <= 64) sits out.

#include "wgmma_tiles.cuh"

using namespace wgt;

constexpr int UP_STAGES = 4;      // x box(es) + gate and up columns
constexpr int DOWN_STAGES = 6;    // h box(es) + w2 columns

__global__ void __launch_bounds__(THREADS, 1)
gmm_up_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w1,
              const int* __restrict__ tile_expert,
              const int* __restrict__ tile_valid, bf16* __restrict__ h,
              int D, int F, int block_m) {
  const int tile = blockIdx.y;
  if (!tile_valid[tile]) return;                // pass 2 writes the zeros
  const int e = tile_expert[tile];
  const int f0 = blockIdx.x * BN, row0 = tile * block_m;
  const int n_wg = (block_m + WG_ROWS - 1) / WG_ROWS;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ uint64_t full[UP_STAGES], empty[UP_STAGES];
  uint8_t* ring = ring_base(dyn_smem);
  ring_init<UP_STAGES>(full, empty, n_wg);

  if (threadIdx.x >= PRODUCER) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER) {
      const CUtensorMap* mx = &tm_x;
      const CUtensorMap* mw = &tm_w1;
      produce<UP_STAGES, stage_bytes(2)>(
          ring, full, empty, D / BK, (n_wg + 4) * BOX_BYTES,
          [=](int i, uint8_t* st, uint64_t* bar) {
            const int k0 = i * BK;
            for (int a = 0; a < n_wg; ++a)
              tma_load_2d(st + a * BOX_BYTES, mx, bar, k0, row0 + a * WG_ROWS);
            uint8_t* sb = st + CONSUMERS * BOX_BYTES;
            for (int half = 0; half < 2; ++half)         // gate, up
              for (int c = 0; c < 2; ++c)
                tma_load_3d(sb + (2 * half + c) * BOX_BYTES, mw, bar,
                            f0 + c * BOX, half, e * D + k0);
          });
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128;
    if (wg < n_wg) {
      float acc[2][64];                          // gate, up
      consume<UP_STAGES, 2>(acc, ring, full, empty, D / BK, wg);
      const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = wg * WG_ROWS + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
        const int c = f0 + 8 * (i / 4) + 2 * (lane % 4);
        if (r < block_m && c < F) {
          const float g0 = acc[0][i], g1 = acc[0][i + 1];
          *reinterpret_cast<__nv_bfloat162*>(h + (size_t)(row0 + r) * F + c) =
              __floats2bfloat162_rn(g0 / (1.0f + __expf(-g0)) * acc[1][i],
                                    g1 / (1.0f + __expf(-g1)) * acc[1][i + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
gmm_down_kernel(const __grid_constant__ CUtensorMap tm_h,
                const __grid_constant__ CUtensorMap tm_w2,
                const int* __restrict__ tile_expert,
                const int* __restrict__ tile_valid, bf16* __restrict__ out,
                int D, int F, int block_m) {
  const int tile = blockIdx.y;
  const int d0 = blockIdx.x * BN, row0 = tile * block_m;
  if (!tile_valid[tile]) {                      // dead tile: zeros, no math
    const int vecs = min(BN, D - d0) / 8;       // D % 64 == 0
    for (int i = threadIdx.x; i < block_m * vecs; i += THREADS)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + i / vecs) * D + d0 +
                                (i % vecs) * 8) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int e = tile_expert[tile];
  const int n_wg = (block_m + WG_ROWS - 1) / WG_ROWS;
  const int nk = (F + BK - 1) / BK;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ uint64_t full[DOWN_STAGES], empty[DOWN_STAGES];
  uint8_t* ring = ring_base(dyn_smem);
  ring_init<DOWN_STAGES>(full, empty, n_wg);

  if (threadIdx.x >= PRODUCER) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER) {
      const CUtensorMap* mh = &tm_h;
      const CUtensorMap* mw = &tm_w2;
      produce<DOWN_STAGES, stage_bytes(1)>(
          ring, full, empty, nk, (n_wg + 2) * BOX_BYTES,
          [=](int i, uint8_t* st, uint64_t* bar) {
            const int k0 = i * BK;
            for (int a = 0; a < n_wg; ++a)
              tma_load_2d(st + a * BOX_BYTES, mh, bar, k0, row0 + a * WG_ROWS);
            uint8_t* sb = st + CONSUMERS * BOX_BYTES;
            for (int c = 0; c < 2; ++c)
              tma_load_3d(sb + c * BOX_BYTES, mw, bar, d0 + c * BOX, k0, e);
          });
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128;
    if (wg < n_wg) {
      float acc[1][64];
      consume<DOWN_STAGES, 1>(acc, ring, full, empty, nk, wg);
      const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = wg * WG_ROWS + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
        const int c = d0 + 8 * (i / 4) + 2 * (lane % 4);
        if (r < block_m && c < D)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * D + c) =
              __floats2bfloat162_rn(acc[0][i], acc[0][i + 1]);
      }
    }
  }
}

// xs [M, D], w1 [E, D, 2F], w2 [E, F, D], out [M, D] bf16; tile_expert,
// tile_valid [M / block_m] int32; h [M, F] bf16 scratch.  Needs D % 64 == 0,
// F % 32 == 0, block_m % 8 == 0 and <= 128, 16-byte aligned bases.
// Returns cudaGetLastError() after launch, or the error of encoding a
// tensor map.
extern "C" int moe_gmm_launch(const void* xs, const void* w1, const void* w2,
                              const void* tile_expert, const void* tile_valid,
                              void* h, void* out, int M, int D, int F,
                              int block_m, int E, void* stream) {
  if (D % 64 || F % 32 || block_m % 8 || block_m > ROWS || block_m <= 0 ||
      M % block_m)
    return (int)cudaErrorInvalidValue;
  const uint64_t m = M, d = D, f = F, ne = E;
  CUtensorMap tx, tw1, th, tw2;
  const uint32_t box_a[2] = {BOX, BOX}, box_w1[3] = {BOX, 1, BOX},
                 box_w2[3] = {BOX, BOX, 1};
  const uint64_t dx[2] = {d, m}, sx[1] = {2 * d};
  const uint64_t dw1[3] = {f, 2, ne * d}, sw1[2] = {2 * f, 4 * f};
  const uint64_t dh[2] = {f, m}, sh[1] = {2 * f};
  const uint64_t dw2[3] = {d, f, ne}, sw2[2] = {2 * d, 2 * f * d};
  int err;
  if ((err = make_map(&tx, xs, 2, dx, sx, box_a, false)) ||
      (err = make_map(&tw1, w1, 3, dw1, sw1, box_w1, true)) ||
      (err = make_map(&th, h, 2, dh, sh, box_a, false)) ||
      (err = make_map(&tw2, w2, 3, dw2, sw2, box_w2, true)))
    return err;
  constexpr int smem_up = smem_bytes(UP_STAGES, 2);
  constexpr int smem_down = smem_bytes(DOWN_STAGES, 1);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(gmm_up_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_up)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(gmm_down_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_down)) != cudaSuccess)
    return (int)e;
  const int n_tiles = M / block_m;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  gmm_up_kernel<<<dim3((F + BN - 1) / BN, n_tiles), THREADS, smem_up, s>>>(
      tx, tw1, static_cast<const int*>(tile_expert),
      static_cast<const int*>(tile_valid), static_cast<bf16*>(h), D, F,
      block_m);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gmm_down_kernel<<<dim3((D + BN - 1) / BN, n_tiles), THREADS, smem_down, s>>>(
      th, tw2, static_cast<const int*>(tile_expert),
      static_cast<const int*>(tile_valid), static_cast<bf16*>(out), D, F,
      block_m);
  return (int)cudaGetLastError();
}
