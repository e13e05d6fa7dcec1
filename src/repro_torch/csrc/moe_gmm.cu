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
// block loads zeros past F and stores only the columns below it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define BM 64            // rows per CUDA block
#define BN 64            // output columns per CUDA block
#define BK 32            // contraction step
#define NT 128           // 4 warps; warp w owns rows [16w, 16w + 16)
#define LDA (BK + 8)     // shared-memory row pitch of the A tile (bf16)
#define LDB (BN + 8)     // shared-memory row pitch of the B tiles (bf16)
#define LDC (BN + 4)     // shared-memory row pitch of the f32 results

// Load rows [0, nrows) x cols [k0, k0 + BK) of a row-major bf16 matrix
// (row pitch ld, first row at src) into sA [BM][LDA]; rows >= nrows are 0.
__device__ __forceinline__ void load_a(bf16* sA, const bf16* src, int ld,
                                       int nrows, int k0) {
  for (int v = threadIdx.x; v < BM * BK / 8; v += NT) {
    const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + k0 + c);
    *reinterpret_cast<uint4*>(sA + r * LDA + c) = val;
  }
}

// Load rows [k0, k0 + BK) x cols [c0, c0 + BN) of a row-major bf16 matrix
// (row pitch ld) into sB [BK][LDB]; columns from c0 + ncols on (ncols a
// multiple of 8) are 0.
__device__ __forceinline__ void load_b(bf16* sB, const bf16* src, int ld,
                                       int k0, int c0, int ncols = BN) {
  for (int v = threadIdx.x; v < BK * BN / 8; v += NT) {
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < ncols)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(k0 + r) * ld +
                                            c0 + c);
    *reinterpret_cast<uint4*>(sB + r * LDB + c) = val;
  }
}

__global__ void __launch_bounds__(NT)
gmm_up_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ w1,
              const int* __restrict__ tile_expert,
              const int* __restrict__ tile_valid, bf16* __restrict__ h,
              int D, int F, int block_m, int chunks) {
  const int tile = blockIdx.x / chunks;
  if (!tile_valid[tile]) return;               // pass 2 writes the zeros
  const int chunk = blockIdx.x % chunks;
  const int e = tile_expert[tile];
  const int row0 = tile * block_m + chunk * BM;
  const int nrows = min(BM, block_m - chunk * BM);
  const int f0 = blockIdx.y * BN;
  const int fcols = min(BN, F - f0);           // < BN in a ragged last block
  const int warp = threadIdx.x / 32;
  const bool active = warp * 16 < nrows;
  const bf16* W = w1 + (size_t)e * D * 2 * F;

  __shared__ __align__(128) unsigned char smem[2 * BM * LDC * sizeof(float)];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sG = sA + BM * LDA;
  bf16* sU = sG + BK * LDB;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> accG[BN / 16], accU[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    wmma::fill_fragment(accG[j], 0.0f);
    wmma::fill_fragment(accU[j], 0.0f);
  }
  const bf16* xrow = xs + (size_t)row0 * D;
  for (int k0 = 0; k0 < D; k0 += BK) {
    load_a(sA, xrow, D, nrows, k0);
    load_b(sG, W, 2 * F, k0, f0, fcols);
    load_b(sU, W, 2 * F, k0, F + f0, fcols);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sA + warp * 16 * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, sG + kk * LDB + j * 16, LDB);
          wmma::mma_sync(accG[j], a, b, accG[j]);
          wmma::load_matrix_sync(b, sU + kk * LDB + j * 16, LDB);
          wmma::mma_sync(accU[j], a, b, accU[j]);
        }
      }
    }
    __syncthreads();
  }
  float* cG = reinterpret_cast<float*>(smem);
  float* cU = cG + BM * LDC;
  if (active) {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wmma::store_matrix_sync(cG + warp * 16 * LDC + j * 16, accG[j], LDC, wmma::mem_row_major);
      wmma::store_matrix_sync(cU + warp * 16 * LDC + j * 16, accU[j], LDC, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    if (c >= fcols) continue;
    const float g = cG[r * LDC + c], u = cU[r * LDC + c];
    h[(size_t)(row0 + r) * F + f0 + c] = __float2bfloat16(g / (1.0f + __expf(-g)) * u);
  }
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
  const int e = tile_expert[tile];
  const int warp = threadIdx.x / 32;
  const bool active = warp * 16 < nrows;
  const bf16* W = w2 + (size_t)e * F * D;

  __shared__ __align__(128) unsigned char smem[BM * LDC * sizeof(float)];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + BM * LDA;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  const bf16* hrow = h + (size_t)row0 * F;
  for (int k0 = 0; k0 < F; k0 += BK) {
    load_a(sA, hrow, F, nrows, k0);
    load_b(sB, W, D, k0, d0);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sA + warp * 16 * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, sB + kk * LDB + j * 16, LDB);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    __syncthreads();
  }
  float* cO = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      wmma::store_matrix_sync(cO + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    out[(size_t)(row0 + r) * D + d0 + c] = __float2bfloat16(cO[r * LDC + c]);
  }
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
