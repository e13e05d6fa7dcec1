// Device code shared by the tensor-core expert kernels (moe_gmm.cu,
// moe_gmm_quant.cu, moe_ffn.cu): a CUDA block of four warps owns a 64-row
// by 64-column output block, stages bf16 tiles of one 32-deep contraction
// step in shared memory with 16-byte loads, and runs WMMA (bf16 in, f32
// accumulate) on them; warp w owns rows [16w, 16w + 16).  Loads are
// synchronous with one barrier a step: no double buffering, no TMA, no
// wgmma yet.
//
// up_block and down_block are the two passes of an expert SwiGLU over a
// bf16 scratch h, for rows of one expert:
//   up:   h = silu(x @ W1[:, :F]) * (x @ W1[:, F:]), rounded to bf16
//   down: out = h @ W2
// Rows from nrows on (a ragged last row block) are zero-filled on load
// and never stored; F may be any multiple of 32: the up pass's last
// column block loads zeros past F and stores only the columns below it,
// in its own instantiation, so that the full blocks carry no masks.

#pragma once

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
#define LDA (BK + 8)     // shared-memory row pitch of the A tiles (bf16)
#define LDB (BN + 8)     // shared-memory row pitch of the B tiles (bf16)
#define LDC (BN + 4)     // shared-memory row pitch of the f32 results

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

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

// acc[j] += A (16 rows of sA, from row warp*16) @ B (sB, all BN columns)
__device__ __forceinline__ void mma_step(Acc* acc, const bf16* sA,
                                         const bf16* sB, int warp) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, sA + warp * 16 * LDA + kk, LDA);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      FragB b;
      wmma::load_matrix_sync(b, sB + kk * LDB + j * 16, LDB);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// The up pass for one block's columns [f0, f0 + BN) of h; RAGGED: F's
// ragged last column block, the only one that masks columns.  smem holds
// 2 * BM * LDC floats.
template <bool RAGGED>
__device__ __forceinline__ void up_tile(unsigned char* smem,
                                        const bf16* __restrict__ xrow,
                                        const bf16* __restrict__ W,
                                        bf16* __restrict__ hrow, int nrows,
                                        int D, int F, int f0) {
  const int fcols = RAGGED ? F - f0 : BN;
  const int warp = threadIdx.x / 32;
  const bool active = warp * 16 < nrows;
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sG = sA + BM * LDA;
  bf16* sU = sG + BK * LDB;

  Acc accG[BN / 16], accU[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    wmma::fill_fragment(accG[j], 0.0f);
    wmma::fill_fragment(accU[j], 0.0f);
  }
  for (int k0 = 0; k0 < D; k0 += BK) {
    load_a(sA, xrow, D, nrows, k0);
    load_b(sG, W, 2 * F, k0, f0, fcols);
    load_b(sU, W, 2 * F, k0, F + f0, fcols);
    __syncthreads();
    if (active) {
      mma_step(accG, sA, sG, warp);
      mma_step(accU, sA, sU, warp);
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
    if (RAGGED && c >= fcols) continue;
    const float g = cG[r * LDC + c], u = cU[r * LDC + c];
    hrow[(size_t)r * F + f0 + c] = __float2bfloat16(g / (1.0f + __expf(-g)) * u);
  }
}

// The up pass for one block: x rows at xrow (pitch D), W1 one expert's
// [D, 2F], h rows at hrow (pitch F); columns [f0, f0 + BN) of h.
__device__ __forceinline__ void up_block(const bf16* __restrict__ xrow,
                                         const bf16* __restrict__ W,
                                         bf16* __restrict__ hrow, int nrows,
                                         int D, int F, int f0) {
  __shared__ __align__(128) unsigned char smem[2 * BM * LDC * sizeof(float)];
  if (F - f0 < BN)                             // uniform across the block
    up_tile<true>(smem, xrow, W, hrow, nrows, D, F, f0);
  else
    up_tile<false>(smem, xrow, W, hrow, nrows, D, F, f0);
}

// The down pass for one block: h rows at hrow (pitch F), W2 one expert's
// [F, D], out rows at orow (pitch D); columns [d0, d0 + BN) of out.
__device__ __forceinline__ void down_block(const bf16* __restrict__ hrow,
                                           const bf16* __restrict__ W,
                                           bf16* __restrict__ orow, int nrows,
                                           int D, int F, int d0) {
  const int warp = threadIdx.x / 32;
  const bool active = warp * 16 < nrows;
  __shared__ __align__(128) unsigned char smem[BM * LDC * sizeof(float)];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + BM * LDA;

  Acc acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < F; k0 += BK) {
    load_a(sA, hrow, F, nrows, k0);
    load_b(sB, W, D, k0, d0);
    __syncthreads();
    if (active) mma_step(acc, sA, sB, warp);
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
    orow[(size_t)r * D + d0 + c] = __float2bfloat16(cO[r * LDC + c]);
  }
}
