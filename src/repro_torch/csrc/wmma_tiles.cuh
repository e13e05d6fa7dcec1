// Device code of the WMMA expert kernel (moe_gmm_quant.cu; the bf16
// kernels moe_gmm.cu and moe_ffn.cu are on wgmma_tiles.cuh): a CUDA block
// of four warps owns a 64-row by 64-column output block, stages bf16 tiles
// of one 32-deep contraction step in shared memory with 16-byte loads, and
// runs WMMA (bf16 in, f32 accumulate) on them; warp w owns rows
// [16w, 16w + 16).  Loads are synchronous with one barrier a step: no
// double buffering, no TMA, no wgmma.  Rows from nrows on (a ragged last
// row block) are zero-filled on load.

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
