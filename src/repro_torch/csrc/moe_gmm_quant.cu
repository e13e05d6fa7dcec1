// moe_gmm_quant: ragged grouped SwiGLU over the sorted, tile-aligned MoE
// buffer, on int8- or int4-stored expert weights with in-kernel dequant.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py::moe_gmm_quant_pallas.
// Contract (identical): xs [M, D] bf16 rows sorted by expert, each row tile
// of block_m rows belongs to one expert; tile_expert[i] names tile i's
// expert and tile_valid[i] is 1 iff the tile holds a real row.
//   int8: w1q [E, D, 2F], w2q [E, F, D];
//   int4: w1q [E, D/2, 2F] packed along D (the contraction), w2q
//         [E, F, D/2] packed along D (the output), blocked halves
//         (quant_common.cuh);
//   s1 [E, 2, F] f32 (gate scales, then up scales), s2 [E, F] f32.
// out = (silu(gate * s1[e,0]) * (up * s1[e,1]) * s2[e]) @ w2q[e] per tile,
// gate / up = xs @ the first / next F columns of w1q[e]: s1 applies after
// the first product (constant along D), s2 folds into h before the second
// (it varies along the F contraction), no scale after it.  Dead tiles
// write zeros and do no math.
//
// What bounds it on the H100: at the serving shapes (D 2048, F 1024, 64
// experts, 512 tokens x top-8) every expert is routed, so one call must
// stream all 64 experts' weights: 403 MB in int8, 201 MB in int4, against
// B1's 805 MB of bf16 -- about 0.13 / 0.07 ms at 3.35 TB/s.  Bound by
// bytes; the tensor-core work on the real rows is about 0.05 ms.
//
// Design: B1's (moe_gmm.cu), with the weight tiles dequantized on load.
// Two passes over a [M, F] bf16 scratch buffer h:
//   pass 1 (up):   h = silu(gate * s1g) * (up * s1u) * s2, rounded to bf16
//   pass 2 (down): out = h @ w2q[e]
// Each CUDA block reads its own tile_expert / tile_valid entries and owns
// a 64-row by 64-column output block.  A thread loads 16 bytes of weights
// (16 int8 values, or 32 int4 values) and writes them to shared memory as
// integer-valued bf16, exact; products run on the tensor cores through
// WMMA (bf16 in, f32 accumulate), so they equal the TPU kernel's f32 dots
// up to summation order.  The scales are applied in f32 in the pass-1
// epilogue.  int4 reads each packed byte once: pass 1 takes a 32-row
// packed step as two contraction steps (x[:, r] times the low nibbles and
// x[:, D/2 + r] times the high ones); pass 2 turns a 64-column packed
// block into output columns c and D/2 + c with two accumulator sets.
// Synchronous loads, one barrier per step: no double buffering, no TMA,
// no wgmma yet -- that is later work.  F may be any multiple of 32, as in
// B1: pass 1's ragged last column block, launched apart so that the full
// blocks carry no masks, loads zeros past F and stores only the columns
// below it.  The bf16 tile loads and the WMMA step are wmma_tiles.cuh's.

#include "quant_common.cuh"
#include "wmma_tiles.cuh"

// Rows [r0, r0 + BK) x bytes [c0, c0 + BN) of a row-major int8 matrix (row
// pitch ld bytes) as integer-valued bf16: int8 (PACKED false) into
// sB [BK][LDB]; int4 (PACKED true) the low nibbles into sB and the high
// nibbles into sB2.  Bytes from c0 + ncols on (ncols a multiple of 16)
// are 0.
template <bool PACKED>
__device__ __forceinline__ void load_q(bf16* sB, bf16* sB2, const int8_t* src,
                                       int ld, int r0, int c0, int ncols = BN) {
  for (int v = threadIdx.x; v < BK * BN / 16; v += NT) {
    const int r = v / (BN / 16), c = (v % (BN / 16)) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < ncols)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c0 + c);
    const uint32_t w[4] = {val.x, val.y, val.z, val.w};
    __align__(16) __nv_bfloat162 lo[8];
    __align__(16) __nv_bfloat162 hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b0 = q_byte(w[i / 2], 2 * (i % 2));
      const int b1 = q_byte(w[i / 2], 2 * (i % 2) + 1);
      if constexpr (PACKED) {
        lo[i] = __floats2bfloat162_rn((float)q_lo(b0), (float)q_lo(b1));
        hi[i] = __floats2bfloat162_rn((float)q_hi(b0), (float)q_hi(b1));
      } else {
        lo[i] = __floats2bfloat162_rn((float)b0, (float)b1);
      }
    }
    uint4* d = reinterpret_cast<uint4*>(sB + r * LDB + c);
    d[0] = reinterpret_cast<const uint4*>(lo)[0];
    d[1] = reinterpret_cast<const uint4*>(lo)[1];
    if constexpr (PACKED) {
      uint4* d2 = reinterpret_cast<uint4*>(sB2 + r * LDB + c);
      d2[0] = reinterpret_cast<const uint4*>(hi)[0];
      d2[1] = reinterpret_cast<const uint4*>(hi)[1];
    }
  }
}

// Pass 1.  RAGGED: the launch of F's ragged last column block, the only
// one that masks columns (launched apart from the full blocks: a mask in
// every block, or both bodies in one kernel, cost 6-21 % at F 1024 on an
// H100); fblock0 is the launch's first column block.
template <bool PACKED, bool RAGGED>
__global__ void __launch_bounds__(NT)
gmmq_up_kernel(const bf16* __restrict__ xs, const int8_t* __restrict__ w1q,
               const float* __restrict__ s1, const float* __restrict__ s2,
               const int* __restrict__ tile_expert,
               const int* __restrict__ tile_valid, bf16* __restrict__ h,
               int D, int F, int block_m, int chunks, int fblock0) {
  const int tile = blockIdx.x / chunks;
  if (!tile_valid[tile]) return;               // pass 2 writes the zeros
  const int chunk = blockIdx.x % chunks;
  const int e = tile_expert[tile];
  const int row0 = tile * block_m + chunk * BM;
  const int nrows = min(BM, block_m - chunk * BM);
  const int f0 = (fblock0 + blockIdx.y) * BN;
  const int fcols = RAGGED ? F - f0 : BN;
  const int warp = threadIdx.x / 32;
  const bool active = warp * 16 < nrows;
  const int Dp = PACKED ? D / 2 : D;           // stored rows of w1q[e]
  const int8_t* W = w1q + (size_t)e * Dp * 2 * F;

  // A tiles (x rows; int4: also x[:, D/2 + r]), then the gate and up
  // tiles (int4: low and high nibbles of each); the epilogue reuses it all
  __shared__ __align__(128) unsigned char smem[2 * BM * LDC * sizeof(float)];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sA2 = sA + BM * LDA;
  bf16* sG = sA2 + (PACKED ? BM * LDA : 0);
  bf16* sU = sG + BK * LDB;
  bf16* sGh = sU + BK * LDB;
  bf16* sUh = sGh + BK * LDB;

  Acc accG[BN / 16], accU[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    wmma::fill_fragment(accG[j], 0.0f);
    wmma::fill_fragment(accU[j], 0.0f);
  }
  const bf16* xrow = xs + (size_t)row0 * D;
  for (int r0 = 0; r0 < Dp; r0 += BK) {
    load_a(sA, xrow, D, nrows, r0);
    if constexpr (PACKED) load_a(sA2, xrow, D, nrows, D / 2 + r0);
    load_q<PACKED>(sG, sGh, W, 2 * F, r0, f0, fcols);
    load_q<PACKED>(sU, sUh, W, 2 * F, r0, F + f0, fcols);
    __syncthreads();
    if (active) {
      mma_step(accG, sA, sG, warp);
      mma_step(accU, sA, sU, warp);
      if constexpr (PACKED) {
        mma_step(accG, sA2, sGh, warp);
        mma_step(accU, sA2, sUh, warp);
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
  const float* sg = s1 + (size_t)e * 2 * F + f0;      // gate scales
  const float* su = sg + F;                           // up scales
  const float* sd = s2 + (size_t)e * F + f0;          // down (f-row) scales
  for (int i = threadIdx.x; i < nrows * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    if (RAGGED && c >= fcols) continue;
    const float g = cG[r * LDC + c] * sg[c], u = cU[r * LDC + c] * su[c];
    h[(size_t)(row0 + r) * F + f0 + c] =
        __float2bfloat16(g / (1.0f + __expf(-g)) * u * sd[c]);
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(NT)
gmmq_down_kernel(const bf16* __restrict__ h, const int8_t* __restrict__ w2q,
                 const int* __restrict__ tile_expert,
                 const int* __restrict__ tile_valid, bf16* __restrict__ out,
                 int D, int F, int block_m, int chunks) {
  const int tile = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int row0 = tile * block_m + chunk * BM;
  const int nrows = min(BM, block_m - chunk * BM);
  const int c0 = blockIdx.y * BN;              // stored column block
  const int Dp = PACKED ? D / 2 : D;           // stored columns of w2q[e]
  if (!tile_valid[tile]) {                      // dead tile: zeros, no math
    for (int i = threadIdx.x; i < nrows * BN; i += NT) {
      bf16* o = out + (size_t)(row0 + i / BN) * D + c0 + i % BN;
      o[0] = __float2bfloat16(0.0f);
      if constexpr (PACKED) o[D / 2] = __float2bfloat16(0.0f);
    }
    return;
  }
  const int e = tile_expert[tile];
  const int warp = threadIdx.x / 32;
  const bool active = warp * 16 < nrows;
  const int8_t* W = w2q + (size_t)e * F * Dp;

  __shared__ __align__(128) unsigned char smem[(PACKED ? 2 : 1) * BM * LDC * sizeof(float)];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + BM * LDA;
  bf16* sB2 = sB + BK * LDB;

  Acc acc[BN / 16], acc2[PACKED ? BN / 16 : 1];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    wmma::fill_fragment(acc[j], 0.0f);
    if constexpr (PACKED) wmma::fill_fragment(acc2[j], 0.0f);
  }
  const bf16* hrow = h + (size_t)row0 * F;
  for (int k0 = 0; k0 < F; k0 += BK) {
    load_a(sA, hrow, F, nrows, k0);
    load_q<PACKED>(sB, sB2, W, Dp, k0, c0);
    __syncthreads();
    if (active) {
      mma_step(acc, sA, sB, warp);
      if constexpr (PACKED) mma_step(acc2, sA, sB2, warp);
    }
    __syncthreads();
  }
  float* cO = reinterpret_cast<float*>(smem);
  float* cO2 = cO + BM * LDC;
  if (active) {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wmma::store_matrix_sync(cO + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
      if constexpr (PACKED)
        wmma::store_matrix_sync(cO2 + warp * 16 * LDC + j * 16, acc2[j], LDC, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    bf16* o = out + (size_t)(row0 + r) * D + c0 + c;
    o[0] = __float2bfloat16(cO[r * LDC + c]);
    if constexpr (PACKED) o[D / 2] = __float2bfloat16(cO2[r * LDC + c]);
  }
}

template <bool PACKED>
static int launch(const void* xs, const void* w1q, const void* w2q,
                  const void* s1, const void* s2, const void* tile_expert,
                  const void* tile_valid, void* h, void* out, int M, int D,
                  int F, int block_m, cudaStream_t s) {
  const int n_tiles = M / block_m;
  const int chunks = (block_m + BM - 1) / BM;
  const int Dp = PACKED ? D / 2 : D;
  const int full = F / BN;                     // column blocks without masks
  cudaError_t err = cudaSuccess;
  if (full > 0) {
    gmmq_up_kernel<PACKED, false><<<dim3(n_tiles * chunks, full), NT, 0, s>>>(
        static_cast<const bf16*>(xs), static_cast<const int8_t*>(w1q),
        static_cast<const float*>(s1), static_cast<const float*>(s2),
        static_cast<const int*>(tile_expert),
        static_cast<const int*>(tile_valid), static_cast<bf16*>(h), D, F,
        block_m, chunks, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (F % BN) {
    gmmq_up_kernel<PACKED, true><<<dim3(n_tiles * chunks, 1), NT, 0, s>>>(
        static_cast<const bf16*>(xs), static_cast<const int8_t*>(w1q),
        static_cast<const float*>(s1), static_cast<const float*>(s2),
        static_cast<const int*>(tile_expert),
        static_cast<const int*>(tile_valid), static_cast<bf16*>(h), D, F,
        block_m, chunks, full);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 g2(n_tiles * chunks, Dp / BN);
  gmmq_down_kernel<PACKED><<<g2, NT, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const int8_t*>(w2q),
      static_cast<const int*>(tile_expert), static_cast<const int*>(tile_valid),
      static_cast<bf16*>(out), D, F, block_m, chunks);
  return (int)cudaGetLastError();
}

// xs [M, D] bf16, w1q / w2q int8 as above (packed != 0: int4), s1 [E, 2, F]
// and s2 [E, F] f32, out [M, D] bf16; tile_expert, tile_valid
// [M / block_m] int32; h [M, F] bf16 scratch.  Needs D % 64 == 0 (int4:
// (D / 2) % 64 == 0), F % 32 == 0, block_m % 8 == 0, 16-byte aligned
// bases.  Returns cudaGetLastError() after launch.
extern "C" int moe_gmm_quant_launch(const void* xs, const void* w1q,
                                    const void* w2q, const void* s1,
                                    const void* s2, const void* tile_expert,
                                    const void* tile_valid, void* h, void* out,
                                    int M, int D, int F, int block_m,
                                    int packed, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (packed)
    return launch<true>(xs, w1q, w2q, s1, s2, tile_expert, tile_valid, h,
                        out, M, D, F, block_m, s);
  return launch<false>(xs, w1q, w2q, s1, s2, tile_expert, tile_valid, h, out,
                       M, D, F, block_m, s);
}
