// moe_decode_quant: fused routed-expert SwiGLU for decode-shaped MoE
// batches, on int8- or int4-stored expert weights with in-kernel dequant.
//
// Replaces the TPU kernel
// src/repro/kernels/moe_decode.py::moe_decode_quant_pallas.  Contract
// (identical): x [B, D] bf16, idx [B, k] int32, weights [B, k] f32,
//   int8: w1q [E, D, 2F], w2q [E, F, D];
//   int4: w1q [E, D/2, 2F] packed along D (the contraction), w2q
//         [E, F, D/2] packed along D (the output), blocked halves
//         (quant_common.cuh);
//   s1 [E, 2, F] f32 (gate scales, then up scales), s2 [E, F] f32
// -> y [B, D] bf16, y[b] = sum_j weights[b, j] * (h_bj @ w2q[e]) with
// e = idx[b, j] and h_bj = silu(gate * s1[e,0]) * (up * s1[e,1]) * s2[e],
// gate / up = x[b] @ the first / next F columns of w1q[e], all in f32:
// s1 after the first product (constant along D), s2 folded into h before
// the second (it varies along the F contraction).  Only the routed
// experts' weights are read, and a slot with weight 0 adds exactly nothing
// (acc += 0 * partial), which is what route()'s k_budget relies on.
//
// What bounds it on the H100: bytes.  At B 8, k 8, D 2048, F 1024 each
// routed expert is 6.3 MB in int8 (3.1 MB in int4); reading each distinct
// routed expert once -- about 44 of 64 -- takes about 0.083 (0.041) ms at
// 3.35 TB/s.  The products are 0.2 GFLOP.
//
// Design: B3's (moe_decode.cu) two passes, with the weights read as int8
// words and the products in f32 CUDA-core FMAs on the integer values:
//   pass 1 (up), grid (B*k, ceil(F/64)): h[b, j, f0:f0+64] in f32, scales
//     applied.  The 8 warps split the stored rows of w1q[e]; half a warp
//     reads one row, each lane 4 adjacent gate and 4 up columns as one
//     32-bit word each, so a warp reads two rows at a time.  An int4 byte
//     gives two contraction rows: x[r] times its low nibble, x[r + D/2]
//     times its high one.  Partial sums meet by shuffle and in shared
//     memory.  F may be any multiple of 32: in a ragged last block the
//     lanes past F load nothing and store nothing.
//   pass 2 (down), grid (B, D/64 stored columns): y[b, cols] = sum over
//     slots j of weights[b, j] * (h[b, j] @ w2q[e_j][:, cols]); the block
//     loops over the k slots itself, so the combine needs no atomics and
//     is deterministic.  An int4 block turns 64 packed columns into output
//     columns c (low nibbles) and D/2 + c (high), reading each byte once.
// Like B3 it reads each routed expert once per (token, slot) that routed
// to it, not once per distinct expert: grouping the slots of one expert
// is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "quant_common.cuh"

typedef __nv_bfloat16 bf16;

#define NT 256          // 8 warps
#define NW (NT / 32)
#define FT 64           // f columns per pass-1 block
#define DT 64           // stored d columns per pass-2 block

template <bool PACKED>
__global__ void __launch_bounds__(NT)
decodeq_up_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w1q,
                  const float* __restrict__ s1, const float* __restrict__ s2,
                  const int* __restrict__ idx, float* __restrict__ h,
                  int D, int F, int k) {
  extern __shared__ float sm[];
  float* sx = sm;                 // [D]
  float* red = sm + D;            // [NW][2 * FT]
  const int bj = blockIdx.x;
  const int b = bj / k;
  const int e = idx[bj];
  const int f0 = blockIdx.y * FT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane / 16, c4 = 4 * (lane % 16);
  const int Dp = PACKED ? D / 2 : D;          // stored rows of w1q[e]
  for (int d = threadIdx.x; d < D; d += NT) sx[d] = __bfloat162float(x[(size_t)b * D + d]);
  __syncthreads();
  const int8_t* W = w1q + (size_t)e * Dp * 2 * F + f0 + c4;
  float g[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
  const bool live = f0 + c4 < F;           // F % 4 == 0: all 4 or none
#pragma unroll 4
  for (int r = live ? 2 * warp + half : Dp; r < Dp; r += 2 * NW) {
    const int8_t* row = W + (size_t)r * 2 * F;
    const uint32_t gw = *reinterpret_cast<const uint32_t*>(row);
    const uint32_t uw = *reinterpret_cast<const uint32_t*>(row + F);
    const float xv = sx[r];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gb = q_byte(gw, i), ub = q_byte(uw, i);
      if constexpr (PACKED) {
        const float xh = sx[r + D / 2];
        g[i] += xv * (float)q_lo(gb) + xh * (float)q_hi(gb);
        u[i] += xv * (float)q_lo(ub) + xh * (float)q_hi(ub);
      } else {
        g[i] += xv * (float)gb;
        u[i] += xv * (float)ub;
      }
    }
  }
  // lanes l and l + 16 hold the same columns of other rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    g[i] += __shfl_xor_sync(0xffffffffu, g[i], 16);
    u[i] += __shfl_xor_sync(0xffffffffu, u[i], 16);
  }
  if (half == 0) {
    float* rr = red + warp * 2 * FT;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rr[c4 + i] = g[i];
      rr[FT + c4 + i] = u[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < FT && f0 + threadIdx.x < F) {
    const int t = threadIdx.x;
    float gs = 0.f, us = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      gs += red[w * 2 * FT + t];
      us += red[w * 2 * FT + FT + t];
    }
    const float* sg = s1 + (size_t)e * 2 * F + f0;
    gs *= sg[t];
    us *= sg[F + t];
    h[(size_t)bj * F + f0 + t] =
        gs / (1.0f + __expf(-gs)) * us * s2[(size_t)e * F + f0 + t];
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(NT)
decodeq_down_kernel(const float* __restrict__ h,
                    const int8_t* __restrict__ w2q,
                    const int* __restrict__ idx,
                    const float* __restrict__ weights, bf16* __restrict__ y,
                    int D, int F, int k) {
  constexpr int NO = PACKED ? 2 * DT : DT;    // output columns per block
  extern __shared__ float sm[];
  float* sh = sm;                 // [F]
  float* red = sm + F;            // [NW][NO]
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * DT;             // stored column block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane / 16, c4 = 4 * (lane % 16);
  const int Dp = PACKED ? D / 2 : D;          // stored columns of w2q[e]
  float acc = 0.f;                // threads < NO own one output column
  for (int j = 0; j < k; ++j) {
    const int bj = b * k + j;
    for (int f = threadIdx.x; f < F; f += NT) sh[f] = h[(size_t)bj * F + f];
    __syncthreads();
    const int8_t* W = w2q + (size_t)idx[bj] * F * Dp + c0 + c4;
    float p[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int f = 2 * warp + half; f < F; f += 2 * NW) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(W + (size_t)f * Dp);
      const float hv = sh[f];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = q_byte(word, i);
        if constexpr (PACKED) {
          p[i] += hv * (float)q_lo(v);
          q[i] += hv * (float)q_hi(v);
        } else {
          p[i] += hv * (float)v;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] += __shfl_xor_sync(0xffffffffu, p[i], 16);
      if constexpr (PACKED) q[i] += __shfl_xor_sync(0xffffffffu, q[i], 16);
    }
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        red[warp * NO + c4 + i] = p[i];
        if constexpr (PACKED) red[warp * NO + DT + c4 + i] = q[i];
      }
    }
    __syncthreads();
    if (threadIdx.x < NO) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += red[w * NO + threadIdx.x];
      acc += weights[bj] * s;
    }
  }
  if (threadIdx.x < NO) {
    const int t = threadIdx.x;
    const int col = (PACKED && t >= DT) ? D / 2 + c0 + t - DT : c0 + t;
    y[(size_t)b * D + col] = __float2bfloat16(acc);
  }
}

template <bool PACKED>
static int launch(const void* x, const void* w1q, const void* w2q,
                  const void* s1, const void* s2, const void* idx,
                  const void* weights, void* h, void* y, int B, int D, int F,
                  int k, cudaStream_t s) {
  const int Dp = PACKED ? D / 2 : D;
  const int no = PACKED ? 2 * DT : DT;
  const size_t smem1 = (size_t)(D + NW * 2 * FT) * sizeof(float);
  const size_t smem2 = (size_t)(F + NW * no) * sizeof(float);
  if (smem1 > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decodeq_up_kernel<PACKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem2 > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decodeq_down_kernel<PACKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
    if (e != cudaSuccess) return (int)e;
  }
  decodeq_up_kernel<PACKED><<<dim3(B * k, (F + FT - 1) / FT), NT, smem1, s>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w1q),
      static_cast<const float*>(s1), static_cast<const float*>(s2),
      static_cast<const int*>(idx), static_cast<float*>(h), D, F, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decodeq_down_kernel<PACKED><<<dim3(B, Dp / DT), NT, smem2, s>>>(
      static_cast<const float*>(h), static_cast<const int8_t*>(w2q),
      static_cast<const int*>(idx), static_cast<const float*>(weights),
      static_cast<bf16*>(y), D, F, k);
  return (int)cudaGetLastError();
}

// x [B, D] bf16, w1q / w2q int8 as above (packed != 0: int4), s1 [E, 2, F]
// and s2 [E, F] f32, idx [B, k] int32, weights [B, k] f32, y [B, D] bf16;
// h [B, k, F] f32 scratch.  Needs D % 64 == 0 (int4: (D / 2) % 64 == 0)
// and F % 32 == 0.  Returns cudaGetLastError() after launch.
extern "C" int moe_decode_quant_launch(const void* x, const void* w1q,
                                       const void* w2q, const void* s1,
                                       const void* s2, const void* idx,
                                       const void* weights, void* h, void* y,
                                       int B, int D, int F, int k, int packed,
                                       void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (packed)
    return launch<true>(x, w1q, w2q, s1, s2, idx, weights, h, y, B, D, F, k,
                        s);
  return launch<false>(x, w1q, w2q, s1, s2, idx, weights, h, y, B, D, F, k,
                       s);
}
