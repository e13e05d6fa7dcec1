// moe_decode: fused routed-expert SwiGLU for decode-shaped MoE batches.
//
// Replaces the TPU kernel src/repro/kernels/moe_decode.py::moe_decode_pallas.
// Contract (identical): x [B, D], w1 [E, D, 2F] (gate = first F columns,
// up = next F), w2 [E, F, D], idx [B, k] int32, weights [B, k] f32 ->
// y [B, D] with y[b] = sum_j weights[b, j] * SwiGLU(x[b]; expert idx[b, j]),
// accumulated in f32.  Only the routed experts' weights are read, and a
// slot with weight 0 adds exactly nothing (acc += 0 * partial), which is
// what route()'s k_budget relies on.
//
// What bounds it on the H100: bytes.  At B 8, k 8, D 2048, F 1024 the work
// is 0.2 GFLOP against 12.6 MB of weights per routed (token, slot); even the
// least traffic -- each distinct routed expert read once, about 41 of 64
// experts, 0.5 GB -- takes about 0.15 ms at 3.35 TB/s.
//
// Design.  The TPU grid (B, k, F/bf) runs in order and carries one
// accumulator per token across slots and F steps.  CUDA blocks run in
// parallel, so each block owns its output instead, in two passes:
//   pass 1 (decode_up), grid (B*k, ceil(F/64)): h[b, j, f0:f0+64] =
//     silu(x[b] . w1[e][:, f]) * (x[b] . w1[e][:, F + f]) in f32; the 8 warps
//     split D, each lane reads two adjacent gate and up columns (bf16x2), so
//     a warp reads 128 contiguous bytes per row; partial sums meet in
//     shared memory.  F may be any multiple of 32 (an intra-pruned
//     DeepSeek-V2-Lite expert has F = 1056): in a ragged last block the
//     lanes past F load nothing and store nothing.
//   pass 2 (decode_down), grid (B, D/64): y[b, d0:d0+64] = sum over slots j
//     of weights[b, j] * (h[b, j] . w2[e_j][:, d]); the block loops over
//     the k slots itself, so the combine needs no atomics and is
//     deterministic.  k is a runtime argument.
// This simple design reads each routed expert once per (token, slot) that
// routed to it (64 x 12.6 MB at B 8, k 8), not once per distinct expert:
// grouping the slots of one expert is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define NT 256          // 8 warps
#define NW (NT / 32)
#define FT 64           // f columns per pass-1 block
#define DT 64           // d columns per pass-2 block

__global__ void __launch_bounds__(NT)
decode_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
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
  for (int d = threadIdx.x; d < D; d += NT) sx[d] = __bfloat162float(x[(size_t)b * D + d]);
  __syncthreads();
  const bf16* W = w1 + (size_t)e * D * 2 * F + f0 + 2 * lane;
  float g0 = 0.f, g1 = 0.f, u0 = 0.f, u1 = 0.f;
  const bool live = f0 + 2 * lane < F;     // F even: both columns or none
#pragma unroll 4
  for (int d = live ? warp : D; d < D; d += NW) {
    const bf16* row = W + (size_t)d * 2 * F;
    const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row));
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + F));
    const float xv = sx[d];
    g0 += xv * g.x; g1 += xv * g.y;
    u0 += xv * u.x; u1 += xv * u.y;
  }
  float* r = red + warp * 2 * FT;
  r[2 * lane] = g0; r[2 * lane + 1] = g1;
  r[FT + 2 * lane] = u0; r[FT + 2 * lane + 1] = u1;
  __syncthreads();
  if (threadIdx.x < FT && f0 + threadIdx.x < F) {
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      g += red[w * 2 * FT + threadIdx.x];
      u += red[w * 2 * FT + FT + threadIdx.x];
    }
    h[(size_t)bj * F + f0 + threadIdx.x] = g / (1.0f + __expf(-g)) * u;
  }
}

__global__ void __launch_bounds__(NT)
decode_down_kernel(const float* __restrict__ h, const bf16* __restrict__ w2,
                   const int* __restrict__ idx,
                   const float* __restrict__ weights, bf16* __restrict__ y,
                   int D, int F, int k) {
  extern __shared__ float sm[];
  float* sh = sm;                 // [F]
  float* red = sm + F;            // [NW][DT]
  const int b = blockIdx.x;
  const int d0 = blockIdx.y * DT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc = 0.f;                // threads < DT own column d0 + threadIdx.x
  for (int j = 0; j < k; ++j) {
    const int bj = b * k + j;
    for (int f = threadIdx.x; f < F; f += NT) sh[f] = h[(size_t)bj * F + f];
    __syncthreads();
    const bf16* W = w2 + (size_t)idx[bj] * F * D + d0 + 2 * lane;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll 4
    for (int f = warp; f < F; f += NW) {
      const float2 w = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(W + (size_t)f * D));
      p0 += sh[f] * w.x;
      p1 += sh[f] * w.y;
    }
    red[warp * DT + 2 * lane] = p0;
    red[warp * DT + 2 * lane + 1] = p1;
    __syncthreads();
    if (threadIdx.x < DT) {
      float p = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) p += red[w * DT + threadIdx.x];
      acc += weights[bj] * p;
    }
  }
  if (threadIdx.x < DT) y[(size_t)b * D + d0 + threadIdx.x] = __float2bfloat16(acc);
}

// x [B, D], w1 [E, D, 2F], w2 [E, F, D], y [B, D] bf16; idx [B, k] int32;
// weights [B, k] f32; h [B, k, F] f32 scratch.  Needs D % 64 == 0 and
// F % 32 == 0.  Returns cudaGetLastError() after launch.
extern "C" int moe_decode_launch(const void* x, const void* w1, const void* w2,
                                 const void* idx, const void* weights, void* h,
                                 void* y, int B, int D, int F, int k,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem1 = (size_t)(D + NW * 2 * FT) * sizeof(float);
  const size_t smem2 = (size_t)(F + NW * DT) * sizeof(float);
  if (smem1 > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_up_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem2 > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_down_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
    if (e != cudaSuccess) return (int)e;
  }
  decode_up_kernel<<<dim3(B * k, (F + FT - 1) / FT), NT, smem1, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const int*>(idx), static_cast<float*>(h), D, F, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_down_kernel<<<dim3(B, D / DT), NT, smem2, s>>>(
      static_cast<const float*>(h), static_cast<const bf16*>(w2),
      static_cast<const int*>(idx), static_cast<const float*>(weights),
      static_cast<bf16*>(y), D, F, k);
  return (int)cudaGetLastError();
}
