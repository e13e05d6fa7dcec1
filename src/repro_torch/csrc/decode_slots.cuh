// Device and host code shared by the decode expert kernels (moe_decode.cu,
// moe_decode_quant.cu): the grouping of a decode batch's slots by expert,
// found on the device inside the launch, and the pass that combines the
// slots' f32 partials.
//
// Each kernel runs three passes over grids of (column blocks, E): the
// block of expert e finds the slots routed to e (find_slots: one warp
// scans idx with a ballot, in slot order; no host sync, no sort, no
// atomics) and streams its columns of e's weights once for all of them;
// pass 3 (decode_combine_kernel) sums y[b] = sum_j weights[b, j] *
// partial[b * k + j] in slot order.  A slot's sums are taken in the same
// order whatever other slots share its expert or its batch, so a row's
// output is bitwise the same alone or in a batch; a slot with weight 0
// adds exactly nothing (acc += 0 * partial).  Passes 2 and 3 are launched
// as programmatic dependents of the pass before (launch_pass): their
// blocks start while its last blocks run, find their slots and wait for
// its results (wait_for_previous), so the launch gaps and the earlier
// pass's last wave overlap.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// The slots (indices into idx [n_slots]) routed to expert e, in order,
// into slots[]; returns their count to every thread.
__device__ __forceinline__ int find_slots(const int* __restrict__ idx,
                                          int n_slots, int e, int* slots,
                                          int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < n_slots; base += 32) {
      const int i = base + lane;
      const bool hit = i < n_slots && idx[i] == e;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) slots[n + __popc(m & ((1u << lane) - 1))] = i;
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// Shared memory of a pass: slots [n_slots] int, then ``red_bytes`` of the
// warps' sums, then the staged operand (x rows or h rows).
__host__ __device__ constexpr size_t red_offset(int n_slots) {
  return ((size_t)n_slots * 4 + 15) / 16 * 16;
}
__host__ __device__ constexpr size_t operand_offset(int n_slots,
                                                    size_t red_bytes) {
  return red_offset(n_slots) + red_bytes;
}

// an output element: bf16 (rounded once) or f32
__device__ __forceinline__ void ds_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void ds_store(float* p, float v) { *p = v; }

// 8 bf16 (the staged values of up to 8 slots at one row) as f32.
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// the 8 slots' staged values at one row of an activation stage [rows][R]
// (bf16 or f32) as f32
__device__ __forceinline__ void staged8(const __nv_bfloat16* p,
                                        float (&f)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void staged8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// silu(g) * u; f32 activations take the precise exp, as their plain
// version does
template <class T>
__device__ __forceinline__ float swiglu(float g, float u) {
  if constexpr (sizeof(T) == 2) return g / (1.0f + __expf(-g)) * u;
  else return g / (1.0f + expf(-g)) * u;
}

// let the next kernel's blocks start; wait for the previous kernel's
// results (both nothing unless the launch made the kernels dependent)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

constexpr int COMBINE_NT = 256;

// Pass 3, grid (B, ceil(D / COMBINE_NT)):
// y[b, d] = sum_j weights[b, j] * partial[b * k + j, d], in slot order;
// y in the activations' type T (bf16 or f32).
template <class T>
__global__ void __launch_bounds__(COMBINE_NT)
decode_combine_kernel(const float* __restrict__ partial,
                      const float* __restrict__ weights, T* __restrict__ y,
                      int D, int k) {
  const int b = blockIdx.x, d = blockIdx.y * COMBINE_NT + threadIdx.x;
  wait_for_previous();                  // partial of pass 2
  if (d >= D) return;
  float acc = 0.f;
  for (int j = 0; j < k; ++j)
    acc += weights[b * k + j] * partial[(size_t)(b * k + j) * D + d];
  ds_store(y + (size_t)b * D + d, acc);
}

// Launch a pass of ``threads`` threads a block, as a programmatic
// dependent of the one before it when ``dependent``.
template <class Kernel, class... Args>
cudaError_t launch_pass(Kernel kernel, dim3 grid, int threads, size_t smem,
                        cudaStream_t s, bool dependent, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = dependent;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Pass 3 after pass 2 (partial [B * k, D] f32 -> y [B, D] bf16 or f32).
template <class T>
inline cudaError_t launch_combine(const float* partial, const float* weights,
                                  T* y, int B, int D, int k,
                                  cudaStream_t s, bool dependent) {
  return launch_pass(decode_combine_kernel<T>,
                     dim3(B, (D + COMBINE_NT - 1) / COMBINE_NT), COMBINE_NT,
                     0, s, dependent, partial, weights, y, D, k);
}
