// Device code shared by the paged decode attention kernels
// (flash_decode_paged.cu, GQA over K/V pages; flash_decode_paged_mla.cu,
// MLA over latent pages): asynchronous copies into shared memory, the
// base-2 exponential both softmaxes run in, and bf16 unpacking.
//
// Both walk a row's block table in pieces fixed by constants -- never by
// the batch size or the table's width -- and merge the pieces' softmax
// states in a fixed order inside the same launch, so a row's output is
// bitwise the same whatever the other rows of the batch are and whatever
// the table view's width.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define TRASH_PAGE 0
#define PD_NEG_INF -1e30f
#define PD_LOG2E 1.4426950408889634f

__device__ __forceinline__ uint32_t pd_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously (L2 only); zero-filled and
// nothing read when !valid
__device__ __forceinline__ void pd_cp_async16(void* dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(pd_smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void pd_cp_async4(void* dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(pd_smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void pd_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void pd_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2^x; exactly 1 at x = 0 and 0 far below, as the merges rely on
__device__ __forceinline__ float pd_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 8 bf16 packed in a uint4 -> 8 floats (exact)
__device__ __forceinline__ void pd_unpack8(const uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
