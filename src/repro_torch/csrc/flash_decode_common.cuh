// What the decode attention launchers over K/V rows share: the element
// types (bf16 or f32: q, K, V and the output share one), how a kv head's
// query group is split over the grid, and the dispatch over the
// instantiated head groups and head sizes (flash_decode.cu over a
// contiguous cache, flash_decode_paged.cu over a paged pool; their common
// block body is split_decode.cuh).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// an element as f32, and f32 stored as an element (bf16: rounded once)
__device__ __forceinline__ float fd_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float fd_float(float v) { return v; }
__device__ __forceinline__ void fd_store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void fd_store(float* p, float v) { *p = v; }

// the head sizes with an instantiation; a block computes at sd_pad(hd)
__host__ __device__ constexpr bool fd_head_size(int hd) {
  return hd == 32 || hd == 64 || hd == 80 || hd == 128 || hd == 256;
}

// the head sizes of the f32 instantiations: a tile of 32 f32 K and V rows
// at hd 256 would overflow a block's 48 KB of static shared memory
__host__ __device__ constexpr bool fd_head_size_f32(int hd) {
  return fd_head_size(hd) && hd <= 128;
}

// a block's shared memory and registers hold G query heads at a padded
// head size HDP while G * HDP / 32 <= FD_GROUP_CAP
#define FD_GROUP_CAP 20

// The query heads a block takes (G): the largest instantiated group that
// divides the kv head's g and fits the cap at padded head size hdp.  A
// group g > G is split into g / G sub-groups along the grid's x axis, each
// block re-reading its kv head's K / V (from the L2 after the first).  A
// group that fits is never split (G == g): g in {1, 2, 4, 8} at g * hdp /
// 32 <= 16 keeps the one-block-a-group grid and its bits.
static inline int fd_block_group(int g, int hdp) {
  const int cands[5] = {8, 5, 4, 2, 1};
  for (int i = 0; i < 5; ++i)
    if (g % cands[i] == 0 && cands[i] * hdp / 32 <= FD_GROUP_CAP)
      return cands[i];
  return 1;
}

// Dispatch a kernel launcher templated on <G, HD, T> over the instantiated
// groups and head sizes; returns cudaErrorInvalidValue for one with no
// instantiation.  LAUNCH is a template struct with `template <int G, int
// HD, class T> static int run(Args...)`.
template <template <int, int, class> class LAUNCH, class T, int G,
          typename... Args>
static int fd_dispatch_hd(int hd, Args... args) {
  switch (hd) {
    case 32: return LAUNCH<G, 32, T>::run(args...);
    case 64: return LAUNCH<G, 64, T>::run(args...);
    case 80: return LAUNCH<G, 80, T>::run(args...);
    case 128: return LAUNCH<G, 128, T>::run(args...);
    case 256: return LAUNCH<G, 256, T>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <template <int, int, class> class LAUNCH, class T, typename... Args>
static int fd_dispatch_t(int g, int hd, Args... args) {
  switch (g) {
    case 1: return fd_dispatch_hd<LAUNCH, T, 1>(hd, args...);
    case 2: return fd_dispatch_hd<LAUNCH, T, 2>(hd, args...);
    case 4: return fd_dispatch_hd<LAUNCH, T, 4>(hd, args...);
    case 5: return fd_dispatch_hd<LAUNCH, T, 5>(hd, args...);
    case 8: return fd_dispatch_hd<LAUNCH, T, 8>(hd, args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ... and over the element type: f32 operands when ``f32`` is nonzero
template <template <int, int, class> class LAUNCH, typename... Args>
static int fd_dispatch(int f32, int g, int hd, Args... args) {
  return f32 ? fd_dispatch_t<LAUNCH, float>(g, hd, args...)
             : fd_dispatch_t<LAUNCH, bf16>(g, hd, args...);
}
