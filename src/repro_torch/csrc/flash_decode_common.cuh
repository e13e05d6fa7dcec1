// What the decode attention launchers over K/V rows share: the bf16 type
// and the dispatch over the instantiated head groups and head sizes
// (flash_decode.cu over a contiguous cache, flash_decode_paged.cu over a
// paged pool; their common block body is split_decode.cuh).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Dispatch a kernel launcher templated on <G, DPL> over the instantiated
// head groups; returns cudaErrorInvalidValue for one with no instantiation.
// LAUNCH is a template struct with `template <int G, int DPL> static int
// run(Args...)`.
template <template <int, int> class LAUNCH, int G, typename... Args>
static int fd_dispatch_dpl(int dpl, Args... args) {
  switch (dpl) {
    case 1: return LAUNCH<G, 1>::run(args...);
    case 2: return LAUNCH<G, 2>::run(args...);
    case 4: return LAUNCH<G, 4>::run(args...);
    case 8: return LAUNCH<G, 8>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <template <int, int> class LAUNCH, typename... Args>
static int fd_dispatch(int g, int dpl, Args... args) {
  switch (g) {
    case 1: return fd_dispatch_dpl<LAUNCH, 1>(dpl, args...);
    case 2: return fd_dispatch_dpl<LAUNCH, 2>(dpl, args...);
    case 4: return fd_dispatch_dpl<LAUNCH, 4>(dpl, args...);
    case 8: return fd_dispatch_dpl<LAUNCH, 8>(dpl, args...);
    default: return (int)cudaErrorInvalidValue;
  }
}
