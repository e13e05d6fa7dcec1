// Device code of the one-token decode attention kernel over a contiguous
// cache (flash_decode.cu); the paged kernel (flash_decode_paged.cu) shares
// only fd_dispatch and the bf16 type.
//
// flash_decode runs one CUDA block of FD_NT threads per (batch row, kv
// head).  The block's warps split the cached slots between them; each warp
// keeps its own online-softmax state (m, l, acc) in registers -- lane i
// holds head dimensions i, i + 32, ... for every query head of the group --
// and folds in the slots it reads with no barrier.  At the end the warps'
// partial states meet in shared memory and are merged with the usual
// rescaling (m* = max m_w, l* = sum l_w e^(m_w - m*), acc* likewise).
// Masked slots are never folded in, so a query with no valid slot keeps
// l = 0, acc = 0 and returns 0.  G (query heads per kv head) and DPL =
// hd / 32 are template parameters, G * DPL <= 16.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define FD_NT 256
#define FD_NW (FD_NT / 32)
#define FD_SLOTS 4          // slots whose K/V rows a warp loads at once
#define FD_NEG_INF -1e30f

template <int G, int DPL>
struct WarpSoftmax {
  static constexpr int HD = 32 * DPL;
  float qv[G][DPL], acc[G][DPL], m[G], l[G];

  // q_group: the G query rows of this kv head, HD apart.
  __device__ __forceinline__ void init(const bf16* __restrict__ q_group,
                                       int lane, float scale) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        qv[gi][i] = __bfloat162float(q_group[gi * HD + lane + 32 * i]) * scale;
        acc[gi][i] = 0.f;
      }
      m[gi] = FD_NEG_INF;
      l[gi] = 0.f;
    }
  }

  // Fold one valid slot (this lane's dims of its K and V rows) into the
  // state of every query head of the group.
  __device__ __forceinline__ void add(const float (&kv)[DPL],
                                      const float (&vv)[DPL]) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float sc = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) sc += qv[gi][i] * kv[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
      const float m_new = fmaxf(m[gi], sc);
      const float corr = __expf(m[gi] - m_new);
      const float pr = __expf(sc - m_new);
      l[gi] = l[gi] * corr + pr;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[gi][i] = acc[gi][i] * corr + pr * vv[i];
      m[gi] = m_new;
    }
  }

  // Load FD_SLOTS rows (row offsets in elements, this lane's dims) of K and
  // V; invalid slots read nothing and hold zeros.
  __device__ __forceinline__ void add_rows(const bf16* __restrict__ k,
                                           const bf16* __restrict__ v,
                                           const size_t (&row)[FD_SLOTS],
                                           const bool (&valid)[FD_SLOTS],
                                           int lane) {
    float kv[FD_SLOTS][DPL], vv[FD_SLOTS][DPL];
#pragma unroll
    for (int s = 0; s < FD_SLOTS; ++s) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kv[s][i] = valid[s] ? __bfloat162float(k[row[s] + lane + 32 * i]) : 0.f;
        vv[s][i] = valid[s] ? __bfloat162float(v[row[s] + lane + 32 * i]) : 0.f;
      }
    }
#pragma unroll
    for (int s = 0; s < FD_SLOTS; ++s)
      if (valid[s]) add(kv[s], vv[s]);               // uniform in the warp
  }

  // Merge the block's FD_NW warp states and write the G output rows
  // (out_group: the first of them, HD apart).  Called by every thread.
  __device__ __forceinline__ void merge_store(bf16* __restrict__ out_group,
                                              int warp, int lane) {
    __shared__ float sm_m[FD_NW][G], sm_l[FD_NW][G];
    __shared__ float sm_acc[FD_NW][G][HD];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (lane == 0) { sm_m[warp][gi] = m[gi]; sm_l[warp][gi] = l[gi]; }
#pragma unroll
      for (int i = 0; i < DPL; ++i) sm_acc[warp][gi][lane + 32 * i] = acc[gi][i];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * HD; idx += FD_NT) {
      const int gi = idx / HD, d = idx % HD;
      float mx = FD_NEG_INF;
#pragma unroll
      for (int w = 0; w < FD_NW; ++w) mx = fmaxf(mx, sm_m[w][gi]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < FD_NW; ++w) {
        const float c = __expf(sm_m[w][gi] - mx);
        L += sm_l[w][gi] * c;
        A += sm_acc[w][gi][d] * c;
      }
      out_group[gi * HD + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    }
  }
};

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
