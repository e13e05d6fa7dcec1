// flash_decode_paged: one-token GQA decode attention over a paged KV pool.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_decode_paged.py::flash_decode_paged_pallas.
// Contract (identical): q [B, Hq, hd]; kp, vp [N, P, Hkv, hd]; posp [N, P]
// int32; block_tables [B, n_blk] int32 (row pitch bt_stride, so a truncated
// view table[:, :n_live] needs no copy); cur_pos [B] int32 -> out
// [B, Hq, hd].  q head h uses kv head h / (Hq / Hkv).  A slot counts iff
// 0 <= posp <= cur_pos (and posp > cur_pos - window when a window is set);
// table entries equal to the trash page 0 are skipped.  A query with no
// valid slot at all (an idle batch row) gets zeros: finite, never read.
//
// What bounds it on the H100: bytes.  The work is two dot products per
// cached position and head; at B 8, 16 kv heads, hd 128 and 512 live
// positions a call reads 33.6 MB of K and V, about 0.01 ms at 3.35 TB/s.
//
// Design.  One CUDA block per (batch row, kv head), as the TPU grid's
// first two axes.  The TPU walks the table in order, carrying the online
// softmax state (m, l, acc) across grid steps; here the block's 8 warps
// split the table's pages between them (warp w takes pages w, w + 8, ...)
// and each keeps its own (m, l, acc) in registers -- lane i holds head
// dimensions i, i + 32, ... for every query head of the group -- so the
// pages of one sequence are read in parallel with no barrier in the walk.
// A warp reads 4 slots' K and V rows before it reduces any of them, to
// keep several loads in flight.  At the end the 8 partial states meet in
// shared memory and are merged with the usual rescaling
// (m* = max m_w, l* = sum l_w e^(m_w - m*), acc* likewise).  Masked slots
// are skipped, so a fully masked row keeps l = 0, acc = 0 and returns 0.
// The group width G (query heads per kv head) and the dims per lane
// DPL = hd / 32 are template parameters: G in {1, 2, 4, 8}, DPL in
// {1, 2, 4, 8}, G * DPL <= 16 (e.g. hd 128 with up to 4 query heads per
// kv head).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define NT 256
#define NW (NT / 32)
#define SLOTS 4          // slots whose K/V rows a warp loads at once
#define NEG_INF -1e30f
#define TRASH_PAGE 0

template <int G, int DPL>
__global__ void __launch_bounds__(NT)
flash_decode_paged_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ kp,
                          const bf16* __restrict__ vp,
                          const int* __restrict__ posp,
                          const int* __restrict__ bt, int bt_stride,
                          const int* __restrict__ cur_pos,
                          bf16* __restrict__ out, int Hkv, int P, int n_blk,
                          int window, float scale) {
  constexpr int HD = 32 * DPL;
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Hq = Hkv * G;
  const int cur = cur_pos[b];

  float qv[G][DPL], acc[G][DPL], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const bf16* qrow = q + ((size_t)b * Hq + (size_t)h * G + gi) * HD;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qv[gi][i] = __bfloat162float(qrow[lane + 32 * i]) * scale;
      acc[gi][i] = 0.f;
    }
    m[gi] = NEG_INF;
    l[gi] = 0.f;
  }

  for (int j = warp; j < n_blk; j += NW) {
    const int page = bt[(size_t)b * bt_stride + j];
    if (page == TRASH_PAGE) continue;                  // uniform in the warp
    for (int p0 = 0; p0 < P; p0 += SLOTS) {
      bool valid[SLOTS];
      float kv[SLOTS][DPL], vv[SLOTS][DPL];
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int p = p0 + s;
        valid[s] = false;
        if (p < P) {
          const int pos = posp[(size_t)page * P + p];
          valid[s] = pos >= 0 && pos <= cur &&
                     (window <= 0 || pos > cur - window);
        }
        const size_t row = (((size_t)page * P + min(p, P - 1)) * Hkv + h) * HD;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          kv[s][i] = valid[s] ? __bfloat162float(kp[row + lane + 32 * i]) : 0.f;
          vv[s][i] = valid[s] ? __bfloat162float(vp[row + lane + 32 * i]) : 0.f;
        }
      }
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if (!valid[s]) continue;                       // uniform in the warp
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float sc = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) sc += qv[gi][i] * kv[s][i];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
          const float m_new = fmaxf(m[gi], sc);
          const float corr = __expf(m[gi] - m_new);
          const float pr = __expf(sc - m_new);
          l[gi] = l[gi] * corr + pr;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[gi][i] = acc[gi][i] * corr + pr * vv[s][i];
          m[gi] = m_new;
        }
      }
    }
  }

  // merge the warps' partial states
  __shared__ float sm_m[NW][G], sm_l[NW][G];
  __shared__ float sm_acc[NW][G][HD];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) { sm_m[warp][gi] = m[gi]; sm_l[warp][gi] = l[gi]; }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][gi][lane + 32 * i] = acc[gi][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += NT) {
    const int gi = idx / HD, d = idx % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = __expf(sm_m[w][gi] - mx);
      L += sm_l[w][gi] * c;
      A += sm_acc[w][gi][d] * c;
    }
    out[((size_t)b * Hq + (size_t)h * G + gi) * HD + d] =
        __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
}

template <int G, int DPL>
static int launch(dim3 grid, cudaStream_t s, const void* q, const void* kp,
                  const void* vp, const void* posp, const void* bt,
                  int bt_stride, const void* cur_pos, void* out, int Hkv,
                  int P, int n_blk, int window, float scale) {
  // registers and the 48 KB of static shared memory hold G * DPL <= 16
  if constexpr (G * DPL <= 16) {
    flash_decode_paged_kernel<G, DPL><<<grid, NT, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
        static_cast<const bf16*>(vp), static_cast<const int*>(posp),
        static_cast<const int*>(bt), bt_stride,
        static_cast<const int*>(cur_pos), static_cast<bf16*>(out), Hkv, P,
        n_blk, window, scale);
    return 0;
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

template <int G>
static int launch_g(int dpl, dim3 grid, cudaStream_t s, const void* q,
                    const void* kp, const void* vp, const void* posp,
                    const void* bt, int bt_stride, const void* cur_pos,
                    void* out, int Hkv, int P, int n_blk, int window,
                    float scale) {
  switch (dpl) {
    case 1: return launch<G, 1>(grid, s, q, kp, vp, posp, bt, bt_stride, cur_pos, out, Hkv, P, n_blk, window, scale);
    case 2: return launch<G, 2>(grid, s, q, kp, vp, posp, bt, bt_stride, cur_pos, out, Hkv, P, n_blk, window, scale);
    case 4: return launch<G, 4>(grid, s, q, kp, vp, posp, bt, bt_stride, cur_pos, out, Hkv, P, n_blk, window, scale);
    case 8: return launch<G, 8>(grid, s, q, kp, vp, posp, bt, bt_stride, cur_pos, out, Hkv, P, n_blk, window, scale);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Returns cudaGetLastError() after launch (cudaErrorInvalidValue for a
// head group or head size without an instantiation).  window <= 0: none.
extern "C" int flash_decode_paged_launch(const void* q, const void* kp,
                                         const void* vp, const void* posp,
                                         const void* bt, const void* cur_pos,
                                         void* out, int B, int Hq, int Hkv,
                                         int hd, int P, int n_blk,
                                         int bt_stride, int window,
                                         void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || hd % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int g = Hq / Hkv, dpl = hd / 32;
  const float scale = 1.0f / sqrtf((float)hd);
  const dim3 grid(B, Hkv);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int err;
  switch (g) {
    case 1: err = launch_g<1>(dpl, grid, s, q, kp, vp, posp, bt, bt_stride, cur_pos, out, Hkv, P, n_blk, window, scale); break;
    case 2: err = launch_g<2>(dpl, grid, s, q, kp, vp, posp, bt, bt_stride, cur_pos, out, Hkv, P, n_blk, window, scale); break;
    case 4: err = launch_g<4>(dpl, grid, s, q, kp, vp, posp, bt, bt_stride, cur_pos, out, Hkv, P, n_blk, window, scale); break;
    case 8: err = launch_g<8>(dpl, grid, s, q, kp, vp, posp, bt, bt_stride, cur_pos, out, Hkv, P, n_blk, window, scale); break;
    default: err = (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
