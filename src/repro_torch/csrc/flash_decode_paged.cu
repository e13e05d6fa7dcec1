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
// split the table's pages between them (warp w takes pages w, w + 8, ...),
// each with its own online-softmax state in registers, so the pages of one
// sequence are read in parallel with no barrier in the walk; the states
// merge once at the end (flash_decode_common.cuh, shared with the
// contiguous-cache kernel flash_decode.cu).  A warp reads 4 slots' K and V
// rows before it reduces any of them, to keep several loads in flight.
// G (query heads per kv head) in {1, 2, 4, 8} and DPL = hd / 32 in
// {1, 2, 4, 8} are template parameters, G * DPL <= 16 (e.g. hd 128 with
// up to 4 query heads per kv head).

#include "flash_decode_common.cuh"

#define TRASH_PAGE 0

template <int G, int DPL>
__global__ void __launch_bounds__(FD_NT)
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
  const size_t q_off = ((size_t)b * Hkv * G + (size_t)h * G) * HD;
  const int cur = cur_pos[b];

  WarpSoftmax<G, DPL> st;
  st.init(q + q_off, lane, scale);
  for (int j = warp; j < n_blk; j += FD_NW) {
    const int page = bt[(size_t)b * bt_stride + j];
    if (page == TRASH_PAGE) continue;                  // uniform in the warp
    for (int p0 = 0; p0 < P; p0 += FD_SLOTS) {
      bool valid[FD_SLOTS];
      size_t row[FD_SLOTS];
#pragma unroll
      for (int s = 0; s < FD_SLOTS; ++s) {
        const int p = p0 + s;
        valid[s] = false;
        if (p < P) {
          const int pos = posp[(size_t)page * P + p];
          valid[s] = pos >= 0 && pos <= cur &&
                     (window <= 0 || pos > cur - window);
        }
        row[s] = (((size_t)page * P + min(p, P - 1)) * Hkv + h) * HD;
      }
      st.add_rows(kp, vp, row, valid, lane);
    }
  }
  st.merge_store(out + q_off, warp, lane);
}

template <int G, int DPL>
struct Launch {
  static int run(dim3 grid, cudaStream_t s, const void* q, const void* kp,
                 const void* vp, const void* posp, const void* bt,
                 int bt_stride, const void* cur_pos, void* out, int Hkv,
                 int P, int n_blk, int window, float scale) {
    // registers and the static shared memory hold G * DPL <= 16
    if constexpr (G * DPL <= 16) {
      flash_decode_paged_kernel<G, DPL><<<grid, FD_NT, 0, s>>>(
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
};

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
  const float scale = 1.0f / sqrtf((float)hd);
  const int err = fd_dispatch<Launch>(
      Hq / Hkv, hd / 32, dim3(B, Hkv), reinterpret_cast<cudaStream_t>(stream),
      q, kp, vp, posp, bt, bt_stride, cur_pos, out, Hkv, P, n_blk, window,
      scale);
  if (err) return err;
  return (int)cudaGetLastError();
}
