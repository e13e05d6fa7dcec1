// flash_decode: one-token GQA decode attention over a contiguous cache.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_pallas.  Contract: q [B, Hq, hd]; k, v [B, S, Hkv, hd];
// pos [B, S] int32 (the absolute position held in each slot, -1 = empty);
// cur_pos [B] int32 -> out [B, Hq, hd].  q head h uses kv head
// h / (Hq / Hkv).  A slot counts iff 0 <= pos <= cur_pos (and
// pos > cur_pos - window when a window is set).  A query with no valid slot
// (an idle batch row) gets zeros; the TPU kernel returns the mean of V
// there (a uniform softmax over -1e30 scores).  Neither value is ever read.
//
// What bounds it on the H100: bytes.  Two dot products per cached slot and
// head; at B 8, 16 kv heads, hd 128 and 512 live slots a call reads
// 33.6 MB of K and V, about 0.01 ms at 3.35 TB/s.
//
// Design.  One CUDA block per (batch row, kv head), addressing the slots
// directly (the paged kernel, flash_decode_paged.cu, splits a row's pages
// over blocks instead); the block's 8 warps take runs of 4 slots in turn
// (warp w reads slots 4w .. 4w + 3, then 4w + 32 ...), each keeping its
// own online-softmax state in registers, and merge once at the end
// (flash_decode_common.cuh).
// Without a window a slot's index is pos % S with every pos < S, so no
// slot past cur_pos can hold a valid position and the walk stops at
// cur_pos + 1 slots; with a window the ring may have wrapped and the walk
// covers all S slots.

#include "flash_decode_common.cuh"

template <int G, int DPL>
__global__ void __launch_bounds__(FD_NT)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ pos,
                    const int* __restrict__ cur_pos, bf16* __restrict__ out,
                    int Hkv, int S, int window, float scale) {
  constexpr int HD = 32 * DPL;
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_off = ((size_t)b * Hkv * G + (size_t)h * G) * HD;
  const int cur = cur_pos[b];
  const int n = window > 0 ? S : min(S, cur + 1);   // cur < 0: no walk

  WarpSoftmax<G, DPL> st;
  st.init(q + q_off, lane, scale);
  for (int s0 = warp * FD_SLOTS; s0 < n; s0 += FD_NW * FD_SLOTS) {
    bool valid[FD_SLOTS];
    size_t row[FD_SLOTS];
#pragma unroll
    for (int s = 0; s < FD_SLOTS; ++s) {
      const int slot = s0 + s;
      valid[s] = false;
      if (slot < n) {
        const int p = pos[(size_t)b * S + slot];
        valid[s] = p >= 0 && p <= cur && (window <= 0 || p > cur - window);
      }
      row[s] = (((size_t)b * S + min(slot, n - 1)) * Hkv + h) * HD;
    }
    st.add_rows(k, v, row, valid, lane);
  }
  st.merge_store(out + q_off, warp, lane);
}

template <int G, int DPL>
struct Launch {
  static int run(dim3 grid, cudaStream_t s, const void* q, const void* k,
                 const void* v, const void* pos, const void* cur_pos,
                 void* out, int Hkv, int S, int window, float scale) {
    // registers and the static shared memory hold G * DPL <= 16
    if constexpr (G * DPL <= 16) {
      flash_decode_kernel<G, DPL><<<grid, FD_NT, 0, s>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const int*>(pos),
          static_cast<const int*>(cur_pos), static_cast<bf16*>(out), Hkv, S,
          window, scale);
      return 0;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
};

// Returns cudaGetLastError() after launch (cudaErrorInvalidValue for a
// head group or head size without an instantiation).  window <= 0: none.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pos,
                                   const void* cur_pos, void* out, int B,
                                   int Hq, int Hkv, int hd, int S, int window,
                                   void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || hd % 32 != 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)hd);
  const int err = fd_dispatch<Launch>(
      Hq / Hkv, hd / 32, dim3(B, Hkv), reinterpret_cast<cudaStream_t>(stream),
      q, k, v, pos, cur_pos, out, Hkv, S, window, scale);
  if (err) return err;
  return (int)cudaGetLastError();
}
