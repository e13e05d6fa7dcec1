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
// One more promise: a row's output is bitwise the same whatever the other
// rows of the batch are.  q, k, v and out are bf16 or, as the reference's
// kernel takes any float dtype, all f32 (hd <= 128): the same block body
// instantiated on f32 elements, f32 FFMA as in bf16, a 16-byte copy
// carrying 4 values in place of 8.
//
// What bounds it on the H100: bytes.  Two dot products per cached slot and
// head; at chip_smoke's check (8 rows over 512 slots holding 2012 live
// positions, 16 kv heads of 128) a call reads 16.5 MB of K and V, 0.0049
// ms at 3.35 TB/s.
//
// Design (split slots, "flash-decoding"), B4's (flash_decode_paged.cu)
// over a contiguous row.  The TPU walks a row's slots in order on one
// core.  Here the grid is (kv head, chunk, batch row), a chunk being
// CHUNK_SLOTS slots fixed by a constant.  A row walks n slots: none when
// cur_pos < 0, all S under a window (the ring may have wrapped), else
// min(S, cur_pos + 1) (position p lives at slot p % S, so no later slot
// holds a valid one).  Its live chunks are the first max(1, ceil(n /
// CHUNK_SLOTS)): a count that follows from cur_pos and S alone, never from
// B.  A block past them exits after its one load, cur_pos; chunk 0 of a
// row with n = 0 writes the row's zeros.  A live block issues q, every K
// and V row of its chunk (16 bytes a thread by cp.async, at
// ((b * S + slot) * Hkv + h) * hd: no table) and the chunk's positions
// before it waits on any, then runs the block body it shares with B4
// (split_decode.cuh): one max, sum and rescale per tile, in base 2; a row
// with one live chunk has that block write the output, otherwise the last
// of its blocks to arrive merges the chunks' (m, l, acc) in chunk order,
// skipping a chunk with no valid slot exactly.  Each step's order is fixed
// by the chunk index and the thread.  Head groups and head sizes are as
// B4's: a block takes G of a kv head's query heads (fd_block_group, the
// grid's x axis (kv head, sub-group)), hd 32, 64, 80 (padded to 128 in
// the block), 128 or 256.  The arrival counters are the
// buffer B4 uses (kernels/flash_decode.py::_counters): kernels on one
// stream run one after another and each leaves every counter at zero.
//
// On the H100 (NVIDIA H100 80GB HBM3, 700 W; tools/decode_attention_times
// .py, PERF.md §6), each time with the timer's 0.0054 ms floor: 0.0181 ms
// at the check against the one-block-a-row design's 0.0316 and SDPA's
// 0.0334; 0.0122 at one row of 512 positions against 0.0303.  Rows of at
// most 64 positions pay the merge: 0.0099 against 0.0094 at one row of
// 64, 0.0112 against 0.0100 at 8 rows up to 64.  What holds it: the same
// dependent loads and merge as B4, less its table read.

#include "split_decode.cuh"

#define CHUNK_SLOTS 32               // slots a block takes (one tile)

static_assert(CHUNK_SLOTS % SD_TILE == 0, "a chunk is whole tiles");

// a chunk's slots, addressed directly (split_decode.cuh)
template <int HD>
struct ContiguousChunk {
  static constexpr int PER_MASK = 16;  // chunks a merge mask covers
  static constexpr int BIT = 1;
  const int* __restrict__ pos_c;       // the position of the chunk's slot 0
  size_t row0;                         // its K / V row for this kv head
  int n_here;                          // the chunk's walked slots
  int Hkv, nlive;

  __device__ __forceinline__ int n_slots() const { return CHUNK_SLOTS; }
  __device__ __forceinline__ size_t row(int s, bool& ok) const {
    ok = s < n_here;
    return ok ? row0 + (size_t)s * Hkv * HD : 0;
  }
  __device__ __forceinline__ int pos(int s) const {
    return s < n_here ? pos_c[s] : -1;
  }
  __device__ __forceinline__ int n_units() const { return nlive; }
  // the row's live chunks are its first nlive (c0 < nlive)
  __device__ __forceinline__ unsigned live_mask(int c0, int) const {
    const int k = nlive - c0;
    return k >= PER_MASK ? (1u << PER_MASK) - 1u : (1u << k) - 1u;
  }
};

template <int G, int HD, class T>
__global__ void __launch_bounds__(SD_NT, 8)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    const int* __restrict__ cur_pos, T* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters,
                    int kv_stride, int nsub, int S, int window,
                    float scale_log2) {
  // x: (kv head, sub-group), as in flash_decode_paged.cu
  const int h = blockIdx.x / nsub, c = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int cur = cur_pos[b];
  const int n = cur < 0 ? 0 : window > 0 ? S : min(S, cur + 1);
  const int nlive = max(1, (n + CHUNK_SLOTS - 1) / CHUNK_SLOTS);
  if (c >= nlive) return;            // past the row's walk
  const size_t o_off = ((size_t)b * gridDim.x + blockIdx.x) * G * HD;
  if (n == 0) {                      // no valid slot: chunk 0 writes zeros
    sd_zeros<G, HD>(out + o_off, t);
    return;
  }
  T qv[SdShape<G, HD>::QPT];
  sd_load_q<G, HD>(q + o_off, qv, t);
  const int s0 = c * CHUNK_SLOTS;
  ContiguousChunk<HD> ch;
  ch.pos_c = pos + (size_t)b * S + s0;
  ch.row0 = (((size_t)b * S + s0) * kv_stride + h) * HD;
  ch.n_here = min(CHUNK_SLOTS, n - s0);
  ch.Hkv = kv_stride;
  ch.nlive = nlive;
  sd_chunk<G, HD>(ch, qv, k, v, cur, window, scale_log2, nlive,
                  out + o_off, part, counters);
}

template <int G, int HD, class T>
struct Launch {
  static int run(dim3 grid, cudaStream_t s, const void* q, const void* k,
                 const void* v, const void* pos, const void* cur_pos,
                 void* out, void* part, void* counters, int kv_stride,
                 int nsub, int S, int window, float scale_log2) {
    // registers and the static shared memory hold G heads at sd_pad(HD)
    if constexpr (G * sd_pad(HD) / 32 <= FD_GROUP_CAP && sd_fits<T, HD>()) {
      flash_decode_kernel<G, HD, T><<<grid, SD_NT, 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(pos),
          static_cast<const int*>(cur_pos), static_cast<T*>(out),
          static_cast<float*>(part), static_cast<int*>(counters), kv_stride,
          nsub, S, window, scale_log2);
      return 0;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
};

// part: scratch of B * Hkv * n_chunks * (Hq / Hkv) * (hd + 2) floats;
// counters: B * Hq int32, zero before the first call (each call leaves
// them zero); n_chunks = ceil(S / CHUNK_SLOTS).  Returns
// cudaGetLastError() after launch (cudaErrorInvalidValue for a head size
// without an instantiation, or another n_chunks).  window <= 0: none.
// kv_stride: the kv heads a slot holds in memory (>= Hkv); k and v are
// then heads [0, Hkv) at their base pointers, a head slice of a cache of
// kv_stride heads.  f32: q, k, v and out are f32 (hd <= 128), else bf16.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pos,
                                   const void* cur_pos, void* out,
                                   void* part, void* counters, int B, int Hq,
                                   int Hkv, int hd, int S, int window,
                                   int n_chunks, int kv_stride, int f32,
                                   void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || !fd_head_size(hd) || S <= 0 ||
      (f32 && !fd_head_size_f32(hd)) ||
      kv_stride < Hkv || n_chunks != (S + CHUNK_SLOTS - 1) / CHUNK_SLOTS)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = PD_LOG2E / sqrtf((float)hd);
  const int g = Hq / Hkv, G = fd_block_group(g, sd_pad(hd));
  const int err = fd_dispatch<Launch>(
      f32, G, hd, dim3(Hkv * (g / G), n_chunks, B),
      reinterpret_cast<cudaStream_t>(stream), q, k, v, pos, cur_pos, out,
      part, counters, kv_stride, g / G, S, window, scale_log2);
  if (err) return err;
  return (int)cudaGetLastError();
}
