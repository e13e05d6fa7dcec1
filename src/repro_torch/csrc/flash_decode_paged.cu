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
// One more promise: a row's output is bitwise the same whatever the other
// rows of the batch are and whatever the table view's width n_blk.  q, kp,
// vp and out are bf16 or, as the reference's kernel takes any float
// dtype, all f32 (hd <= 128; the block body on f32 elements).
//
// What bounds it on the H100: bytes.  The work is two dot products per
// cached position and head; at B 8, 16 kv heads, hd 128 and 2012 live
// positions on 127 pages of 16 a call reads 16.6 MB of K and V, about
// 0.005 ms at 3.35 TB/s.
//
// Design (split pages, "flash-decoding").  The TPU walks a row's table in
// order on one core.  Here the grid is (kv head, chunk, batch row), a chunk
// being CHUNK_PAGES table columns fixed by a constant, so the blocks in
// flight follow the live pages (127 pages make 64 live chunks a kv head at
// the check, 16 at one row of 512 positions) and a row's split never
// depends on B or n_blk.  A block reads the row's table once (one load a
// lane), counting the row's live chunks; a block whose columns are all
// trash exits there.  A live block walks its chunk and merges through
// the block body it shares with flash_decode.cu (split_decode.cuh): every
// K and V row of the chunk and the slots' positions in flight before any
// is used, one max, sum and rescale per tile, and, for a row with several
// live chunks, a merge of their (m, l, acc) in chunk order by the last of
// its blocks to arrive (an arrival counter in a persistent buffer, reset
// by that block), skipping a chunk with no valid slot exactly.  Each
// step's order is fixed by the chunk index and the thread, so the output
// depends only on the row's own table columns.  Any head group runs: a
// block takes G of a kv head's g query heads (fd_block_group: G = g
// where g is in {1, 2, 4, 8} and fits the block, else the largest of
// {8, 5, 4, 2, 1} that divides g and fits, the g / G sub-groups then
// spread along the grid's x axis, each re-reading the kv head's pages
// from the L2); hd in {32, 64, 80, 128, 256} (80 padded to 128 inside
// the block).
//
// On the H100 at the check (8 rows, 127 pages) a call takes about 0.019 ms
// against the one-block-a-row design's 0.033, and 0.012 at one row of 512
// positions against 0.031.  What holds it there: a block's chain of
// dependent loads (table, then K and V) and its merge protocol, times the
// two waves of blocks the grid needs at 8 rows.  Chunks of 4 columns were
// no faster at the check and slower at one row; a persistent grid walking
// units with the next unit's loads in flight, and clusters merging
// through distributed shared memory, were slower (PERF.md).

#include "split_decode.cuh"

#define CHUNK_PAGES 2                // table columns a block takes (divides 32)

// bit i of the result (i a multiple of CHUNK_PAGES): the chunk that starts
// at column base + i holds a page, given bit j of m = column base + j does
__device__ __forceinline__ unsigned chunk_bits(unsigned m) {
#pragma unroll
  for (int s = 1; s < CHUNK_PAGES; s <<= 1) m |= m >> s;
  unsigned keep = 0;
#pragma unroll
  for (int i = 0; i < 32; i += CHUNK_PAGES) keep |= 1u << i;
  return m & keep;
}

// the live-chunk bits of the 32 table columns from ``base`` (every lane of
// the calling warp gets them)
__device__ __forceinline__ unsigned live_chunks(const int* __restrict__ row_bt,
                                                int base, int n_blk,
                                                int lane) {
  const int j = base + lane;
  const bool live = j < n_blk && row_bt[j] != TRASH_PAGE;
  return chunk_bits(__ballot_sync(0xffffffffu, live));
}

// a chunk's slots through its CHUNK_PAGES table pages (split_decode.cuh)
template <int HD>
struct PagedChunk {
  static constexpr int PER_MASK = 32 / CHUNK_PAGES;   // a ballot's chunks
  static constexpr int BIT = CHUNK_PAGES;
  int pages[CHUNK_PAGES];
  const int* __restrict__ posp;
  const int* __restrict__ row_bt;
  int P, Hkv, h, n_blk;

  __device__ __forceinline__ int n_slots() const { return CHUNK_PAGES * P; }
  __device__ __forceinline__ int page_of(int slot) const {
    const int col = slot / P;
    int page = TRASH_PAGE;
#pragma unroll
    for (int k = 0; k < CHUNK_PAGES; ++k)
      if (col == k) page = pages[k];
    return page;
  }
  __device__ __forceinline__ size_t row(int slot, bool& ok) const {
    const int page = page_of(slot);
    ok = slot < n_slots() && page != TRASH_PAGE;
    return ok ? (((size_t)page * P + slot % P) * Hkv + h) * HD : 0;
  }
  __device__ __forceinline__ int pos(int slot) const {
    const int page = page_of(slot);
    const bool ok = slot < n_slots() && page != TRASH_PAGE;
    return ok ? posp[(size_t)page * P + slot % P] : -1;
  }
  __device__ __forceinline__ int n_units() const {
    return (n_blk + CHUNK_PAGES - 1) / CHUNK_PAGES;
  }
  __device__ __forceinline__ unsigned live_mask(int c0, int lane) const {
    return live_chunks(row_bt, c0 * CHUNK_PAGES, n_blk, lane);
  }
};

template <int G, int HD, class T>
__global__ void __launch_bounds__(SD_NT, 8)
flash_decode_paged_kernel(const T* __restrict__ q,
                          const T* __restrict__ kp,
                          const T* __restrict__ vp,
                          const int* __restrict__ posp,
                          const int* __restrict__ bt, int bt_stride,
                          const int* __restrict__ cur_pos,
                          T* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ counters, int kv_stride,
                          int nsub, int P, int n_blk, int window,
                          float scale_log2) {
  // x: (kv head, sub-group); the block's G query heads are q's heads
  // blockIdx.x * G .. + G - 1, and kv head h's K / V rows serve them
  const int h = blockIdx.x / nsub, c = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t % 32;
  const size_t o_off = ((size_t)b * gridDim.x + blockIdx.x) * G * HD;

  // loads that need no table entry go first, to overlap the table's
  const int cur = cur_pos[b];
  T qv[SdShape<G, HD>::QPT];
  sd_load_q<G, HD>(q + o_off, qv, t);

  // the row's table, 32 columns a pass (one load a lane): the block's own
  // pages, and how many chunks of the row hold a page (every warp alike)
  PagedChunk<HD> ch;
  ch.posp = posp;
  ch.row_bt = bt + (size_t)b * bt_stride;
  ch.P = P;
  ch.Hkv = kv_stride;
  ch.h = h;
  ch.n_blk = n_blk;
#pragma unroll
  for (int i = 0; i < CHUNK_PAGES; ++i) ch.pages[i] = TRASH_PAGE;
  int nlive = 0;
  for (int base = 0; base < n_blk; base += 32) {
    const int j = base + lane;
    const int page = j < n_blk ? ch.row_bt[j] : TRASH_PAGE;
    nlive += __popc(chunk_bits(__ballot_sync(0xffffffffu, page != TRASH_PAGE)));
#pragma unroll
    for (int i = 0; i < CHUNK_PAGES; ++i) {
      const int col = c * CHUNK_PAGES + i - base;   // the same in every lane
      const int got = __shfl_sync(0xffffffffu, page, col & 31);
      if (col >= 0 && col < 32) ch.pages[i] = got;
    }
  }
  bool any = false;
#pragma unroll
  for (int i = 0; i < CHUNK_PAGES; ++i) any |= ch.pages[i] != TRASH_PAGE;
  if (!any) {                        // a dead chunk; chunk 0 of an idle
    if (nlive == 0 && c == 0)        // row writes its zeros
      sd_zeros<G, HD>(out + o_off, t);
    return;
  }
  sd_chunk<G, HD>(ch, qv, kp, vp, cur, window, scale_log2, nlive,
                  out + o_off, part, counters);
}

template <int G, int HD, class T>
struct Launch {
  static int run(dim3 grid, cudaStream_t s, const void* q, const void* kp,
                 const void* vp, const void* posp, const void* bt,
                 int bt_stride, const void* cur_pos, void* out, void* part,
                 void* counters, int kv_stride, int nsub, int P, int n_blk,
                 int window, float scale_log2) {
    if constexpr (G * sd_pad(HD) / 32 <= FD_GROUP_CAP && sd_fits<T, HD>()) {
      flash_decode_paged_kernel<G, HD, T><<<grid, SD_NT, 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), static_cast<const int*>(posp),
          static_cast<const int*>(bt), bt_stride,
          static_cast<const int*>(cur_pos), static_cast<T*>(out),
          static_cast<float*>(part), static_cast<int*>(counters), kv_stride,
          nsub, P, n_blk, window, scale_log2);
      return 0;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
};

// part: scratch of B * Hkv * n_chunks * (Hq / Hkv) * (hd + 2) floats;
// counters: B * Hq int32, zero before the first call (each call leaves
// them zero); n_chunks = ceil(n_blk / CHUNK_PAGES), at least 1.  Returns
// cudaGetLastError() after launch (cudaErrorInvalidValue for a head size
// without an instantiation, or another n_chunks).  window <= 0: none.
// kv_stride: the kv heads a pool slot holds in memory (>= Hkv); kp and vp
// are then heads [0, Hkv) at their base pointers, a head slice of a pool
// of kv_stride heads.  f32: q, kp, vp and out are f32 (hd <= 128), else
// bf16.
extern "C" int flash_decode_paged_launch(const void* q, const void* kp,
                                         const void* vp, const void* posp,
                                         const void* bt, const void* cur_pos,
                                         void* out, void* part,
                                         void* counters, int B, int Hq,
                                         int Hkv, int hd, int P, int n_blk,
                                         int bt_stride, int window,
                                         int n_chunks, int kv_stride,
                                         int f32, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || !fd_head_size(hd) || P < 1 ||
      (f32 && !fd_head_size_f32(hd)) ||
      n_blk < 0 || kv_stride < Hkv ||
      n_chunks != max(1, (n_blk + CHUNK_PAGES - 1) / CHUNK_PAGES))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = PD_LOG2E / sqrtf((float)hd);
  const int g = Hq / Hkv, G = fd_block_group(g, sd_pad(hd));
  const int err = fd_dispatch<Launch>(
      f32, G, hd, dim3(Hkv * (g / G), n_chunks, B),
      reinterpret_cast<cudaStream_t>(stream), q, kp, vp, posp, bt, bt_stride,
      cur_pos, out, part, counters, kv_stride, g / G, P, n_blk, window,
      scale_log2);
  if (err) return err;
  return (int)cudaGetLastError();
}
