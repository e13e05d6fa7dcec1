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
// rows of the batch are and whatever the table view's width n_blk.
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
// trash exits there.  A live block issues every K and V row of its chunk
// (TILE slots, 16 bytes a thread by cp.async) and the slots' positions
// before it uses any, then: partial scores with one lane a slot and one
// warp a quarter of hd, summed over the quarters in a fixed order; one max,
// one sum and one rescale per tile; P.V with one thread a pair of head
// dims.  A row whose live pages lie in one chunk has that block write the
// output.  Otherwise each live block stores its (m, l, acc) in scratch,
// and the last of the row's live blocks to arrive (an atomic count in a
// persistent buffer, reset to 0 by that block) merges the live chunks in
// chunk order, MG chunks' partials loaded at once, skipping a chunk with
// no valid slot exactly.  Each step's order is fixed by the chunk index
// and the thread, so the output depends only on the row's own table
// columns.  G (query heads per kv head) in {1, 2, 4, 8} and hd in
// {32, 64, 128, 256} are template parameters, G * hd / 32 <= 16.
//
// On the H100 at the check (8 rows, 127 pages) a call takes about 0.019 ms
// against the one-block-a-row design's 0.033, and 0.012 at one row of 512
// positions against 0.031.  What holds it there: a block's chain of
// dependent loads (table, then K and V) and its merge protocol, times the
// two waves of blocks the grid needs at 8 rows.  Chunks of 4 columns were
// no faster at the check and slower at one row; a persistent grid walking
// units with the next unit's loads in flight, and clusters merging
// through distributed shared memory, were slower (PERF.md).

#include "flash_decode_common.cuh"
#include "paged_decode.cuh"

#define FDP_NT 128                   // threads a block
#define FDP_NW (FDP_NT / 32)
#define CHUNK_PAGES 2                // table columns a block takes (divides 32)
#define FDP_TILE 32                  // slots a tile: one lane each for scores
#define FDP_PAD 8                    // bf16 of padding a shared-memory row

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

template <int G, int HD>
__global__ void __launch_bounds__(FDP_NT, 8)
flash_decode_paged_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ kp,
                          const bf16* __restrict__ vp,
                          const int* __restrict__ posp,
                          const int* __restrict__ bt, int bt_stride,
                          const int* __restrict__ cur_pos,
                          bf16* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ counters, int Hkv, int P,
                          int n_blk, int window, float scale_log2) {
  constexpr int ROW = HD + FDP_PAD;
  constexpr int CPR = HD / 8;        // 16-byte pieces of a K or V row
  constexpr int NSG = 256 / HD;      // slot groups of the P.V pass
  constexpr int QD = HD / FDP_NW;    // head dims of a score warp
  __shared__ __align__(16) bf16 ks[FDP_TILE * ROW];
  __shared__ __align__(16) bf16 vs[FDP_TILE * ROW];
  __shared__ __align__(16) float qs[G * HD];
  __shared__ float sp[FDP_NW][G][FDP_TILE];  // partial scores by quarter
  __shared__ float pr[G][FDP_TILE];          // probabilities
  __shared__ int valid_s[FDP_TILE];
  __shared__ float alpha_s[G], m_s[G], l_s[G];
  __shared__ float red[NSG][G][HD];          // the slot groups' acc
  __shared__ int last_s;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int* row_bt = bt + (size_t)b * bt_stride;
  const size_t o_off = ((size_t)b * Hkv + h) * G * HD;

  // loads that need no table entry go first, to overlap the table's
  constexpr int QPT = (G * HD + FDP_NT - 1) / FDP_NT;  // q values a thread
  const int cur = cur_pos[b];
  bf16 qv[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k)
    if (t + k * FDP_NT < G * HD) qv[k] = q[o_off + t + k * FDP_NT];

  // the row's table, 32 columns a pass (one load a lane): the block's own
  // pages, and how many chunks of the row hold a page (every warp alike)
  int pages[CHUNK_PAGES];
#pragma unroll
  for (int i = 0; i < CHUNK_PAGES; ++i) pages[i] = TRASH_PAGE;
  int nlive = 0;
  for (int base = 0; base < n_blk; base += 32) {
    const int j = base + lane;
    const int page = j < n_blk ? row_bt[j] : TRASH_PAGE;
    nlive += __popc(chunk_bits(__ballot_sync(0xffffffffu, page != TRASH_PAGE)));
#pragma unroll
    for (int i = 0; i < CHUNK_PAGES; ++i) {
      const int col = c * CHUNK_PAGES + i - base;   // the same in every lane
      const int got = __shfl_sync(0xffffffffu, page, col & 31);
      if (col >= 0 && col < 32) pages[i] = got;
    }
  }
  bool any = false;
#pragma unroll
  for (int i = 0; i < CHUNK_PAGES; ++i) any |= pages[i] != TRASH_PAGE;
  if (!any) {                        // a dead chunk; chunk 0 of an idle
    if (nlive == 0 && c == 0)        // row writes its zeros
      for (int i = t; i < G * HD; i += FDP_NT)
        out[o_off + i] = __float2bfloat16(0.f);
    return;
  }

#pragma unroll
  for (int k = 0; k < QPT; ++k)
    if (t + k * FDP_NT < G * HD)
      qs[t + k * FDP_NT] = __bfloat162float(qv[k]) * scale_log2;
  if (t < G) { m_s[t] = PD_NEG_INF; l_s[t] = 0.f; }

  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
  const int dp = t % (HD / 2), sg = t / (HD / 2);
  const int n_slots = CHUNK_PAGES * P;

  for (int s0 = 0; s0 < n_slots; s0 += FDP_TILE) {
    __syncthreads();                 // the previous tile is consumed
    // every K and V row of the tile in flight at once, then the positions
#pragma unroll
    for (int i = 0; i < FDP_TILE * CPR / FDP_NT; ++i) {
      const int idx = t + i * FDP_NT;
      const int s = idx / CPR, ch = (idx % CPR) * 8;
      const int slot = s0 + s, col = slot / P;
      int page = TRASH_PAGE;
#pragma unroll
      for (int k = 0; k < CHUNK_PAGES; ++k)
        if (col == k) page = pages[k];
      const bool ok = slot < n_slots && page != TRASH_PAGE;
      const size_t off =
          ok ? (((size_t)page * P + slot % P) * Hkv + h) * HD + ch : 0;
      pd_cp_async16(ks + s * ROW + ch, kp + off, ok);
      pd_cp_async16(vs + s * ROW + ch, vp + off, ok);
    }
    pd_cp_async_commit();
    if (t < FDP_TILE) {
      const int slot = s0 + t, col = slot / P;
      int page = TRASH_PAGE;
#pragma unroll
      for (int k = 0; k < CHUNK_PAGES; ++k)
        if (col == k) page = pages[k];
      const bool ok = slot < n_slots && page != TRASH_PAGE;
      const int pos = ok ? posp[(size_t)page * P + slot % P] : -1;
      valid_s[t] = pos >= 0 && pos <= cur &&
                   (window <= 0 || pos > cur - window);
    }
    pd_cp_async_wait<0>();
    __syncthreads();

    // partial scores: lane = slot, warp = a quarter of the head dims
    {
      float sc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g] = 0.f;
      const bf16* kr = ks + lane * ROW + warp * QD;
#pragma unroll
      for (int u = 0; u < QD / 8; ++u) {
        float f[8];
        pd_unpack8(*reinterpret_cast<const uint4*>(kr + 8 * u), f);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4* qq = reinterpret_cast<const float4*>(
              qs + g * HD + warp * QD + 8 * u);
          const float4 a = qq[0], e = qq[1];
          sc[g] += a.x * f[0] + a.y * f[1] + a.z * f[2] + a.w * f[3] +
                   e.x * f[4] + e.y * f[5] + e.z * f[6] + e.w * f[7];
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) sp[warp][g][lane] = sc[g];
    }
    __syncthreads();

    // one max, one sum and one rescale factor per head for the tile
    for (int g = warp; g < G; g += FDP_NW) {
      float s = sp[0][g][lane];
#pragma unroll
      for (int w = 1; w < FDP_NW; ++w) s += sp[w][g][lane];
      const bool valid = valid_s[lane];
      float mx = valid ? s : PD_NEG_INF;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g], m_new = fmaxf(m_old, mx);
      const float p = valid ? pd_ex2(s - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      pr[g][lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float a = pd_ex2(m_old - m_new);
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V: thread (slot group sg, dims 2 dp, 2 dp + 1)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = alpha_s[g];
      acc[g][0] *= a;
      acc[g][1] *= a;
    }
#pragma unroll
    for (int s = sg; s < FDP_TILE; s += NSG) {
      uint32_t w = *reinterpret_cast<const uint32_t*>(vs + s * ROW + 2 * dp);
      if (!valid_s[s]) w = 0u;       // an invalid slot's V may hold anything
      const float v0 = __uint_as_float(w << 16);
      const float v1 = __uint_as_float(w & 0xffff0000u);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = pr[g][s];
        acc[g][0] += p * v0;
        acc[g][1] += p * v1;
      }
    }
  }

  // the chunk's acc: the slot groups summed in order
#pragma unroll
  for (int g = 0; g < G; ++g) {
    red[sg][g][2 * dp] = acc[g][0];
    red[sg][g][2 * dp + 1] = acc[g][1];
  }
  __syncthreads();
  if (nlive == 1) {                  // the row's only live chunk: write out
    for (int i = t; i < G * HD; i += FDP_NT) {
      const int g = i / HD, d = i % HD;
      float A = red[0][g][d];
#pragma unroll
      for (int k = 1; k < NSG; ++k) A += red[k][g][d];
      out[o_off + i] = __float2bfloat16(A / fmaxf(l_s[g], 1e-30f));
    }
    return;
  }

  // scratch: acc [B, Hkv, NC, G, HD], then (m, l) [B, Hkv, NC, G, 2]
  const int NC = gridDim.y;
  const size_t head0 = ((size_t)b * Hkv + h) * NC;      // chunk 0's unit
  float* part_acc = part;
  float* part_ml = part + (size_t)gridDim.z * Hkv * NC * G * HD;
  for (int i = t; i < G * HD; i += FDP_NT) {
    const int g = i / HD, d = i % HD;
    float A = red[0][g][d];
#pragma unroll
    for (int k = 1; k < NSG; ++k) A += red[k][g][d];
    part_acc[((head0 + c) * G + g) * HD + d] = A;
  }
  if (t < G) {
    part_ml[((head0 + c) * G + t) * 2] = m_s[t];
    part_ml[((head0 + c) * G + t) * 2 + 1] = l_s[t];
  }
  __threadfence();                   // the partial is visible before the count
  __syncthreads();
  if (t == 0) {
    int* cnt = counters + (size_t)b * Hkv + h;
    const bool last = atomicAdd(cnt, 1) == nlive - 1;
    if (last) *cnt = 0;              // ready for the next call
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the last block: merge the live chunks in chunk order, MG at a time
  // (their loads in flight together; the groups are fixed by the column
  // index, so any table width folds a row's chunks alike); G * HD is a
  // multiple of 32, so a warp is either all in the loop or all out
  constexpr int PER_BALLOT = 32 / CHUNK_PAGES;    // chunks of 32 columns
  constexpr int MG = PER_BALLOT < 8 ? PER_BALLOT : 8;
  for (int i = t; i < G * HD; i += FDP_NT) {
    const int g = i / HD, d = i % HD;
    float m = PD_NEG_INF, L = 0.f, A = 0.f;
    for (int base = 0; base < n_blk; base += 32) {
      const unsigned cm = live_chunks(row_bt, base, n_blk, lane);
      if (cm == 0u) continue;                     // uniform in the warp
#pragma unroll
      for (int g0 = 0; g0 < PER_BALLOT; g0 += MG) {
        float mc[MG], lc[MG], ac[MG];
#pragma unroll
        for (int k = 0; k < MG; ++k) {
          const bool live = (cm >> ((g0 + k) * CHUNK_PAGES)) & 1u;
          const size_t u = (head0 + base / CHUNK_PAGES + g0 + k) * G + g;
          mc[k] = live ? __ldcg(part_ml + 2 * u) : PD_NEG_INF;
          lc[k] = live ? __ldcg(part_ml + 2 * u + 1) : 0.f;
          ac[k] = live ? __ldcg(part_acc + u * HD + d) : 0.f;
        }
        float gm = PD_NEG_INF;
#pragma unroll
        for (int k = 0; k < MG; ++k)
          if (lc[k] > 0.f) gm = fmaxf(gm, mc[k]);
        const float m_new = fmaxf(m, gm);
        const float a = pd_ex2(m - m_new);
        L *= a;
        A *= a;
#pragma unroll
        for (int k = 0; k < MG; ++k) {
          if (!(lc[k] > 0.f)) continue;   // no valid slot: counts for nothing
          const float w = pd_ex2(mc[k] - m_new);
          L += lc[k] * w;
          A += ac[k] * w;
        }
        m = m_new;
      }
    }
    out[o_off + i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
}

template <int G, int DPL>
struct Launch {
  static int run(dim3 grid, cudaStream_t s, const void* q, const void* kp,
                 const void* vp, const void* posp, const void* bt,
                 int bt_stride, const void* cur_pos, void* out, void* part,
                 void* counters, int Hkv, int P, int n_blk, int window,
                 float scale_log2) {
    if constexpr (G * DPL <= 16) {
      flash_decode_paged_kernel<G, 32 * DPL><<<grid, FDP_NT, 0, s>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
          static_cast<const bf16*>(vp), static_cast<const int*>(posp),
          static_cast<const int*>(bt), bt_stride,
          static_cast<const int*>(cur_pos), static_cast<bf16*>(out),
          static_cast<float*>(part), static_cast<int*>(counters), Hkv, P,
          n_blk, window, scale_log2);
      return 0;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
};

// part: scratch of B * Hkv * n_chunks * (Hq / Hkv) * (hd + 2) floats;
// counters: B * Hkv int32, zero before the first call (each call leaves
// them zero); n_chunks = ceil(n_blk / CHUNK_PAGES), at least 1.  Returns
// cudaGetLastError() after launch (cudaErrorInvalidValue for a head group
// or head size without an instantiation, or another n_chunks).
// window <= 0: none.
extern "C" int flash_decode_paged_launch(const void* q, const void* kp,
                                         const void* vp, const void* posp,
                                         const void* bt, const void* cur_pos,
                                         void* out, void* part,
                                         void* counters, int B, int Hq,
                                         int Hkv, int hd, int P, int n_blk,
                                         int bt_stride, int window,
                                         int n_chunks, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || hd % 32 != 0 || P < 1 || n_blk < 0 ||
      n_chunks != max(1, (n_blk + CHUNK_PAGES - 1) / CHUNK_PAGES))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = PD_LOG2E / sqrtf((float)hd);
  const int err = fd_dispatch<Launch>(
      Hq / Hkv, hd / 32, dim3(Hkv, n_chunks, B),
      reinterpret_cast<cudaStream_t>(stream), q, kp, vp, posp, bt, bt_stride,
      cur_pos, out, part, counters, Hkv, P, n_blk, window, scale_log2);
  if (err) return err;
  return (int)cudaGetLastError();
}
