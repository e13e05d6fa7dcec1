// The block body of the split decode attention kernels over K/V rows:
// flash_decode_paged.cu (a chunk is CHUNK_PAGES pages of a block table)
// and flash_decode.cu (a chunk is CHUNK_SLOTS slots of a contiguous cache
// row).  Each kernel reads what tells it its chunk (the table, or
// cur_pos), exits if the chunk is dead, and hands the rest to sd_chunk,
// templated on how a chunk's slots are addressed.
//
// Both grids are (kv head, chunk, batch row).  A live block issues every
// K and V row of a tile (SD_TILE slots, 16 bytes a thread by cp.async) and
// the slots' positions before it uses any, then: partial scores with one
// lane a slot and one warp a quarter of hd, summed over the quarters in a
// fixed order; one max, one sum and one rescale per tile, in base 2; P.V
// with one thread a pair of head dims.  A row whose live slots lie in one
// chunk has that block write the output.  Otherwise each live block stores
// its (m, l, acc) in scratch, and the last of the row's live blocks to
// arrive (an atomic count in a persistent buffer, reset to 0 by that
// block) merges the live chunks in chunk order, MG chunks' partials loaded
// at once, skipping a chunk with no valid slot exactly.  Each step's order
// is fixed by the chunk index and the thread, so a row's output depends
// only on its own chunks, never on the other rows of the batch.
//
// The CHUNK type (one object a block, in registers) provides:
//   PER_MASK, BIT     chunks a merge mask covers, and a chunk's bit stride
//   n_slots()         the slots of the chunk
//   row(s, ok)        element offset of slot s's K / V row for this kv
//                     head; ok: the slot is walked (else nothing is read)
//   pos(s)            the position slot s holds, -1 when it is not walked
//   n_units()         the chunk indices the merge scans, [0, n_units())
//   live_mask(c0, l)  bit BIT * i: chunk c0 + i stored a partial (every
//                     lane of the calling warp gets the same mask)
// G (the query heads a block takes: a kv head's whole group, or a
// sub-group of it when the launcher splits the group over the grid's x
// axis) in {1, 2, 4, 5, 8} and HD in {32, 64, 80, 128, 256} are template
// parameters, G * HDP / 32 <= 20.  The element type T of q, K, V and the
// output is bf16 or f32 (f32: HD <= 128, fd_head_size_f32); every sum is
// f32 in both, in the same order, and a 16-byte copy carries 8 bf16 or 4
// f32 values.  A head size that is not a power of two
// is padded to HDP (sd_pad: 80 -> 128) in shared memory and registers
// only: its K / V rows are loaded at their own 16-byte width and the pad
// is zero-filled, so the scores and P.V sum exact zeros there, and only
// the HD real dims are stored.  At HD == HDP every step is as it was.

#pragma once

#include "flash_decode_common.cuh"
#include "paged_decode.cuh"

#define SD_NT 128                    // threads a block
#define SD_NW (SD_NT / 32)
#define SD_TILE 32                   // slots a tile: one lane each for scores
#define SD_PAD_BYTES 16              // padding a shared-memory row

// the head size a block computes at: the power of two that holds hd
__host__ __device__ constexpr int sd_pad(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

template <int G, int HD>
struct SdShape {
  static constexpr int QPT = (G * HD + SD_NT - 1) / SD_NT;  // q values a thread
};

// T's shared memory fits the block at HD (a static 48 KB)
template <class T, int HD>
__host__ __device__ constexpr bool sd_fits() {
  return sizeof(T) == 2 || fd_head_size_f32(HD);
}

// 8 elements from shared memory as f32 (exact)
__device__ __forceinline__ void sd_load8(const bf16* p, float (&f)[8]) {
  pd_unpack8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void sd_load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// 2 neighbouring V values of a slot as f32, zeros for an invalid slot
// (whose V may hold anything)
__device__ __forceinline__ void sd_pair(const bf16* p, bool valid,
                                        float& v0, float& v1) {
  uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  if (!valid) w = 0u;
  v0 = __uint_as_float(w << 16);
  v1 = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void sd_pair(const float* p, bool valid,
                                        float& v0, float& v1) {
  const float2 w = *reinterpret_cast<const float2*>(p);
  v0 = valid ? w.x : 0.f;
  v1 = valid ? w.y : 0.f;
}

// the block's G query rows (q_group: the first, HD apart) into registers
template <int G, int HD, class T>
__device__ __forceinline__ void sd_load_q(const T* __restrict__ q_group,
                                          T (&qv)[SdShape<G, HD>::QPT],
                                          int t) {
#pragma unroll
  for (int k = 0; k < SdShape<G, HD>::QPT; ++k)
    if (t + k * SD_NT < G * HD) qv[k] = q_group[t + k * SD_NT];
}

// the zeros of a row with no slot to walk (out_group: its G rows)
template <int G, int HD, class T>
__device__ __forceinline__ void sd_zeros(T* __restrict__ out_group, int t) {
  for (int i = t; i < G * HD; i += SD_NT) fd_store(out_group + i, 0.f);
}

// One live chunk of one row and kv head: walk it, then write the output
// (nlive == 1) or store the partial and, in the last block to arrive,
// merge.  part: acc [B, Hkv, NC, G, HD], then (m, l) [B, Hkv, NC, G, 2],
// NC = gridDim.y; counters: one int32 a (row, kv head), zero between
// calls.  Called by every thread of the block.
template <int G, int HD, class CHUNK, class T>
__device__ __forceinline__ void sd_chunk(
    const CHUNK& ch, const T (&qv)[SdShape<G, HD>::QPT],
    const T* __restrict__ kp, const T* __restrict__ vp, int cur,
    int window, float scale_log2, int nlive, T* __restrict__ out_group,
    float* __restrict__ part, int* __restrict__ counters) {
  constexpr int HDP = sd_pad(HD);   // the padded head size (= HD or 128)
  constexpr int EPC = 16 / (int)sizeof(T);   // elements a 16-byte piece
  constexpr int ROW = HDP + SD_PAD_BYTES / (int)sizeof(T);
  constexpr int CPR = HDP / EPC;     // 16-byte pieces of a K or V row
  constexpr int NSG = 256 / HDP;     // slot groups of the P.V pass
  constexpr int QD = HDP / SD_NW;    // head dims of a score warp
  constexpr int QPT = SdShape<G, HD>::QPT;
  static_assert(HD % 16 == 0 && HD <= HDP, "16-byte K / V pieces");
  __shared__ __align__(16) T ks[SD_TILE * ROW];
  __shared__ __align__(16) T vs[SD_TILE * ROW];
  __shared__ __align__(16) float qs[G * HDP];
  __shared__ float sp[SD_NW][G][SD_TILE];    // partial scores by quarter
  __shared__ float pr[G][SD_TILE];           // probabilities
  __shared__ int valid_s[SD_TILE];
  __shared__ float alpha_s[G], m_s[G], l_s[G];
  __shared__ float red[NSG][G][HDP];         // the slot groups' acc
  __shared__ int last_s;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;

  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
  const int dp = t % (HDP / 2), sg = t / (HDP / 2);
  const int n_slots = ch.n_slots();

  for (int s0 = 0; s0 < n_slots; s0 += SD_TILE) {
    __syncthreads();                 // the previous tile is consumed
    // every K and V row of the tile in flight at once, then the positions
#pragma unroll
    for (int i = 0; i < SD_TILE * CPR / SD_NT; ++i) {
      const int idx = t + i * SD_NT;
      const int s = idx / CPR, cc = (idx % CPR) * EPC;
      bool ok;
      const size_t row = ch.row(s0 + s, ok);
      const bool in = cc < HD;       // past it: the pad, zero-filled
      const size_t at = row + (in ? cc : 0);
      pd_cp_async16(ks + s * ROW + cc, kp + at, ok && in);
      pd_cp_async16(vs + s * ROW + cc, vp + at, ok && in);
    }
    pd_cp_async_commit();
    if (t < SD_TILE) {
      const int pos = ch.pos(s0 + t);
      valid_s[t] = pos >= 0 && pos <= cur &&
                   (window <= 0 || pos > cur - window);
    }
    if (s0 == 0) {                   // q (loaded earlier), while K, V land
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        const int i = t + k * SD_NT;
        if (i < G * HD)
          qs[(i / HD) * HDP + i % HD] = fd_float(qv[k]) * scale_log2;
      }
      if constexpr (HDP != HD)
        for (int i = t; i < G * (HDP - HD); i += SD_NT)
          qs[(i / (HDP - HD)) * HDP + HD + i % (HDP - HD)] = 0.f;
      if (t < G) { m_s[t] = PD_NEG_INF; l_s[t] = 0.f; }
    }
    pd_cp_async_wait<0>();
    __syncthreads();

    // partial scores: lane = slot, warp = a quarter of the head dims
    {
      float sc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g] = 0.f;
      const T* kr = ks + lane * ROW + warp * QD;
#pragma unroll
      for (int u = 0; u < QD / 8; ++u) {
        float f[8];
        sd_load8(kr + 8 * u, f);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4* qq = reinterpret_cast<const float4*>(
              qs + g * HDP + warp * QD + 8 * u);
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
    for (int g = warp; g < G; g += SD_NW) {
      float s = sp[0][g][lane];
#pragma unroll
      for (int w = 1; w < SD_NW; ++w) s += sp[w][g][lane];
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
    for (int s = sg; s < SD_TILE; s += NSG) {
      float v0, v1;
      sd_pair(vs + s * ROW + 2 * dp, valid_s[s], v0, v1);
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
    for (int i = t; i < G * HD; i += SD_NT) {
      const int g = i / HD, d = i % HD;
      float A = red[0][g][d];
#pragma unroll
      for (int k = 1; k < NSG; ++k) A += red[k][g][d];
      fd_store(out_group + i, A / fmaxf(l_s[g], 1e-30f));
    }
    return;
  }

  const int Hkv = gridDim.x, NC = gridDim.y;
  const size_t head0 = ((size_t)b * Hkv + h) * NC;      // chunk 0's unit
  float* part_acc = part;
  float* part_ml = part + (size_t)gridDim.z * Hkv * NC * G * HD;
  for (int i = t; i < G * HD; i += SD_NT) {
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
  // (their loads in flight together; the groups are fixed by the chunk
  // index, so any batch or table width folds a row's chunks alike);
  // G * HDP is a multiple of 32, so a warp is either all in the loop or
  // all out (a pad dim loads nothing and stores nothing)
  constexpr int MG = CHUNK::PER_MASK < 8 ? CHUNK::PER_MASK : 8;
  for (int i = t; i < G * HDP; i += SD_NT) {
    const int g = i / HDP, d = i % HDP;
    const bool in = d < HD;
    float m = PD_NEG_INF, L = 0.f, A = 0.f;
    for (int c0 = 0; c0 < ch.n_units(); c0 += CHUNK::PER_MASK) {
      const unsigned cm = ch.live_mask(c0, lane);
      if (cm == 0u) continue;                     // uniform in the warp
#pragma unroll
      for (int g0 = 0; g0 < CHUNK::PER_MASK; g0 += MG) {
        float mc[MG], lc[MG], ac[MG];
#pragma unroll
        for (int k = 0; k < MG; ++k) {
          const bool live = (cm >> ((g0 + k) * CHUNK::BIT)) & 1u;
          const size_t u = (head0 + c0 + g0 + k) * G + g;
          mc[k] = live ? __ldcg(part_ml + 2 * u) : PD_NEG_INF;
          lc[k] = live ? __ldcg(part_ml + 2 * u + 1) : 0.f;
          ac[k] = live && in ? __ldcg(part_acc + u * HD + d) : 0.f;
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
    if (in) fd_store(out_group + g * HD + d, A / fmaxf(L, 1e-30f));
  }
}
