// flash_decode_paged_mla: one-token weight-absorbed MLA decode attention
// over a paged latent pool.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_decode_paged.py::flash_decode_paged_mla_pallas.
// Contract (identical): q_lat [B, H, R] f32 (q_nope folded through
// W_kv_b(k)); q_rope [B, H, DR] f32; ckvp [N, P, R] and kropep [N, P, DR]
// both bf16 or both f32 (the reference casts whatever latents it is given
// to f32); posp [N, P] int32; block_tables [B, n_blk] int32 (row pitch
// bt_stride, so a truncated view table[:, :n_live] needs no copy); cur_pos
// [B] int32 -> out [B, H, R] f32, the latent attention output (the caller
// folds W_kv_b(v) in).  s = (q_lat . ckv + q_rope . krope) * scale over the
// slots with 0 <= posp <= cur_pos, softmax, out = p . ckv.  Table entries
// equal to the trash page 0 are skipped; a row with no valid slot (an idle
// batch row) gets zeros.  (R, DR) is (512, 64) (DeepSeek-V2-Lite:
// kv_lora_rank 512, qk_rope_head_dim 64, 16 heads) or (256, 32)
// (MiniCPM3-4B: 40 heads), and on f32 latents also (32, 16) (the reduced
// DeepSeek config: 4 heads), template parameters; any H, in head tiles
// along the grid's z axis (16 heads on bf16 latents; on f32 latents the
// tile of MlaF32Tune: 8 at R 512 and 256, 4 at R 32; the last tile
// partial, its missing heads' rows zero and never stored).  A row's
// output is bitwise the same whatever the other rows of the batch are and
// whatever the table view's width n_blk, and a head's whatever its tile,
// in both instances.
//
// What bounds it on the H100.  Every head reads the same latent row (MQA
// over the latents): per live slot 576 bf16 values are read once for all
// heads, and each head does 2 * (R + DR) + 2 * R operations on them.  At
// B 8 with 2012 live positions on 127 pages of 16 the latents are 2.34 MB
// (0.70 us at 3.35 TB/s) and the work 70 MFLOP: 1.04 us at the 67 TFLOP/s
// f32 rate the TPU kernel's f32 dots would run at, which stays the
// yardstick.
//
// Design.  One launch: a thread-block cluster of CL blocks per batch row;
// block rank r walks the row's table columns r, r + CL, r + 2 CL, ... (the
// rank stride is a constant, so a row's split never depends on B or n_blk),
// with the block's page list read ahead of the walk and trash pages left
// out.  Each block streams its pages as tiles of 16 slots (18 KB of latents,
// one row a slot) through a four-stage cp.async ring (all four of a rank's
// tiles at the check's longest row in flight at once), so later tiles'
// loads overlap this tile's work.  Both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate) with the f32 operands split
// into bf16 hi + lo parts, the latents being exact in bf16: the scores
// [16 heads x 16 slots] = q_hi . k + q_lo . k over 576 (8 warps: two slot
// halves x four k-quarters, the quarters summed in a fixed order), then per
// head one max, one sum and one rescale a tile, and acc [16 x 512] +=
// p_hi . ckv + p_lo . ckv (a warp owns 64 latent columns; acc stays in
// registers).  The error is that of a 16-bit mantissa on q and p, far
// inside the f32 reference's tolerance.  At the end each block leaves
// (m, l, acc) in its shared memory, and rank r merges latent columns
// [64 r, 64 r + 64) of every head over the cluster's blocks in rank order
// through distributed shared memory (every rank's state loaded at once,
// then folded in order), skipping a block with no valid slot exactly.
// At R 256 the shapes halve where they follow R: a warp owns 32 latent
// columns, a rank merges 32, and the 18 k-steps of the scores split 4, 5,
// 4, 5 over the four k-quarters (at R 512: 9 each).  No
// scratch in device memory, no second launch.  On the H100 at the check
// (8 rows, 127 pages) a call takes about 0.016 ms against the two-pass
// design's 0.025; each tile a rank walks adds about 1.3 us, and the
// cluster merge holds much of the rest (PERF.md).
//
// f32 latents (mla_decode_f32_kernel, below) are not exact in bf16, so
// its products run f32 FFMA on the CUDA cores with nothing rounded: the
// same walk and ring (a tile of 16 f32 rows is 36.9 KB at R 512).  Its
// bound is the same f32 work on twice the bytes; what holds it on the card
// is shared memory, which hands lanes 128 B a cycle an SM against 128 FFMA
// lanes, so every value a lane loads has to feed several FFMAs, and a
// tile's serial phases, which other warps have to overlap.  So a block
// holds 8 heads (the check's 8 rows fill 128 SMs); four score warps hold
// patches of 2 heads x 2 slots (one of each output's four chains) and
// write the chains' sums; the other four warps copy the tiles in, run the
// online softmax and P.V (4 heads x 8 columns a lane) one tile behind the
// scores, one barrier a tile; and each rank pushes its state into the
// ranks that merge it, so the merge takes one cluster barrier, not two.
// Each output's sums run in a fixed order whatever thread computes them,
// so the launch constants below change no bit.

#include <cooperative_groups.h>

#include "paged_decode.cuh"

namespace cg = cooperative_groups;

#define MLA_NT 256
#define MLA_CL 8               // blocks a row (cluster size, rank stride)
#define MLA_H 16               // heads a block holds (rows of the mma tiles)
#define MLA_TILE 16            // slots a tile
#define MLA_PROW 24            // bf16 a probability row (48 B)
#define MLA_STAGES 4           // tiles in flight (a block's four pages at
                               // the check's longest row)
#define MLA_SMEM_MAX (200 * 1024)

// the shapes that follow the latent width R and the rope width DR
template <int R, int DR>
struct MlaShape {
  static constexpr int K = R + DR;
  // bf16 a shared row (R 512: 1168 B, R 256: 592 B; both put the eight
  // 16-byte rows of an ldmatrix on distinct banks)
  static constexpr int ROW = K + 8;
  static constexpr int QF = MLA_H * (K / 4);             // q float4s
  static constexpr int QN = (QF + MLA_NT - 1) / MLA_NT;  // a thread's
  static constexpr int KS = K / 16;                      // score k-steps
  static constexpr int KQ = (KS + 3) / 4;                // a quarter's most
  static constexpr int WC = R / 8;       // latent columns a P.V warp owns
  static constexpr int NJ = WC / 16;     // its 16-column steps
  // shared memory (bytes): q hi, q lo, the latent stages, small arrays
  static constexpr int Q_BYTES = MLA_H * ROW * 2;
  static constexpr int T_BYTES = MLA_TILE * ROW * 2;
  static constexpr int FIXED_BYTES =
      2 * Q_BYTES + MLA_STAGES * T_BYTES + MLA_STAGES * MLA_TILE * 4 +
      4 * MLA_H * MLA_TILE * 4 + 2 * MLA_H * MLA_PROW * 2 + MLA_H * 4 +
      2 * MLA_H * 4 + 16;
  static_assert(R % 128 == 0 && DR % 16 == 0, "whole mma and ldmatrix tiles");
  static_assert(MLA_H * R * 4 <= 2 * Q_BYTES, "acc fits over q");
};

// Launch constants of the f32 instance, by latent width R
// (tools/decode_attention_times.py --variants replaces them): the heads a
// block holds (its head tile), the ring's stages, the blocks an SM the
// launch bound asks for, and the P.V patch's latent columns a thread; the
// score patch (SC_PH heads x SC_PS slots a lane, the loop unrolled
// SC_UNROLL times) and the P.V patch's heads a thread.
constexpr int F32_HT_512 = 8;
constexpr int F32_HT_256 = 8;
constexpr int F32_HT_32 = 4;
constexpr int F32_STAGES_512 = 3;
constexpr int F32_STAGES_256 = 3;
constexpr int F32_STAGES_32 = 3;
constexpr int F32_BLOCKS_512 = 1;
constexpr int F32_BLOCKS_256 = 3;
constexpr int F32_BLOCKS_32 = 2;
constexpr int F32_PVC_512 = 8;
constexpr int F32_PVC_256 = 4;
constexpr int F32_PVC_32 = 4;
constexpr int F32_SC_PH = 2;
constexpr int F32_SC_PS = 2;
constexpr int F32_SC_UNROLL = 16;
constexpr int F32_PV_H = 4;

constexpr int pow2_floor(int x) { return x < 2 ? 1 : 2 * pow2_floor(x / 2); }

template <int R>
struct MlaF32Tune {
  static constexpr int HT =
      R == 512 ? F32_HT_512 : R == 256 ? F32_HT_256 : F32_HT_32;
  static constexpr int STAGES =
      R == 512 ? F32_STAGES_512 : R == 256 ? F32_STAGES_256 : F32_STAGES_32;
  static constexpr int BLOCKS =
      R == 512 ? F32_BLOCKS_512 : R == 256 ? F32_BLOCKS_256 : F32_BLOCKS_32;
  static constexpr int PVC =
      R == 512 ? F32_PVC_512 : R == 256 ? F32_PVC_256 : F32_PVC_32;
};

// The f32 instance's shapes (f32 latents): one f32 row a slot, ROW floats
// (ROW % 32 == 4 or 20, so the eight rows a score warp reads at one k lie
// on distinct banks, and ROW / 4 odd for the ring's 16-byte copies).
// Threads [0, SC_THREADS) score: lane (chain e, slot group sg, head group
// hg), e fastest; a lane holds chain e of heads PH hg .. + PH - 1 at slots
// sg + SG j, j < PS.  Threads
// [SC_THREADS, MLA_NT) copy the tiles in, and the first PV_THREADS
// of them run P.V: heads PVH (u / NCG) .. + PVH - 1 at the PVC / 4 float4
// column groups u % NCG + NCG k (u = t - SC_THREADS), so a warp's float4
// loads are contiguous; before it, threads u < 16 HT run a tile's online
// softmax, one (head u / 16, slot u % 16) a thread.  The scores' chain sums
// sc [2][4][HT][TILE] are double-buffered by tile parity.
// recv [CL][HT][CW] and recv_ml [CL][HT][2]: every rank's state of the
// latent columns this rank merges, written there by that rank.
template <int R, int DR>
struct MlaF32Shape {
  using Tune = MlaF32Tune<R>;
  static constexpr int HT = Tune::HT, STAGES = Tune::STAGES;
  static constexpr int BLOCKS = Tune::BLOCKS;
  static constexpr int K = R + DR;
  static constexpr int ROW = K + 4;
  static constexpr int PH = F32_SC_PH, PS = F32_SC_PS;
  static constexpr int SG = MLA_TILE / PS;      // a head's lanes / 4
  static constexpr int SC_THREADS = 4 * SG * (HT / PH);
  static constexpr int LOADERS = MLA_NT - SC_THREADS;
  static constexpr int PVH = F32_PV_H, PVC = Tune::PVC;
  static constexpr int NCG = R / PVC;           // P.V column groups
  static constexpr int PV_THREADS = NCG * (HT / PVH);
  static constexpr int PROW = HT;               // p: [slot][head]
  static constexpr int QF = HT * (K / 4);       // q float4s
  static constexpr int CW = R / MLA_CL;         // latent columns a rank owns
  // a tile's ckv copies: CG groups of rows a float4 column, CG the
  // largest power of two <= LOADERS / (R / 4) and <= TILE
  static constexpr int CG = pow2_floor(
      LOADERS / (R / 4) < 1 ? 1
      : LOADERS / (R / 4) > MLA_TILE ? MLA_TILE : LOADERS / (R / 4));
  static constexpr int Q_BYTES = HT * ROW * 4;
  static constexpr int T_BYTES = MLA_TILE * ROW * 4;
  static constexpr int RECV_BYTES = HT * R * 4 + MLA_CL * HT * 2 * 4;
  static constexpr int FIXED_BYTES =
      Q_BYTES + STAGES * T_BYTES + RECV_BYTES + STAGES * MLA_TILE * 4 +
      2 * 4 * HT * MLA_TILE * 4 + MLA_TILE * PROW * 4 + HT * 4 + 16;
  static_assert(R % 32 == 0 && DR % 4 == 0 && (ROW / 4) % 2 == 1 &&
                    (ROW % 32 == 4 || ROW % 32 == 20),
                "float4 rows; a score warp's rows on distinct banks");
  static_assert(MLA_TILE % PS == 0 && HT % PH == 0 && 32 % (4 * SG) == 0 &&
                    SC_THREADS % 32 == 0,
                "a head group's score lanes inside one warp; whole warps");
  static_assert(PVH % 4 == 0 && HT % PVH == 0 && PVC % 4 == 0 &&
                    R % PVC == 0 && PV_THREADS <= LOADERS &&
                    HT * MLA_TILE <= LOADERS && LOADERS % 32 == 0,
                "P.V patches of whole float4s and the softmax beside the "
                "score threads");
  static_assert(STAGES >= 3 && FIXED_BYTES < MLA_SMEM_MAX,
                "a tile in flight beside the two in use; shared memory");
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(pd_smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(pd_smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(pd_smem_u32(p)));
}

// d += a (16x16, row major) * b (16x8, col major), bf16 in, f32 out
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// barrier id among the n threads (whole warps) that reach it
__device__ __forceinline__ void mla_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// the cluster's barrier in two halves: arrive (relaxed: nothing to
// publish) and wait
__device__ __forceinline__ void mla_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mla_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// x = hi + lo + (a rest below 2^-16 |x|), both bf16
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16(x);
  lo = __float2bfloat16(x - __bfloat162float(hi));
}

// The block's pages of a row (its table row ``row_bt``): columns rank,
// rank + CL, ...; trash left out; into list[], their count *n_pages_s
// (warp 0 writes them).
__device__ __forceinline__ void mla_page_list(const int* __restrict__ row_bt,
                                              int n_blk, int rank, int* list,
                                              int* n_pages_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    const int n_cols = n_blk > rank ? (n_blk - rank + MLA_CL - 1) / MLA_CL : 0;
    int n = 0;
    for (int base = 0; base < n_cols; base += 32) {
      const int i = base + lane;
      const int page = i < n_cols ? row_bt[rank + MLA_CL * i] : TRASH_PAGE;
      const unsigned live = __ballot_sync(0xffffffffu, page != TRASH_PAGE);
      if (page != TRASH_PAGE)
        list[n + __popc(live & ((1u << lane) - 1u))] = page;
      n += __popc(live);
    }
    if (lane == 0) *n_pages_s = n;
  }
}

// One head's 4 latent columns over the cluster's ranks in rank order:
// (m, l) and acc of each rank, a rank with no valid slot counting for
// nothing; returns acc / l of the merged softmax.
__device__ __forceinline__ float4 mla_fold(const float (&mr)[MLA_CL],
                                           const float (&lr)[MLA_CL],
                                           const float4 (&vr)[MLA_CL]) {
  float mx = PD_NEG_INF;
#pragma unroll
  for (int r = 0; r < MLA_CL; ++r)
    if (lr[r] > 0.f) mx = fmaxf(mx, mr[r]);
  float L = 0.f;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r = 0; r < MLA_CL; ++r) {
    if (!(lr[r] > 0.f)) continue;     // no valid slot: counts for nothing
    const float w = pd_ex2(mr[r] - mx);
    L += lr[r] * w;
    A.x += w * vr[r].x; A.y += w * vr[r].y;
    A.z += w * vr[r].z; A.w += w * vr[r].w;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  return make_float4(A.x * inv, A.y * inv, A.z * inv, A.w * inv);
}

// The cluster's merge, after every block left its (m, l) in ml [H][2] and
// its acc [H][R] f32 in acc_s and the cluster synced: rank r writes
// columns [CW r, CW r + CW) of every head of the tile.
template <int R>
__device__ __forceinline__ void mla_merge(cg::cluster_group& cluster,
                                          float* ml, float* acc_s,
                                          float* __restrict__ out, int b,
                                          int H, int h0, int rank) {
  constexpr int CW = R / MLA_CL;         // latent columns a rank merges
  constexpr int TPH = CW / 4;            // merge threads a head
  static_assert(MLA_NT / TPH >= MLA_H, "a merge pass covers the tile's heads");
  const int t = threadIdx.x;
  // rank r: columns [CW r, CW r + CW) of every head, over the ranks in
  // order; thread (head t / TPH, 4 columns, one 16-byte load a rank).
  // Every rank's (m, l) and columns are loaded together, then folded in
  // rank order.
  if (t / TPH < MLA_H) {
    const int hh = t / TPH, c0 = CW * rank + 4 * (t % TPH);
    float mr[MLA_CL], lr[MLA_CL];
    float4 vr[MLA_CL];
#pragma unroll
    for (int r = 0; r < MLA_CL; ++r) {
      const float* rml = cluster.map_shared_rank(ml, r);
      mr[r] = rml[2 * hh];
      lr[r] = rml[2 * hh + 1];
      vr[r] = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(acc_s, r) + hh * R + c0);
    }
    const float4 o = mla_fold(mr, lr, vr);
    if (h0 + hh < H)
      *reinterpret_cast<float4*>(out + ((size_t)b * H + h0 + hh) * R + c0) =
          o;
  }
}

template <int R, int DR>
__global__ void __cluster_dims__(MLA_CL, 1, 1) __launch_bounds__(MLA_NT, 1)
mla_decode_kernel(const float* __restrict__ q_lat,
                  const float* __restrict__ q_rope,
                  const __nv_bfloat16* __restrict__ ckvp,
                  const __nv_bfloat16* __restrict__ kropep,
                  const int* __restrict__ posp, const int* __restrict__ bt,
                  int bt_stride, const int* __restrict__ cur_pos,
                  float* __restrict__ out, int H, int P, int n_blk,
                  float scale_log2) {
  using S = MlaShape<R, DR>;
  constexpr int K = S::K, ROW = S::ROW;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qhi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qlo = qhi + MLA_H * ROW;
  __nv_bfloat16* tiles = qlo + MLA_H * ROW;       // [STAGES][TILE][ROW]
  int* pos_s = reinterpret_cast<int*>(tiles + MLA_STAGES * MLA_TILE * ROW);
  float* sc = reinterpret_cast<float*>(pos_s + MLA_STAGES * MLA_TILE);
                                                  // [4][H][TILE]
  __nv_bfloat16* phi =
      reinterpret_cast<__nv_bfloat16*>(sc + 4 * MLA_H * MLA_TILE);
  __nv_bfloat16* plo = phi + MLA_H * MLA_PROW;
  float* alpha_s = reinterpret_cast<float*>(plo + MLA_H * MLA_PROW);
  float* ml = alpha_s + MLA_H;                    // [H][2]: m, l
  int* n_pages_s = reinterpret_cast<int*>(ml + 2 * MLA_H);
  int* list = reinterpret_cast<int*>(smem + S::FIXED_BYTES);
  float* acc_s = reinterpret_cast<float*>(smem);  // [H][R], over q at the end

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), b = blockIdx.y;
  const int h0 = MLA_H * blockIdx.z;              // the tile's first head
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int cur = cur_pos[b];
  const int tpp = (P + MLA_TILE - 1) / MLA_TILE;  // tiles a page

  // q first (it needs no table entry): float4 k of this thread holds
  // tile head idx / (K / 4), columns 4 (idx % (K / 4)) .. + 3,
  // idx = t + k NT
  float4 qr[S::QN];
#pragma unroll
  for (int k = 0; k < S::QN; ++k) {
    const int idx = t + k * MLA_NT;
    const int h = idx / (K / 4), c = 4 * (idx % (K / 4));
    const size_t hb = (size_t)b * H + h0 + h;
    qr[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (idx < S::QF && h0 + h < H)
      qr[k] = c < R ? *reinterpret_cast<const float4*>(q_lat + hb * R + c)
                    : *reinterpret_cast<const float4*>(q_rope + hb * DR +
                                                       c - R);
  }

  mla_page_list(bt + (size_t)b * bt_stride, n_blk, rank, list, n_pages_s);
  __syncthreads();
  const int n_tiles = *n_pages_s * tpp;

  // tile it -> stage st: 16 latent rows (ckv then krope, one shared row a
  // slot), rows past the page zero-filled; the slots' positions beside
  auto load_tile = [&](int it, int st) {
    const int page = list[it / tpp], p0 = (it % tpp) * MLA_TILE;
    const int ns = min(MLA_TILE, P - p0);
    const size_t row0 = (size_t)page * P + p0;
    __nv_bfloat16* dst = tiles + st * MLA_TILE * ROW;
    for (int idx = t; idx < MLA_TILE * (K / 8); idx += MLA_NT) {
      const int r = idx / (K / 8), c = idx % (K / 8);
      const bool ok = r < ns;
      const __nv_bfloat16* src =
          c < R / 8 ? ckvp + (row0 + r) * R + 8 * c
                    : kropep + (row0 + r) * DR + 8 * (c - R / 8);
      pd_cp_async16(dst + r * ROW + 8 * c, ok ? src : ckvp, ok);
    }
    if (t < MLA_TILE)
      pd_cp_async4(pos_s + st * MLA_TILE + t,
                   t < ns ? posp + row0 + t : posp, t < ns);
  };
  // the first STAGES - 1 tiles in flight, one commit group each
#pragma unroll
  for (int k = 0; k < MLA_STAGES - 1; ++k) {
    if (k < n_tiles) load_tile(k, k);
    pd_cp_async_commit();
  }

  // q, scaled to base 2, split into bf16 hi + lo rows; heads >= H are zero
#pragma unroll
  for (int k = 0; k < S::QN; ++k) {
    const int idx = t + k * MLA_NT;
    const int h = idx / (K / 4), c = 4 * (idx % (K / 4));
    const float x[4] = {qr[k].x, qr[k].y, qr[k].z, qr[k].w};
    if (idx < S::QF) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(x[e] * scale_log2, qhi[h * ROW + c + e],
                   qlo[h * ROW + c + e]);
    }
  }

  // softmax state of tile head t / 16 (its 16 threads hold copies); acc:
  // this warp's latent columns WC warp + 8 n + (2 (lane % 4), + 1), heads
  // lane / 4 (acc[n][0..1]) and lane / 4 + 8 (acc[n][2..3])
  float m = PD_NEG_INF, l = 0.f;
  float acc[2 * S::NJ][4];
#pragma unroll
  for (int n = 0; n < 2 * S::NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int g = lane / 4, tq = lane % 4;
  // ldmatrix addressing: A (row major, 16 x 16) and B (8 slots x 16)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int nh = warp & 1, kq = warp >> 1;   // score warp: slot half, k-quarter
  // the quarter's k-steps [ks0, ks1)
  const int ks0 = kq * S::KS / 4, ks1 = (kq + 1) * S::KS / 4;
  const int b_row = 8 * nh + (lane & 7), b_col = 8 * ((lane >> 3) & 1);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % MLA_STAGES;
    const int nx = it + MLA_STAGES - 1;   // its stage held tile it - 1
    if (nx < n_tiles) load_tile(nx, nx % MLA_STAGES);
    pd_cp_async_commit();
    pd_cp_async_wait<MLA_STAGES - 1>();   // tile it landed
    __syncthreads();
    const __nv_bfloat16* tile = tiles + st * MLA_TILE * ROW;

    // partial scores of (16 heads, slot half nh) over k-quarter kq
    {
      // four accumulator chains (hi / lo, even / odd k-steps), summed in
      // a fixed order
      float sa[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[j][e] = 0.f;
#pragma unroll
      for (int i = 0; i < S::KQ; ++i) {
        if (ks0 + i >= ks1) break;             // uniform in the warp
        const int k0 = 16 * (ks0 + i);
        uint32_t ah[4], al[4], kb[2];
        ldsm_x4(ah, qhi + a_row * ROW + k0 + a_col);
        ldsm_x4(al, qlo + a_row * ROW + k0 + a_col);
        ldsm_x2(kb, tile + b_row * ROW + k0 + b_col);
        mma16816(sa[2 * (i & 1)], ah, kb[0], kb[1]);
        mma16816(sa[2 * (i & 1) + 1], al, kb[0], kb[1]);
      }
      float* s = sc + kq * MLA_H * MLA_TILE;
      const int col = 8 * nh + 2 * tq;
      const int o[4] = {g * MLA_TILE + col, g * MLA_TILE + col + 1,
                        (g + 8) * MLA_TILE + col, (g + 8) * MLA_TILE + col + 1};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[o[e]] = (sa[0][e] + sa[2][e]) + (sa[1][e] + sa[3][e]);
    }
    __syncthreads();

    // one max, one sum and one rescale a head: thread (head t/16, slot t%16)
    {
      const int hh = t / MLA_TILE, sl = t % MLA_TILE;
      const int o = hh * MLA_TILE + sl;
      const float s = ((sc[o] + sc[MLA_H * MLA_TILE + o]) +
                       sc[2 * MLA_H * MLA_TILE + o]) +
                      sc[3 * MLA_H * MLA_TILE + o];
      const int pos = pos_s[st * MLA_TILE + sl];
      const int p0 = (it % tpp) * MLA_TILE;
      const bool valid = p0 + sl < P && pos >= 0 && pos <= cur;
      float mx = valid ? s : PD_NEG_INF;
#pragma unroll
      for (int d = 8; d > 0; d >>= 1)           // the head's 16 lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      const float m_new = fmaxf(m, mx);
      const float p = valid ? pd_ex2(s - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int d = 8; d > 0; d >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, d);
      const float a = pd_ex2(m - m_new);
      l = l * a + ps;
      m = m_new;
      split_bf16(p, phi[hh * MLA_PROW + sl], plo[hh * MLA_PROW + sl]);
      if (sl == 0) alpha_s[hh] = a;
    }
    __syncthreads();

    // acc = acc * alpha + p_hi . ckv + p_lo . ckv over the warp's columns
    {
      const float a0 = alpha_s[g], a1 = alpha_s[g + 8];
#pragma unroll
      for (int n = 0; n < 2 * S::NJ; ++n) {
        acc[n][0] *= a0; acc[n][1] *= a0;
        acc[n][2] *= a1; acc[n][3] *= a1;
      }
      uint32_t ph[4], pl[4];
      ldsm_x4(ph, phi + a_row * MLA_PROW + a_col);
      ldsm_x4(pl, plo + a_row * MLA_PROW + a_col);
#pragma unroll
      for (int j = 0; j < S::NJ; ++j) {
        const int d0 = S::WC * warp + 16 * j;
        uint32_t vb[4];
        ldsm_x4_t(vb, tile + a_row * ROW + d0 + a_col);
        mma16816(acc[2 * j], ph, vb[0], vb[1]);
        mma16816(acc[2 * j + 1], ph, vb[2], vb[3]);
        mma16816(acc[2 * j], pl, vb[0], vb[1]);
        mma16816(acc[2 * j + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();                  // stage st is consumed
  }
  pd_cp_async_wait<0>();
  __syncthreads();                    // q is no longer read (or written)

  // this block's state into its shared memory (acc over the q rows)
#pragma unroll
  for (int n = 0; n < 2 * S::NJ; ++n) {
    const int col = S::WC * warp + 8 * n + 2 * tq;
    *reinterpret_cast<float2*>(acc_s + g * R + col) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(acc_s + (g + 8) * R + col) =
        make_float2(acc[n][2], acc[n][3]);
  }
  if (t % MLA_TILE == 0) {
    ml[2 * (t / MLA_TILE)] = m;
    ml[2 * (t / MLA_TILE) + 1] = l;
  }
  cluster.sync();

  mla_merge<R>(cluster, ml, acc_s, out, b, H, h0, rank);
  cluster.sync();                     // the others have read this block
}

// The f32 instance: f32 latents are not exact in bf16, so the products run
// f32 FFMA on the CUDA cores, nothing rounded.  The page walk is the bf16
// kernel's; a block holds S::HT heads.  Each (head, slot) score is four
// fmaf chains over the K = R + DR latent row, chain x over the k = x mod
// 4, in k order, summed (0 + 1) + (2 + 3); a score lane holds one chain
// of a register patch of PH heads x PS slots, so each q and latent value it
// loads feeds several outputs, and writes each chain's sum to sc.  The other warps copy the tiles in and run a tile's
// online softmax (base 2; thread (head, slot), its head's max and sum over
// 16 lanes, slot i with i ^ 8, then ^ 4, ^ 2, ^ 1) and P.V one tile behind
// the scores, one barrier a tile: a P.V thread holds PVH heads x PVC
// latent columns, and each output takes the tile's alpha, then its 16
// slots in order.  At the end each rank writes its (m, l) and the acc
// columns rank r merges into rank r's memory, one cluster barrier, and
// rank r folds them over the ranks in order, as mla_merge does.  No output
// depends on which thread computes it or on the other heads of its tile,
// so the launch constants change no bit, and the row-invariance holds as
// above.
template <int R, int DR>
__global__ void __cluster_dims__(MLA_CL, 1, 1)
__launch_bounds__(MLA_NT, MlaF32Shape<R, DR>::BLOCKS)
mla_decode_f32_kernel(const float* __restrict__ q_lat,
                      const float* __restrict__ q_rope,
                      const float* __restrict__ ckvp,
                      const float* __restrict__ kropep,
                      const int* __restrict__ posp, const int* __restrict__ bt,
                      int bt_stride, const int* __restrict__ cur_pos,
                      float* __restrict__ out, int H, int P, int n_blk,
                      float scale_log2) {
  using S = MlaF32Shape<R, DR>;
  constexpr int K = S::K, ROW = S::ROW, HT = S::HT, STAGES = S::STAGES;
  constexpr int PH = S::PH, PS = S::PS, SG = S::SG;
  constexpr int PVH = S::PVH, PVC = S::PVC, NCG = S::NCG;
  constexpr int PROW = S::PROW;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CW = S::CW;
  float* qs = reinterpret_cast<float*>(smem);     // [HT][ROW], base-2 scaled
  float* tiles = qs + HT * ROW;                   // [STAGES][TILE][ROW]
  float* recv = tiles + STAGES * MLA_TILE * ROW;  // [CL][HT][CW]
  float* recv_ml = recv + HT * R;                 // [CL][HT][2]: m, l
  int* pos_s = reinterpret_cast<int*>(recv_ml + MLA_CL * HT * 2);
  float* sc = reinterpret_cast<float*>(pos_s + STAGES * MLA_TILE);
                                                  // [2][4][HT][TILE]
  float* ps = sc + 2 * 4 * HT * MLA_TILE;         // [TILE][PROW]
  float* alpha_s = ps + MLA_TILE * PROW;          // [HT]
  int* n_pages_s = reinterpret_cast<int*>(alpha_s + HT);
  int* list = reinterpret_cast<int*>(smem + S::FIXED_BYTES);

  cg::cluster_group cluster = cg::this_cluster();
  mla_cluster_arrive_relaxed();     // this block has started (waited below,
                                    // before any rank writes into another)
  const int rank = (int)cluster.block_rank(), b = blockIdx.y;
  const int h0 = HT * blockIdx.z;
  const int t = threadIdx.x;
  const int cur = cur_pos[b];
  const int tpp = (P + MLA_TILE - 1) / MLA_TILE;

  // q (heads >= H zero) copied in its own group, so its read overlaps the
  // table's and the first tiles'; each thread scales its own float4s
  // below, once they landed
  for (int idx = t; idx < S::QF; idx += MLA_NT) {
    const int h = idx / (K / 4), c = 4 * (idx % (K / 4));
    const size_t hb = (size_t)b * H + h0 + h;
    const bool ok = h0 + h < H;
    const float* src = c < R ? q_lat + hb * R + c : q_rope + hb * DR + c - R;
    pd_cp_async16(qs + h * ROW + c, ok ? src : q_lat, ok);
  }
  pd_cp_async_commit();
  mla_page_list(bt + (size_t)b * bt_stride, n_blk, rank, list, n_pages_s);
  __syncthreads();
  const int n_tiles = *n_pages_s * tpp;

  // tile it -> stage st, by the copy threads u = t - SC_THREADS: 16 latent
  // rows (ckv then krope, one shared row a slot), rows past the page
  // zero-filled; the slots' positions beside
  const int u = t - S::SC_THREADS;
  auto load_tile = [&](int it, int st) {
    if (u < 0) return;
    const int page = list[it / tpp], p0 = (it % tpp) * MLA_TILE;
    const int ns = min(MLA_TILE, P - p0);
    const size_t row0 = (size_t)page * P + p0;
    float* dst = tiles + st * MLA_TILE * ROW;
    // ckv: float4 column c, rows r0 .. r0 + TILE / CG - 1
    for (int j = u; j < S::CG * (R / 4); j += S::LOADERS) {
      const int c = 4 * (j % (R / 4));
      const int r0 = (j / (R / 4)) * (MLA_TILE / S::CG);
      const float* src = ckvp + row0 * R + c;
#pragma unroll
      for (int r = r0; r < r0 + MLA_TILE / S::CG; ++r)
        pd_cp_async16(dst + r * ROW + c, r < ns ? src + r * R : ckvp, r < ns);
    }
    // krope: (row, float4 column) pairs
    for (int j = u; j < MLA_TILE * (DR / 4); j += S::LOADERS) {
      const int r = j / (DR / 4), c = 4 * (j % (DR / 4));
      pd_cp_async16(dst + r * ROW + R + c,
                    r < ns ? kropep + (row0 + r) * DR + c : kropep, r < ns);
    }
    if (u < MLA_TILE)
      pd_cp_async4(pos_s + st * MLA_TILE + u,
                   u < ns ? posp + row0 + u : posp, u < ns);
  };
  // the first STAGES - 2 tiles in flight, one commit group each (a stage
  // is refilled two tiles after its own: P.V reads it one tile late)
#pragma unroll
  for (int k = 0; k < STAGES - 2; ++k) {
    if (k < n_tiles) load_tile(k, k);
    pd_cp_async_commit();
  }
  pd_cp_async_wait<STAGES - 2>();                 // this thread's q landed
  for (int idx = t; idx < S::QF; idx += MLA_NT) {
    const int h = idx / (K / 4), c = 4 * (idx % (K / 4));
    float4* v = reinterpret_cast<float4*>(qs + h * ROW + c);
    const float4 x = *v;
    *v = make_float4(x.x * scale_log2, x.y * scale_log2, x.z * scale_log2,
                     x.w * scale_log2);
  }

  // score lanes: chain e, slot group sg, head group hg
  const bool scorer = t < S::SC_THREADS;
  const int e = t % 4, sg = (t / 4) % SG, hg = t / (4 * SG);
  // the softmax state of head u / 16 (its 16 threads hold copies)
  const bool smx = u >= 0 && u < HT * MLA_TILE;
  const int hh = u / MLA_TILE, sl = u % MLA_TILE;
  float m = PD_NEG_INF, l = 0.f;
  // P.V: heads hp .. hp + PVH - 1, float4 column groups colg + NCG k
  const bool pv = u >= 0 && u < S::PV_THREADS;
  const int colg = u % NCG, hp = PVH * (u / NCG);
  float acc[PVH][PVC];
#pragma unroll
  for (int i = 0; i < PVH; ++i)
#pragma unroll
    for (int c = 0; c < PVC; ++c) acc[i][c] = 0.f;

  // step it: the scores of tile it; the softmax and P.V of tile it - 1
  for (int it = 0; it <= n_tiles; ++it) {
    pd_cp_async_wait<STAGES - 3>();       // tile it landed
    __syncthreads();                      // ... for all; the scores of tile
                                          // it - 1 written; tile it - 2
                                          // consumed
    {
      const int nx = it + STAGES - 2;     // into tile it - 2's stage
      if (nx < n_tiles) load_tile(nx, nx % STAGES);
      pd_cp_async_commit();
    }

    if (scorer && it < n_tiles) {
      // the patch's chains over k, each chain's sum into sc
      const float* tile = tiles + (it % STAGES) * MLA_TILE * ROW;
      const float* qrow = qs + PH * hg * ROW + e;
      const float* krow = tile + sg * ROW + e;
      float sa[PH][PS];
#pragma unroll
      for (int i = 0; i < PH; ++i)
#pragma unroll
        for (int j = 0; j < PS; ++j) sa[i][j] = 0.f;
#pragma unroll F32_SC_UNROLL
      for (int c = 0; c < K; c += 4) {
        float qv[PH], kv[PS];
#pragma unroll
        for (int i = 0; i < PH; ++i) qv[i] = qrow[i * ROW + c];
#pragma unroll
        for (int j = 0; j < PS; ++j) kv[j] = krow[SG * j * ROW + c];
#pragma unroll
        for (int i = 0; i < PH; ++i)
#pragma unroll
          for (int j = 0; j < PS; ++j)
            sa[i][j] = fmaf(qv[i], kv[j], sa[i][j]);
      }
      float* s_out = sc + (it & 1) * 4 * HT * MLA_TILE;
#pragma unroll
      for (int i = 0; i < PH; ++i)
#pragma unroll
        for (int j = 0; j < PS; ++j)
          s_out[(e * HT + PH * hg + i) * MLA_TILE + sg + SG * j] = sa[i][j];
    }

    if (it > 0 && u >= 0) {
      const int pt = it - 1;
      // one max, one sum and one rescale a head over its 16 slots: thread
      // (head hh, slot sl), the chains summed (0 + 1) + (2 + 3)
      if (smx) {
        const float* s_in = sc + (pt & 1) * 4 * HT * MLA_TILE +
                            hh * MLA_TILE + sl;
        const int o = HT * MLA_TILE;
        const float s = (s_in[0] + s_in[o]) + (s_in[2 * o] + s_in[3 * o]);
        const int pos = pos_s[(pt % STAGES) * MLA_TILE + sl];
        const int p0 = (pt % tpp) * MLA_TILE;
        const bool valid = p0 + sl < P && pos >= 0 && pos <= cur;
        float mx = valid ? s : PD_NEG_INF;
#pragma unroll
        for (int d = 8; d > 0; d >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
        const float m_new = fmaxf(m, mx);
        const float p = valid ? pd_ex2(s - m_new) : 0.f;
        float psum = p;
#pragma unroll
        for (int d = 8; d > 0; d >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, d);
        const float a = pd_ex2(m - m_new);
        l = l * a + psum;
        m = m_new;
        ps[sl * PROW + hh] = p;
        if (sl == 0) alpha_s[hh] = a;
      }
      mla_bar_sync(1, S::LOADERS);        // this tile's p among these warps

      // acc = acc * alpha + p . ckv over the thread's heads and columns
      if (pv) {
        const float* tile = tiles + (pt % STAGES) * MLA_TILE * ROW;
#pragma unroll
        for (int i = 0; i < PVH; ++i) {
          const float a = alpha_s[hp + i];
#pragma unroll
          for (int c = 0; c < PVC; ++c) acc[i][c] *= a;
        }
#pragma unroll 4
        for (int j = 0; j < MLA_TILE; ++j) {
          float4 v[PVC / 4], p4[PVH / 4];
#pragma unroll
          for (int k = 0; k < PVC / 4; ++k)
            v[k] = *reinterpret_cast<const float4*>(tile + j * ROW +
                                                    4 * (colg + NCG * k));
#pragma unroll
          for (int k = 0; k < PVH / 4; ++k)
            p4[k] = *reinterpret_cast<const float4*>(ps + j * PROW + hp +
                                                     4 * k);
#pragma unroll
          for (int i = 0; i < PVH; ++i) {
            const float4 q4 = p4[i / 4];
            const float p = i % 4 == 0 ? q4.x : i % 4 == 1 ? q4.y
                          : i % 4 == 2 ? q4.z : q4.w;
#pragma unroll
            for (int k = 0; k < PVC / 4; ++k) {
              acc[i][4 * k] = fmaf(p, v[k].x, acc[i][4 * k]);
              acc[i][4 * k + 1] = fmaf(p, v[k].y, acc[i][4 * k + 1]);
              acc[i][4 * k + 2] = fmaf(p, v[k].z, acc[i][4 * k + 2]);
              acc[i][4 * k + 3] = fmaf(p, v[k].w, acc[i][4 * k + 3]);
            }
          }
        }
      }
    }
  }
  pd_cp_async_wait<0>();
  // each rank's state of the columns rank r merges into rank r's recv,
  // once every block of the cluster has started
  mla_cluster_wait();
  if (pv) {
#pragma unroll
    for (int k = 0; k < PVC / 4; ++k) {
      const int c = 4 * (colg + NCG * k);
      float* dst = cluster.map_shared_rank(recv, c / CW) + c % CW;
#pragma unroll
      for (int i = 0; i < PVH; ++i)
        *reinterpret_cast<float4*>(dst + (rank * HT + hp + i) * CW) =
            make_float4(acc[i][4 * k], acc[i][4 * k + 1], acc[i][4 * k + 2],
                        acc[i][4 * k + 3]);
    }
  }
  if (smx && sl < MLA_CL)               // head hh's (m, l) into rank sl
    *reinterpret_cast<float2*>(cluster.map_shared_rank(recv_ml, sl) +
                               2 * (rank * HT + hh)) = make_float2(m, l);
  cluster.sync();                     // every rank's state has landed
  // columns [CW rank, CW rank + CW) of every head over the ranks in order
  // (mla_fold); nothing in another block is read, so no block waits for
  // the others before it exits
  {
    constexpr int TPH = CW / 4;
    static_assert(MLA_NT / TPH >= HT, "a merge pass covers the tile's heads");
    if (t / TPH < HT) {
      const int hh = t / TPH, c0 = 4 * (t % TPH);   // head, columns
      float mr[MLA_CL], lr[MLA_CL];
      float4 vr[MLA_CL];
#pragma unroll
      for (int r = 0; r < MLA_CL; ++r) {
        mr[r] = recv_ml[2 * (r * HT + hh)];
        lr[r] = recv_ml[2 * (r * HT + hh) + 1];
        vr[r] = *reinterpret_cast<const float4*>(recv + (r * HT + hh) * CW +
                                                 c0);
      }
      const float4 o = mla_fold(mr, lr, vr);
      if (h0 + hh < H)
        *reinterpret_cast<float4*>(out + ((size_t)b * H + h0 + hh) * R +
                                   CW * rank + c0) = o;
    }
  }
}

// the kernel of the latents' element type T, its head tile and its shared
// memory past the page list (only the instance of T is instantiated: bf16
// has no (32, 16) body)
template <int R, int DR, class T>
struct MlaInstance {
  static constexpr int HT = MLA_H;
  static constexpr int FIXED_BYTES = MlaShape<R, DR>::FIXED_BYTES;
  static auto kernel() { return mla_decode_kernel<R, DR>; }
  static cudaError_t configure() { return cudaSuccess; }
};
template <int R, int DR>
struct MlaInstance<R, DR, float> {
  static constexpr int HT = MlaF32Shape<R, DR>::HT;
  static constexpr int FIXED_BYTES = MlaF32Shape<R, DR>::FIXED_BYTES;
  static auto kernel() { return mla_decode_f32_kernel<R, DR>; }
  // the shared memory an SM keeps for the blocks the launch bound asks for
  static cudaError_t configure() {
    return cudaFuncSetAttribute(kernel(),
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }
};

// T: the latents' element type
template <int R, int DR, class T>
static int mla_launch(const void* q_lat, const void* q_rope,
                      const void* ckvp, const void* kropep, const void* posp,
                      const void* bt, const void* cur_pos, void* out, int B,
                      int H, int P, int n_blk, int bt_stride, float scale,
                      cudaStream_t stream) {
  using I = MlaInstance<R, DR, T>;
  const auto kernel = I::kernel();
  const size_t list_bytes = 4 * (size_t)((n_blk + MLA_CL - 1) / MLA_CL + 1);
  const size_t smem = I::FIXED_BYTES + list_bytes;
  if (smem > MLA_SMEM_MAX || H > 65535 * I::HT)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;        // one flag an instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MLA_SMEM_MAX);
    if (e == cudaSuccess) e = I::configure();
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(MLA_CL, B, (H + I::HT - 1) / I::HT);
  kernel<<<grid, MLA_NT, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const T*>(ckvp), static_cast<const T*>(kropep),
      static_cast<const int*>(posp), static_cast<const int*>(bt), bt_stride,
      static_cast<const int*>(cur_pos), static_cast<float*>(out), H, P, n_blk,
      PD_LOG2E * scale);
  return (int)cudaGetLastError();
}

// The f32 instance's launch shape at (R, DR) for B rows, H heads and a
// table of n_blk columns, into out[0..7]: heads a block, blocks, ring
// stages, shared memory bytes a block, blocks an SM its launch bound asks
// for, score threads, P.V threads, and the clusters the card keeps
// resident at once (cudaOccupancyMaxActiveClusters; -1 where it fails).
// Returns cudaErrorInvalidValue for an (R, DR) without an f32 instance.
template <int R, int DR>
static int mla_f32_shape(int* out, int B, int H, int n_blk) {
  using S = MlaF32Shape<R, DR>;
  using I = MlaInstance<R, DR, float>;
  const int smem = S::FIXED_BYTES + 4 * ((n_blk + MLA_CL - 1) / MLA_CL + 1);
  const int tiles = (H + S::HT - 1) / S::HT;
  out[0] = S::HT;
  out[1] = MLA_CL * B * tiles;
  out[2] = S::STAGES;
  out[3] = smem;
  out[4] = S::BLOCKS;
  out[5] = S::SC_THREADS;
  out[6] = S::PV_THREADS;
  out[7] = -1;
  const auto kernel = I::kernel();
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MLA_SMEM_MAX) == cudaSuccess &&
      I::configure() == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(MLA_CL, B, tiles);
    cfg.blockDim = dim3(MLA_NT, 1, 1);
    cfg.dynamicSmemBytes = smem;
    int n = -1;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess)
      out[7] = n;
  }
  cudaGetLastError();                    // a failed query leaves no error
  return 0;
}

extern "C" int flash_decode_paged_mla_f32_shape(void* out, int B, int H,
                                                int R, int DR, int n_blk,
                                                void* stream) {
  (void)stream;
  int* o = static_cast<int*>(out);
  if (R == 512 && DR == 64) return mla_f32_shape<512, 64>(o, B, H, n_blk);
  if (R == 256 && DR == 32) return mla_f32_shape<256, 32>(o, B, H, n_blk);
  if (R == 32 && DR == 16) return mla_f32_shape<32, 16>(o, B, H, n_blk);
  return (int)cudaErrorInvalidValue;
}

// Latents bf16, or f32 when f32 is nonzero.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an (R, DR) without an
// instantiation of the latents' type, a batch or head count past the grid,
// or a table too wide for the page list).  One launch; no scratch.
extern "C" int flash_decode_paged_mla_launch(
    const void* q_lat, const void* q_rope, const void* ckvp,
    const void* kropep, const void* posp, const void* bt, const void* cur_pos,
    void* out, int B, int H, int R, int DR, int P, int n_blk, int bt_stride,
    int f32, float scale, void* stream) {
  if (H < 1 || P < 1 || n_blk < 0 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define MLA_CASE(r, dr, T)                                                   \
  if (R == r && DR == dr)                                                    \
    return mla_launch<r, dr, T>(q_lat, q_rope, ckvp, kropep, posp, bt,       \
                                cur_pos, out, B, H, P, n_blk, bt_stride,     \
                                scale, s);
  if (f32) {
    MLA_CASE(512, 64, float)
    MLA_CASE(256, 32, float)
    MLA_CASE(32, 16, float)
  } else {
    MLA_CASE(512, 64, __nv_bfloat16)
    MLA_CASE(256, 32, __nv_bfloat16)
  }
#undef MLA_CASE
  return (int)cudaErrorInvalidValue;
}
