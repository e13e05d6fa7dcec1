// moe_gmm_quant: ragged grouped SwiGLU over the sorted, tile-aligned MoE
// buffer, on int8- or int4-stored expert weights widened on chip.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py::moe_gmm_quant_pallas.
// Contract (identical): xs [M, D] bf16 or f32 (the reference takes any
// float xs and writes xs.dtype) rows sorted by expert, each row tile
// of block_m rows belongs to one expert; tile_expert[i] names tile i's
// expert and tile_valid[i] is 1 iff the tile holds a real row.
//   int8: w1q [E, D, 2F], w2q [E, F, D];
//   int4: w1q [E, D/2, 2F] packed along D (the contraction), w2q
//         [E, F, D/2] packed along D (the output), blocked halves
//         (quant_common.cuh);
//   s1 [E, 2, F] f32 (gate scales, then up scales), s2 [E, F] f32.
// out = (silu(gate * s1[e,0]) * (up * s1[e,1]) * s2[e]) @ w2q[e] per tile,
// gate / up = xs @ the first / next F columns of w1q[e]: s1 applies after
// the first product (constant along D), s2 folds into h before the second
// (it varies along the F contraction), no scale after it; out in xs's
// dtype.  Dead tiles write zeros and do no math.
//
// What bounds it on the H100: at the serving shapes (D 2048, F 1024, 64
// experts, 512 tokens x top-8) every expert is routed, so one call must
// stream all 64 experts' weights: 403 MB in int8, 201 MB in int4, against
// B1's 805 MB of bf16 -- about 0.13 / 0.07 ms at 3.35 TB/s.  The tensor
// cores run every row of every live tile (there about 70 tiles of 128
// rows: 113 GFLOP, 0.11 ms at 989 TFLOP/s), so int4 is held by its
// products, not by its bytes.
//
// Design: B1's machinery (wgmma_tiles.cuh: a producer thread's TMA ring
// of 128-byte-swizzled boxes, two consumer warpgroups on wgmma, 3-D maps
// that zero-fill past F), on the transposed products
//   pass 1 (up):   h^T = silu(s1g * W1g^T x^T) * (s1u * W1u^T x^T) * s2,
//                  rounded to bf16, for 128 f columns a block;
//   pass 2 (down): out^T = W2^T h^T, for 256 output columns a block,
// so that the weights are wgmma's A operand, taken from registers, and the
// activation rows its B operand, K-major in shared memory as TMA lands
// them (N = the tile's rows, 64 or 128).  The weights travel as int8: a
// box of 64 k rows x 128 bytes is 128 int8 columns, or 128 packed int4
// columns of two values.  Each consumer warp reads its 16 columns of a
// k16 slice with one ldmatrix .trans (the 128-byte swizzle undone in the
// address): lane l gets the bytes of k rows 2q, 2q + 1 at columns 2g,
// 2g + 1 (g = l / 4, q = l % 4), which is mma's A fragment once the
// warp's 16 rows of A are ordered columns 0, 2, .., 14, 1, 3, .., 15.
// The bytes are widened in registers to exact bf16 pairs, a word at a
// time (quant_common.cuh), and the weights never make a second trip
// through shared memory.  Warpgroup w owns A rows (weight columns) 64w..
// of each operand: in pass 1 the gate and the up columns of the same f,
// so SwiGLU and the per-column s1 and s2 apply in its registers; in pass
// 2 two sets of output columns (int8: the block's two 128-column boxes;
// int4: the low and the high nibbles of one packed box, columns c and
// D/2 + c).  int4 in pass 1: one packed box feeds two contractions, its
// low nibbles against the x box at k0 and its high ones against the x box
// at D/2 + k0.  The products on the integer values are exact in the f32
// accumulators up to summation order, so they are the plain version's.
// h is stored in bf16 between the passes, as the plain version rounds it.
// The producer is one warp (no setmaxnreg: a block of 9 warps keeps 168
// registers a thread, as B1's 12 do).  Ragged F (any multiple of 32): TMA
// zero-fills the boxes past F in both passes, and pass 1 stores only the
// columns below F.  block_m is any multiple of 8 up to 128: N is 64 up to
// 64 rows, else 128, and the rows past a tile are computed from the next
// tile's rows (or zeros) and never stored.
//
// f32 xs (the f32 instance, below): no tensor-core form takes f32 x f32
// without rounding an operand (wgmma's TF32 keeps about three digits), so
// it runs f32_sgemm.cuh's register-tiled FFMA body, as B1's and B9's f32
// instances do, on the rows each tile really holds (moe_gmm.cu), with a
// weight stager that copies the int8 / int4 bytes into its ring and
// widens each to f32 once, after it lands (``QCols``), and the scaled
// SwiGLU as pass 1's epilogue; h stays f32 between the passes, as the f32
// plain version keeps it, and nothing rounds to bf16 or TF32.  The bf16
// instance is the code it was.

#include "f32_sgemm.cuh"
#include "quant_common.cuh"
#include "wgmma_tiles.cuh"

using namespace wgt;

constexpr int RING_BYTES = 192 * 1024;   // a pass's ring, at most
constexpr int MAX_STAGES = 8;
constexpr int UP_COLS = 128;             // f columns of a pass-1 block
// two consumer warpgroups and one producer warp
constexpr int Q_THREADS = 128 * CONSUMERS + 32;

// Boxes of a stage: the activation rows (N / 64 boxes; int4 pass 1: twice,
// at k0 and at D/2 + k0), then the weights (pass 1: gate and up; pass 2:
// two boxes of int8, one of packed int4).
__host__ __device__ constexpr int x_boxes(bool up, bool packed, int n) {
  return (up && packed ? 2 : 1) * (n / 64);
}
__host__ __device__ constexpr int w_boxes(bool up, bool packed) {
  return up || !packed ? 2 : 1;
}
__host__ __device__ constexpr int q_stage_bytes(bool up, bool packed, int n) {
  return (x_boxes(up, packed, n) + w_boxes(up, packed)) * BOX_BYTES;
}
__host__ __device__ constexpr int q_stages(bool up, bool packed, int n) {
  return RING_BYTES / q_stage_bytes(up, packed, n) < MAX_STAGES
             ? RING_BYTES / q_stage_bytes(up, packed, n)
             : MAX_STAGES;
}
__host__ __device__ constexpr int down_cols(bool packed) {   // stored columns
  return packed ? 128 : 256;
}

// The A operands of one k16 slice for a warp: the bytes of its 16 weight
// columns of NF k16 x 16 fragments (r[2f], r[2f + 1]: fragment f's k rows
// 0-7 and 8-15), widened into a[f] (int4: the low nibbles into a[f], the
// high ones into a[NF + f]).
template <bool PACKED, int NF>
__device__ __forceinline__ void widen_slice(
    const uint32_t (&r)[4], uint32_t (&a)[PACKED ? 2 * NF : NF][4]) {
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {           // k rows 0-7, then 8-15
      const uint32_t w = r[2 * f + h];
      if constexpr (PACKED) {
        uint32_t lo[2], hi[2];
        widen_i4(w, lo, hi);
        a[f][2 * h] = lo[0];
        a[f][2 * h + 1] = lo[1];
        a[NF + f][2 * h] = hi[0];
        a[NF + f][2 * h + 1] = hi[1];
      } else {
        widen_i8(w, a[f][2 * h], a[f][2 * h + 1]);
      }
    }
}

// A consumer warpgroup ``wg`` over the nk stages: acc[t] (t = 0, 1) +=
// A_t B, A_t (64 weight columns, as rows) of operand t and B the stage's
// activation rows.  Pass 1: operands gate and up; int4 adds their high
// nibbles times the second x box set (k + D/2).  Pass 2: int8, the two
// boxes' columns; int4, the low and the high nibbles of one box.  For each
// k16 slice the warpgroup widens its operands, issues their wgmmas as one
// group and waits for it, while the other warpgroup's group runs: ptxas
// serialises a warpgroup's wgmmas if their register operands are written
// while a group of it is in flight, and widening a whole stage first
// needs registers the 128 accumulators leave no room for.  A stage goes
// back to the producer after its last slice.
template <bool UP, bool PACKED, int N, int STAGES>
__device__ __forceinline__ void consume_q(float (&acc)[2][N / 2],
                                          uint8_t* ring, uint64_t* full,
                                          uint64_t* empty, int nk, int wg) {
  constexpr int SB = q_stage_bytes(UP, PACKED, N);
  constexpr int XB = (N / 64) * BOX_BYTES;
  constexpr int W0 = x_boxes(UP, PACKED, N) * BOX_BYTES;
  constexpr int NF = w_boxes(UP, PACKED);       // fragments a slice
  constexpr int NA = PACKED ? 2 * NF : NF;      // A operands a slice
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[t][i] = 0.f;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int chunk = 4 * wg + warp;     // the warp's 16-byte column chunk
  const int row = lane % 16;           // the k row a lane addresses
  const int box = NF == 2 ? lane / 16 : 0;   // .x4: lanes 16-31, box 1
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* st = ring + s * SB;
    const uint32_t wrow = smem_u32(st + W0 + box * BOX_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int r = kk * 16 + row;
      const uint32_t addr = wrow + r * 128 + ((chunk ^ (r & 7)) << 4);
      uint32_t m[4] = {0u, 0u, 0u, 0u}, a[NA][4];
      if constexpr (NF == 2) {
        ldsm_x4_trans(m, addr);
      } else {
        uint32_t m2[2];
        ldsm_x2_trans(m2, addr);
        m[0] = m2[0];
        m[1] = m2[1];
      }
      widen_slice<PACKED, NF>(m, a);
      wgmma_fence();
      const uint64_t b0 = desc_k(st + kk * 32);
#pragma unroll
      for (int t = 0; t < 2; ++t) wgmma_rs<N>(acc[t], a[t], b0);
      if constexpr (UP && PACKED) {
        const uint64_t b1 = desc_k(st + XB + kk * 32);
#pragma unroll
        for (int t = 0; t < 2; ++t) wgmma_rs<N>(acc[t], a[2 + t], b1);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// This thread's first weight column of its warpgroup's 64 (then + 1):
// A row g of the warp is column 2g, row g + 8 column 2g + 1.
__device__ __forceinline__ int q_col(int wg) {
  return 64 * wg + 16 * ((threadIdx.x / 32) % 4) + 2 * ((threadIdx.x % 32) / 4);
}

template <bool PACKED, int N>
__global__ void __launch_bounds__(Q_THREADS, 1)
gmmq_up_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w1,
               const float* __restrict__ s1, const float* __restrict__ s2,
               const int* __restrict__ tile_expert,
               const int* __restrict__ tile_valid, bf16* __restrict__ h,
               int D, int F, int block_m) {
  constexpr int STAGES = q_stages(true, PACKED, N);
  constexpr int SB = q_stage_bytes(true, PACKED, N);
  constexpr int XB = (N / 64) * BOX_BYTES;
  const int tile = blockIdx.y;
  if (!tile_valid[tile]) return;                // pass 2 writes the zeros
  extern __shared__ uint8_t dyn_smem[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  uint8_t* ring = ring_base(dyn_smem);
  ring_init<STAGES>(full, empty, CONSUMERS);
  const int e = tile_expert[tile], row0 = tile * block_m;
  const int f0 = blockIdx.x * UP_COLS;
  const int Dp = PACKED ? D / 2 : D;            // stored rows of w1q[e]
  const CUtensorMap* mx = &tm_x;
  const CUtensorMap* mw = &tm_w1;
  if (threadIdx.x >= PRODUCER) {
    if (threadIdx.x == PRODUCER)
      produce<STAGES, SB>(
          ring, full, empty, Dp / BK, SB,
          [=](int i, uint8_t* st, uint64_t* bar) {
            const int k0 = i * BK;
            for (int a = 0; a < N / 64; ++a) {
              tma_load_3d(st + a * BOX_BYTES, mx, bar, k0, row0 + 64 * a, 0);
              if (PACKED)
                tma_load_3d(st + XB + a * BOX_BYTES, mx, bar, D / 2 + k0,
                            row0 + 64 * a, 0);
            }
            uint8_t* sw = st + x_boxes(true, PACKED, N) * BOX_BYTES;
            tma_load_3d(sw, mw, bar, f0, 0, e * Dp + k0);        // gate
            tma_load_3d(sw + BOX_BYTES, mw, bar, f0, 1, e * Dp + k0);
          });
  } else {
    const int wg = threadIdx.x / 128;
    float acc[2][N / 2];                        // gate, up
    consume_q<true, PACKED, N, STAGES>(acc, ring, full, empty, Dp / BK, wg);
    const int f = f0 + q_col(wg), q = threadIdx.x % 4;
    if (f < F) {                                // F % 32 == 0: f + 1 < F too
      const float* sg = s1 + (size_t)e * 2 * F + f;
      const float* sd = s2 + (size_t)e * F + f;
      const float g_s[2] = {sg[0], sg[1]}, u_s[2] = {sg[F], sg[F + 1]};
      const float d_s[2] = {sd[0], sd[1]};
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = 8 * j + 2 * q + c;      // the tile's row
          float v[2];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {      // columns f, f + 1
            const float g = acc[0][4 * j + 2 * hf + c] * g_s[hf];
            const float u = acc[1][4 * j + 2 * hf + c] * u_s[hf];
            v[hf] = g / (1.0f + __expf(-g)) * u * d_s[hf];
          }
          if (n < block_m)
            *reinterpret_cast<__nv_bfloat162*>(
                h + (size_t)(row0 + n) * F + f) = __floats2bfloat162_rn(v[0], v[1]);
        }
    }
  }
}

template <bool PACKED, int N>
__global__ void __launch_bounds__(Q_THREADS, 1)
gmmq_down_kernel(const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_w2,
                 const int* __restrict__ tile_expert,
                 const int* __restrict__ tile_valid, bf16* __restrict__ out,
                 int D, int F, int block_m) {
  constexpr int STAGES = q_stages(false, PACKED, N);
  constexpr int SB = q_stage_bytes(false, PACKED, N);
  constexpr int COLS = down_cols(PACKED);
  const int tile = blockIdx.y, row0 = tile * block_m;
  const int Dp = PACKED ? D / 2 : D;            // stored columns of w2q[e]
  const int c0 = blockIdx.x * COLS;             // stored column block
  if (!tile_valid[tile]) {                      // dead tile: zeros, no math
    const int vecs = min(COLS, Dp - c0) / 8;    // Dp % 64 == 0
    for (int i = threadIdx.x; i < block_m * vecs; i += Q_THREADS) {
      bf16* o = out + (size_t)(row0 + i / vecs) * D + c0 + (i % vecs) * 8;
      *reinterpret_cast<uint4*>(o) = make_uint4(0u, 0u, 0u, 0u);
      if (PACKED)
        *reinterpret_cast<uint4*>(o + D / 2) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  extern __shared__ uint8_t dyn_smem[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  uint8_t* ring = ring_base(dyn_smem);
  ring_init<STAGES>(full, empty, CONSUMERS);
  const int e = tile_expert[tile];
  const int nk = (F + BK - 1) / BK;
  const CUtensorMap* mh = &tm_h;
  const CUtensorMap* mw = &tm_w2;
  if (threadIdx.x >= PRODUCER) {
    if (threadIdx.x == PRODUCER)
      produce<STAGES, SB>(
          ring, full, empty, nk, SB, [=](int i, uint8_t* st, uint64_t* bar) {
            const int k0 = i * BK;
            for (int a = 0; a < N / 64; ++a)
              tma_load_3d(st + a * BOX_BYTES, mh, bar, k0, row0 + 64 * a, 0);
            uint8_t* sw = st + x_boxes(false, PACKED, N) * BOX_BYTES;
            for (int b = 0; b < w_boxes(false, PACKED); ++b)
              tma_load_3d(sw + b * BOX_BYTES, mw, bar, c0 + 128 * b, k0, e);
          });
  } else {
    const int wg = threadIdx.x / 128;
    float acc[2][N / 2];
    consume_q<false, PACKED, N, STAGES>(acc, ring, full, empty, nk, wg);
    const int c = c0 + q_col(wg), q = threadIdx.x % 4;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      // int8: columns c + 128 t; int4: c (low nibbles), D/2 + c (high)
      const int d = PACKED ? c + t * (D / 2) : c + 128 * t;
      const bool live = (PACKED ? c : c + 128 * t) < Dp;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int n = 8 * j + 2 * q + cc;
          if (live && n < block_m)
            *reinterpret_cast<__nv_bfloat162*>(
                out + (size_t)(row0 + n) * D + d) =
                __floats2bfloat162_rn(acc[t][4 * j + cc], acc[t][4 * j + 2 + cc]);
        }
    }
  }
}

// ---- f32 activations: f32_sgemm.cuh's row-tile body on widened weights ----

// The launch's shape (tools/expert_kernel_variants.py times others): as
// moe_gmm.cu's f32 instance.
constexpr int F32_STAGES = 2;     // the cp.async ring's stages
constexpr int F32_BK = 16;        // contraction rows a stage
constexpr int F32_MIN_TM = 4;     // rows a thread at least past 16 rows
constexpr int F32_MIN_BLOCKS = 2;
constexpr bool F32_SKIP = true;   // warps past a tile's rows skip FFMAs

// Four int8 of a word as f32, in column order (exact).
__device__ __forceinline__ float4 i8x4_f32(uint32_t w) {
  const uint32_t o = w ^ 0x80808080u;
  return make_float4(i8_f32<0>(o), i8_f32<1>(o), i8_f32<2>(o), i8_f32<3>(o));
}

// The low (hi false) or high nibbles of four packed int4 bytes as f32, in
// column order (exact; (n ^ 8) - 8 sign-extends a nibble).
__device__ __forceinline__ float4 i4x4_f32(uint32_t w, bool hi) {
  const uint32_t n = hi ? w >> 4 : w;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = (float)((int)(((n >> (8 * j)) & 0xFu) ^ 8u) - 8);
  return make_float4(v[0], v[1], v[2], v[3]);
}

// How a weight matrix stores its values: int8, or int4 in blocked halves
// along the contraction (w1q: row k < K/2 in the low nibbles of stored row
// k, row K/2 + k in the high ones) or along the columns (w2q: column c <
// N/2 in the low nibbles of stored column c, N/2 + c in the high ones).
enum QLayout { Q_INT8, Q_INT4_ROWS, Q_INT4_COLS };

// f32_sgemm.cuh's weight stager for quantized weights: two groups of 64
// columns, group g's first stored column at b[g] (row 0; ld bytes a
// stored row), n[g] of its columns existing (zeros past them, as the
// f32 stager's), hi[g] whether its values are high nibbles (Q_INT4_COLS;
// Q_INT4_ROWS: the stage's rows are, from ``half`` = K/2 on, a multiple
// of 64, so no stage straddles the halves).  The stored bytes go by
// cp.async into the ring ([BK][2 GW] bytes a stage, one a column) and are
// widened, each once, into the one f32 stage after they land, so the later
// stages' copies are in flight during the FFMAs (widening each word as
// __ldg loads it stalls the stage: tools/variants/moe_gmm_quant_f32_ldg.cu).
template <QLayout L>
struct QCols {
  static constexpr int ROW_BYTES = 2 * f32g::GW;
  static constexpr bool WIDENS = true;
  const int8_t* b[2];
  int n[2];
  size_t ld;
  bool hi[2];
  int half;

  // stored word (4 columns from column c of group g1) of contraction row
  // k; the groups by selects, not b[g1]: no local copy of the stager
  __device__ __forceinline__ const int8_t* word(bool g1, int k, int c) const {
    if (L == Q_INT4_ROWS && k >= half) k -= half;
    return (g1 ? b[1] : b[0]) + (size_t)k * ld + c;
  }

  __device__ __forceinline__ float4 widen(uint32_t w, bool g1, int k) const {
    if (L == Q_INT8) return i8x4_f32(w);
    return i4x4_f32(w, L == Q_INT4_ROWS ? k >= half : g1 ? hi[1] : hi[0]);
  }

  template <int BK>
  __device__ __forceinline__ void load(float* ring, int k0) const {
    constexpr int GW = f32g::GW, NT = f32g::NT;
    uint8_t* raw = reinterpret_cast<uint8_t*>(ring);
#pragma unroll
    for (int i = 0; i < (BK * 2 * GW / 16 + NT - 1) / NT; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (idx < BK * 2 * GW / 16) {
        const int k = idx / (2 * GW / 16), cc = (idx % (2 * GW / 16)) * 16;
        const bool g1 = cc >= GW;
        const int c = cc - (g1 ? GW : 0);
        const bool ok = c < (g1 ? n[1] : n[0]);
        f32g::cp16(raw + k * 2 * GW + cc, ok ? word(g1, k0 + k, c) : b[0],
                   ok);
      }
    }
  }

  template <int BK>
  __device__ __forceinline__ const float* ready(const float* ring,
                                                float* wide, int k0) const {
    constexpr int GW = f32g::GW, NT = f32g::NT;
    const uint32_t* raw = reinterpret_cast<const uint32_t*>(ring);
#pragma unroll
    for (int i = 0; i < BK * 2 * GW / 4 / NT; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int k = idx / (2 * GW / 4), cc = (idx % (2 * GW / 4)) * 4;
      *reinterpret_cast<float4*>(wide + k * 2 * GW + cc) =
          widen(raw[idx], cc >= GW, k0 + k);
    }
    __syncthreads();                    // the f32 stage is whole
    return wide;
  }
};

template <bool PACKED>
using F32QTile = f32g::Tile<f32g::MAX_TM, F32_STAGES, F32_BK,
                            QCols<PACKED ? Q_INT4_ROWS : Q_INT8>>;

// Pass 1 on f32 rows: h = silu(s1g gate) * (s1u up) * s2 in f32, 64
// columns of F a block, the tile's counted rows (moe_gmm.cu's f32
// instance).
template <bool PACKED>
__global__ void __launch_bounds__(f32g::NT, F32_MIN_BLOCKS)
gmmq_up_f32_kernel(const float* __restrict__ xs,
                   const int8_t* __restrict__ w1q,
                   const float* __restrict__ s1, const float* __restrict__ s2,
                   const int* __restrict__ tile_expert,
                   const int* __restrict__ tile_rows, float* __restrict__ h,
                   int D, int F, int block_m) {
  const int tile = blockIdx.y, rows = f32g::tile_count(tile_rows, tile);
  if (rows == 0) return;                        // pass 2 writes the zeros
  extern __shared__ __align__(16) float fsm[];
  const int e = tile_expert[tile], f0 = blockIdx.x * f32g::GW;
  const int8_t* w1e = w1q + (size_t)e * (PACKED ? D / 2 : D) * 2 * F;
  const float* sg = s1 + (size_t)e * 2 * F;
  const float* sd = s2 + (size_t)e * F;
  const size_t row0 = (size_t)tile * block_m;
  const QCols<PACKED ? Q_INT4_ROWS : Q_INT8> w{
      {w1e + f0, w1e + F + f0}, {F - f0, F - f0}, 2 * (size_t)F,
      {false, false}, D / 2};
  f32g::with_tile_rows<F32_MIN_TM>(rows, [&](auto tm) {
    f32g::up_tile_with<decltype(tm)::value, F32_STAGES, F32_BK, F32_SKIP>(
        fsm, xs + row0 * D, rows, D, w,
        [=](float g, float u, int f) {
          g *= sg[f];
          u *= sg[F + f];
          return g / (1.0f + expf(-g)) * u * sd[f];
        },
        h + row0 * F, F, f0);
  });
}

// Pass 2 on f32 h: out = h @ w2q[e], 128 output columns a block; the rows
// past the tile's count (all of a dead tile's) +0.
template <bool PACKED>
__global__ void __launch_bounds__(f32g::NT, F32_MIN_BLOCKS)
gmmq_down_f32_kernel(const float* __restrict__ h,
                     const int8_t* __restrict__ w2q,
                     const int* __restrict__ tile_expert,
                     const int* __restrict__ tile_rows,
                     float* __restrict__ out, int D, int F, int block_m) {
  const int tile = blockIdx.y, rows = f32g::tile_count(tile_rows, tile);
  const int d0 = blockIdx.x * 2 * f32g::GW;
  extern __shared__ __align__(16) float fsm[];
  const size_t row0 = (size_t)tile * block_m;
  float* dst = out + row0 * D;
  if (rows > 0) {
    const int Dp = PACKED ? D / 2 : D;          // stored columns of w2q[e]
    const int8_t* w2e = w2q + (size_t)tile_expert[tile] * F * Dp;
    QCols<PACKED ? Q_INT4_COLS : Q_INT8> w{{}, {}, (size_t)Dp, {}, D / 2};
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = d0 + g * f32g::GW;
      w.hi[g] = PACKED && col >= D / 2;
      w.b[g] = w2e + col - (w.hi[g] ? D / 2 : 0);
      w.n[g] = D - col;
    }
    f32g::with_tile_rows<F32_MIN_TM>(rows, [&](auto tm) {
      f32g::down_tile_with<decltype(tm)::value, F32_STAGES, F32_BK,
                           F32_SKIP>(
          fsm, h + row0 * F, rows, F, w, dst, D, d0);
    });
  }
  f32g::zero_rows(dst, D, rows, block_m, d0, min(2 * f32g::GW, D - d0));
}

template <bool PACKED>
static int launch_f32(const void* xs, const void* w1q, const void* w2q,
                      const void* s1, const void* s2, const void* tile_expert,
                      const void* tile_valid, void* tile_rows, void* h,
                      void* out, int M, int D, int F, int block_m,
                      cudaStream_t s) {
  constexpr int smem = F32QTile<PACKED>::BYTES;
  int err;
  if ((err = allow_smem(gmmq_up_f32_kernel<PACKED>, smem)) ||
      (err = allow_smem(gmmq_down_f32_kernel<PACKED>, smem)))
    return err;
  const int n_tiles = M / block_m;
  const int* te = static_cast<const int*>(tile_expert);
  int* rows = static_cast<int*>(tile_rows);
  cudaError_t e = f32g::count_rows(
      static_cast<const float*>(xs), static_cast<const int*>(tile_valid),
      rows, n_tiles, D, block_m, s);
  if (e != cudaSuccess) return (int)e;
  gmmq_up_f32_kernel<PACKED>
      <<<dim3((F + f32g::GW - 1) / f32g::GW, n_tiles), f32g::NT, smem, s>>>(
          static_cast<const float*>(xs), static_cast<const int8_t*>(w1q),
          static_cast<const float*>(s1), static_cast<const float*>(s2), te,
          rows, static_cast<float*>(h), D, F, block_m);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gmmq_down_f32_kernel<PACKED>
      <<<dim3((D + 2 * f32g::GW - 1) / (2 * f32g::GW), n_tiles), f32g::NT,
         smem, s>>>(static_cast<const float*>(h),
                    static_cast<const int8_t*>(w2q), te, rows,
                    static_cast<float*>(out), D, F, block_m);
  return (int)cudaGetLastError();
}

template <bool PACKED, int N>
static int launch(const CUtensorMap& tx, const CUtensorMap& tw1,
                  const CUtensorMap& th, const CUtensorMap& tw2,
                  const void* s1, const void* s2, const void* tile_expert,
                  const void* tile_valid, void* h, void* out, int D, int F,
                  int block_m, int n_tiles, cudaStream_t s) {
  constexpr int smem_up = q_stages(true, PACKED, N) *
                              q_stage_bytes(true, PACKED, N) + 1024;
  constexpr int smem_down = q_stages(false, PACKED, N) *
                                q_stage_bytes(false, PACKED, N) + 1024;
  int err;
  if ((err = allow_smem(gmmq_up_kernel<PACKED, N>, smem_up)) ||
      (err = allow_smem(gmmq_down_kernel<PACKED, N>, smem_down)))
    return err;
  const int Dp = PACKED ? D / 2 : D;
  const int* te = static_cast<const int*>(tile_expert);
  const int* tv = static_cast<const int*>(tile_valid);
  gmmq_up_kernel<PACKED, N>
      <<<dim3((F + UP_COLS - 1) / UP_COLS, n_tiles), Q_THREADS, smem_up, s>>>(
          tx, tw1, static_cast<const float*>(s1), static_cast<const float*>(s2),
          te, tv, static_cast<bf16*>(h), D, F, block_m);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  constexpr int COLS = down_cols(PACKED);
  gmmq_down_kernel<PACKED, N>
      <<<dim3((Dp + COLS - 1) / COLS, n_tiles), Q_THREADS, smem_down, s>>>(
          th, tw2, te, tv, static_cast<bf16*>(out), D, F, block_m);
  return (int)cudaGetLastError();
}

// xs [M, D] and out [M, D] bf16 (f32 when f32 is nonzero), w1q / w2q int8
// as above (packed != 0: int4), s1 [E, 2, F] and s2 [E, F] f32;
// tile_expert, tile_valid [M / block_m] int32; h [M, F] scratch of xs's
// type; f32: tile_rows [M / block_m, 8] int32 scratch (the count pass's,
// moe_gmm.cu; bf16: unused).  Needs D % 64 == 0 (int4:
// (D / 2) % 64 == 0), F % 32 == 0, block_m % 8 == 0 and <= 128, 16-byte
// aligned bases.  Returns cudaGetLastError() after launch, or the error
// of encoding a tensor map.
extern "C" int moe_gmm_quant_launch(const void* xs, const void* w1q,
                                    const void* w2q, const void* s1,
                                    const void* s2, const void* tile_expert,
                                    const void* tile_valid, void* tile_rows,
                                    void* h, void* out, int M, int D, int F,
                                    int block_m, int E, int packed, int f32,
                                    void* stream) {
  const int Dp = packed ? D / 2 : D;
  if (D % 64 || Dp % 64 || F % 32 || block_m % 8 || block_m > ROWS ||
      block_m <= 0 || M % block_m || E <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = M / block_m;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  if (f32)
    return (packed ? launch_f32<true> : launch_f32<false>)(
        xs, w1q, w2q, s1, s2, tile_expert, tile_valid, tile_rows, h, out, M,
        D, F, block_m, reinterpret_cast<cudaStream_t>(stream));
  CUtensorMap tx, tw1, th, tw2;
  int err;
  if ((err = activation_map(&tx, xs, 1, M, D)) ||
      (err = activation_map(&th, h, 1, M, F)) ||
      (err = weight_maps(&tw1, &tw2, w1q, w2q, E, Dp, F,
                         CU_TENSOR_MAP_DATA_TYPE_UINT8)))
    return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (packed)
    return block_m <= 64
               ? launch<true, 64>(tx, tw1, th, tw2, s1, s2, tile_expert,
                                  tile_valid, h, out, D, F, block_m, n_tiles, s)
               : launch<true, 128>(tx, tw1, th, tw2, s1, s2, tile_expert,
                                   tile_valid, h, out, D, F, block_m, n_tiles, s);
  return block_m <= 64
             ? launch<false, 64>(tx, tw1, th, tw2, s1, s2, tile_expert,
                                 tile_valid, h, out, D, F, block_m, n_tiles, s)
             : launch<false, 128>(tx, tw1, th, tw2, s1, s2, tile_expert,
                                  tile_valid, h, out, D, F, block_m, n_tiles, s);
}
