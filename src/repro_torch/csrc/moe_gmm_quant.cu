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
// it runs B1's f32 FFMA tile bodies (f32_tiles.cuh) with a stager that
// widens the int8 / int4 bytes to f32 as it writes them to shared memory;
// h stays f32 between the passes, as the f32 plain version keeps it, and
// nothing rounds to bf16 or TF32.  The bf16 instance is the code it was.

#include "f32_tiles.cuh"
#include "quant_common.cuh"
#include "wgmma_tiles.cuh"

using namespace wgt;
using namespace f32t;

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

// ---- f32 activations: f32_tiles.cuh's FFMA bodies on widened weights ----

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

// stage_cols for quantized weights: contraction rows [k0, k0 + F32_TK),
// columns [col0, col0 + F32_TN) (zeros past ``ncols``) of a matrix stored
// at w with ld bytes a stored row, widened to f32 into ws[k][col];
// ``half`` is K/2 (Q_INT4_ROWS) or N/2 (Q_INT4_COLS), a multiple of 64, so
// no step or column block straddles the halves.
template <QLayout L>
__device__ __forceinline__ void stage_qcols(float* ws,
                                            const int8_t* __restrict__ w,
                                            size_t ld, int col0, int ncols,
                                            int k0, int half) {
  const int k = threadIdx.x / 16, c = (threadIdx.x % 16) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col0 + c < ncols) {
    int row = k0 + k, col = col0 + c;
    bool hi = false;
    if (L == Q_INT4_ROWS) {
      hi = row >= half;
      row -= hi ? half : 0;
    } else if (L == Q_INT4_COLS) {
      hi = col >= half;
      col -= hi ? half : 0;
    }
    const uint32_t word =
        __ldg(reinterpret_cast<const uint32_t*>(w + row * ld + col));
    v = L == Q_INT8 ? i8x4_f32(word) : i4x4_f32(word, hi);
  }
  *reinterpret_cast<float4*>(ws + k * F32_TN + c) = v;
}

// Pass 1 on f32 rows: h = silu(s1g gate) * (s1u up) * s2 in f32, F32_TN
// columns of F a block.
template <bool PACKED>
__global__ void __launch_bounds__(F32_NT)
gmmq_up_f32_kernel(const float* __restrict__ xs,
                   const int8_t* __restrict__ w1q,
                   const float* __restrict__ s1, const float* __restrict__ s2,
                   const int* __restrict__ tile_expert,
                   const int* __restrict__ tile_valid, float* __restrict__ h,
                   int D, int F, int block_m) {
  constexpr QLayout L = PACKED ? Q_INT4_ROWS : Q_INT8;
  int tile, row0;
  const int rows = f32_part_rows(block_m, tile, row0);
  if (!tile_valid[tile]) return;                // pass 2 writes the zeros
  const int e = tile_expert[tile], f0 = blockIdx.x * F32_TN;
  const int8_t* w1e = w1q + (size_t)e * (PACKED ? D / 2 : D) * 2 * F;
  const float* sg = s1 + (size_t)e * 2 * F;
  const float* sd = s2 + (size_t)e * F;
  f32_up_tile_with(
      xs + (size_t)row0 * D, rows, h + (size_t)row0 * F, D, F, f0,
      [=](float* wg, float* wu, int k0) {
        stage_qcols<L>(wg, w1e, 2 * (size_t)F, f0, F, k0, D / 2);
        stage_qcols<L>(wu, w1e + F, 2 * (size_t)F, f0, F, k0, D / 2);
      },
      [=](float g, float u, int f) {
        g *= sg[f];
        u *= sg[F + f];
        return g / (1.0f + expf(-g)) * u * sd[f];
      });
}

// Pass 2 on f32 h: out = h @ w2q[e], F32_TN output columns a block; dead
// tiles write zeros.
template <bool PACKED>
__global__ void __launch_bounds__(F32_NT)
gmmq_down_f32_kernel(const float* __restrict__ h,
                     const int8_t* __restrict__ w2q,
                     const int* __restrict__ tile_expert,
                     const int* __restrict__ tile_valid,
                     float* __restrict__ out, int D, int F, int block_m) {
  int tile, row0;
  const int rows = f32_part_rows(block_m, tile, row0);
  const int d0 = blockIdx.x * F32_TN;
  if (!tile_valid[tile]) {                      // dead tile: zeros, no math
    for (int i = threadIdx.x; i < rows * (F32_TN / 4); i += F32_NT)
      *reinterpret_cast<float4*>(out + (size_t)(row0 + i / (F32_TN / 4)) * D +
                                 d0 + (i % (F32_TN / 4)) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int Dp = PACKED ? D / 2 : D;            // stored columns of w2q[e]
  const int8_t* w2e = w2q + (size_t)tile_expert[tile] * F * Dp;
  f32_down_tile_with(h + (size_t)row0 * F, rows, out + (size_t)row0 * D, D,
                     F, d0, [=](float* ws, int k0) {
                       stage_qcols<PACKED ? Q_INT4_COLS : Q_INT8>(
                           ws, w2e, Dp, d0, D, k0, D / 2);
                     });
}

template <bool PACKED>
static int launch_f32(const void* xs, const void* w1q, const void* w2q,
                      const void* s1, const void* s2, const void* tile_expert,
                      const void* tile_valid, void* h, void* out, int M,
                      int D, int F, int block_m, cudaStream_t s) {
  const int parts = (block_m + F32_TM - 1) / F32_TM;
  const int blocks_y = M / block_m * parts;
  if (blocks_y > 65535) return (int)cudaErrorInvalidValue;
  const int* te = static_cast<const int*>(tile_expert);
  const int* tv = static_cast<const int*>(tile_valid);
  gmmq_up_f32_kernel<PACKED>
      <<<dim3((F + F32_TN - 1) / F32_TN, blocks_y), F32_NT, 0, s>>>(
          static_cast<const float*>(xs), static_cast<const int8_t*>(w1q),
          static_cast<const float*>(s1), static_cast<const float*>(s2), te,
          tv, static_cast<float*>(h), D, F, block_m);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gmmq_down_f32_kernel<PACKED><<<dim3(D / F32_TN, blocks_y), F32_NT, 0, s>>>(
      static_cast<const float*>(h), static_cast<const int8_t*>(w2q), te, tv,
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
// type.  Needs D % 64 == 0 (int4:
// (D / 2) % 64 == 0), F % 32 == 0, block_m % 8 == 0 and <= 128, 16-byte
// aligned bases.  Returns cudaGetLastError() after launch, or the error
// of encoding a tensor map.
extern "C" int moe_gmm_quant_launch(const void* xs, const void* w1q,
                                    const void* w2q, const void* s1,
                                    const void* s2, const void* tile_expert,
                                    const void* tile_valid, void* h, void* out,
                                    int M, int D, int F, int block_m, int E,
                                    int packed, int f32, void* stream) {
  const int Dp = packed ? D / 2 : D;
  if (D % 64 || Dp % 64 || F % 32 || block_m % 8 || block_m > ROWS ||
      block_m <= 0 || M % block_m || E <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = M / block_m;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  if (f32)
    return (packed ? launch_f32<true> : launch_f32<false>)(
        xs, w1q, w2q, s1, s2, tile_expert, tile_valid, h, out, M, D, F,
        block_m, reinterpret_cast<cudaStream_t>(stream));
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
