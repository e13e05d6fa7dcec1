// flash_attention: causal (optionally windowed) GQA attention over a whole
// sequence, for the train / prefill forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas.  Contract: q [B, Hq, S, hd], k, v [B, Hkv, S, hd]
// bf16 -> out [B, Hq, S, hd] bf16 (or all f32: the fa32 body below), each
// addressed through its own (batch,
// head, row) element strides with unit stride along hd, so the model's
// [B, S, H, hd] activations are read and written in place, without
// transposed copies; k and v share strides.  q head h reads kv head
// h / (Hq / Hkv).  Masking is by index: key j is visible to query i iff
// j <= i (and j > i - window when a window is set).  Softmax and the
// output accumulate in f32; P is rounded to bf16 for the P V product and
// the output to bf16 once.
//
// What bounds it on the H100: at the forward's shapes (B 4, 16 heads,
// S 512, hd 128) bytes and operations are close: 33.6 MB of q, k, v and
// out (0.010 ms at 3.35 TB/s) against 4.3 GFLOP of the causal half of the
// two products (0.004 ms at 989 TFLOP/s).  Below those, what limits a
// tile loop is the traffic it makes in the L2 and in shared memory: every
// q tile re-reads its K/V tiles, and every mma reads its B fragment from
// shared memory.
//
// Design (FlashAttention-2's register layout, pipelined for sm_90a).  One
// block of NWARP warps per (BQ-row q tile, q head, batch row); each warp
// owns MW 16-row slices of the tile, so a K or V fragment read from shared
// memory feeds MW mma.sync m16n8k16 (bf16 in, f32 accumulate), and a K/V
// tile read from the L2 serves BQ query rows.  The grid puts the q tile
// slowest and walks it from the end of the sequence, so the tiles that
// see the most keys start first.  The block loops over the BK-row kv tiles
// in [lo, hi) that causality and the window leave visible (the TPU
// kernel's n_lo / n_hi); K and V tiles live in a two-stage ring in shared
// memory, filled by 16-byte cp.async, so tile j + 1 is in flight during
// tile j's two products and softmax (K and V in separate commit groups:
// S = Q K^T starts once K has landed).  The Q tile stays in shared memory
// and its A fragments are re-read each tile, which keeps registers for the
// accumulators.  Every fragment comes from one ldmatrix.x4 (K's B
// fragments plain, V's with .trans); rows are padded by 8 elements, so the
// eight 16-byte rows of each 8x8 matrix fall in distinct banks.  Scores,
// the online-softmax state (base 2, a quad of threads per row reducing by
// shuffles) and the f32 output accumulator stay in registers, and P feeds
// O += P V in the score accumulator's layout, which is the A-operand
// layout.  Only the tiles that cross the diagonal, the window's edge or
// the sequence's end evaluate the mask.  A ragged last q or kv tile is
// zero-filled on load and masked, so any S runs.  The output is staged in
// the Q tile's rows (each warp its own) and stored as 16-byte rows.  hd is
// a template parameter, 32, 64, 80 or 128 (32: two k16 steps of Q K^T and
// four n8 tiles of P V, rows padded to 40, 80 B, still eight distinct
// banks for an 8x8 matrix's rows): the mma's k-dimension takes 80 as
// five steps of 16 (Q K^T) and P V's n-dimension as ten n8 tiles, and a
// row of 80 padded to 88 in shared memory (176 B, 11 x 16) still puts the
// eight rows of an 8x8 matrix in distinct banks.  The tile shape, BQ 64 on 4 warps with
// 64-row kv tiles and two blocks an SM, measured fastest at the forward's
// shape among eight tried (PERF.md: 128-row tiles on 8 warps spill at the
// two-block register cap; two slices a warp need 255 registers).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace fa {

constexpr int MW = 1;          // 16-row slices per warp
constexpr int NWARP = 4;       // warps per block
constexpr int BK = 64;         // kv rows per tile
constexpr int MIN_BLOCKS = 2;  // the launch bound caps registers so two fit
constexpr int PAD = 8;         // elements of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

// two floats -> packed bf16 pair (lo in the low half, the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + ROWS) of an [S, HD] matrix whose rows lie ``ld``
// elements apart into shared memory with row pitch HD + PAD, rows past S
// zero-filled; cp.async of 16 bytes a thread, not committed
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int S, int ld) {
  constexpr int PER_ROW = HD / 8;
  static_assert(ROWS * PER_ROW % NT == 0, "tile loads split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * PER_ROW / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 8;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * (HD + PAD) + c,
               src + (ok ? (size_t)(row0 + r) * ld + c : 0), ok);
  }
}

template <int HD>
struct Tile {
  static constexpr int BQ = 16 * MW * NWARP;     // q rows per block
  static constexpr int NT = 32 * NWARP;
  static constexpr int LDS = HD + PAD;
  static constexpr int SMEM = (BQ + 4 * BK) * LDS * (int)sizeof(bf16);
};

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::NT, MIN_BLOCKS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int Hq, int Hkv, int S, int window, float scale_log2,
                       int qsb, int qsh, int qss, int ksb, int ksh, int kss,
                       int osb, int osh, int oss) {
  using T = Tile<HD>;
  constexpr int BQ = T::BQ, NT = T::NT, LDS = T::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* skv = sq + BQ * LDS;          // stage s: K at 2s, V at 2s + 1

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;    // longest kv walks first
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;        // mma fragment coordinates
  const int q0 = qt * BQ;
  const int wr0 = warp * 16 * MW;               // this warp's first row
  const bf16* kb = k + (size_t)b * ksb + (size_t)hk * ksh;
  const bf16* vb = v + (size_t)b * ksb + (size_t)hk * ksh;

  const int hi = min(q0 + BQ, S);
  const int n_hi = (hi + BK - 1) / BK;
  const int n_lo = window > 0 ? max(q0 - (window - 1), 0) / BK : 0;

  // groups in flight: Q, K(lo), V(lo)
  load_tile<HD, BQ, NT>(sq, q + (size_t)b * qsb + (size_t)h * qsh, q0, S, qss);
  cp_async_commit();
  load_tile<HD, BK, NT>(skv, kb, n_lo * BK, S, kss);
  cp_async_commit();
  load_tile<HD, BK, NT>(skv + BK * LDS, vb, n_lo * BK, S, kss);
  cp_async_commit();

  float o[MW][HD / 8][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      o[m][n][0] = o[m][n][1] = o[m][n][2] = o[m][n][3] = 0.f;
  float mx[MW][2], l[MW][2];                    // per row: max, partial sum
#pragma unroll
  for (int m = 0; m < MW; ++m)
    mx[m][0] = mx[m][1] = -INFINITY, l[m][0] = l[m][1] = 0.f;

  for (int j = n_lo; j < n_hi; ++j) {
    const int k0 = j * BK;
    const bf16* sk = skv + ((j - n_lo) & 1) * 2 * BK * LDS;
    const bf16* sv = sk + BK * LDS;
    __syncthreads();                 // every warp is done with the other stage
    if (j + 1 < n_hi) {
      bf16* nk = skv + ((j + 1 - n_lo) & 1) * 2 * BK * LDS;
      load_tile<HD, BK, NT>(nk, kb, k0 + BK, S, kss);
      cp_async_commit();
      load_tile<HD, BK, NT>(nk + BK * LDS, vb, k0 + BK, S, kss);
      cp_async_commit();
    } else {
      cp_async_commit();             // empty groups keep the count uniform
      cp_async_commit();
    }
    cp_async_wait<3>();              // K(j) (and Q) landed
    __syncthreads();

    // S = Q K^T
    float s[MW][BK / 8][4];
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        s[m][n][0] = s[m][n][1] = s[m][n][2] = s[m][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[MW][4];
#pragma unroll
      for (int m = 0; m < MW; ++m)
        ldsm_x4(qa[m], sq + (wr0 + m * 16 + (lane & 15)) * LDS + kk * 16 +
                           (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, sk + ((n + (lane >> 4)) * 8 + (lane & 7)) * LDS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int m = 0; m < MW; ++m) {
          mma16816(s[m][n], qa[m], kf[0], kf[1]);
          mma16816(s[m][n + 1], qa[m], kf[2], kf[3]);
        }
      }
    }

    // scale to base 2; mask by index only on tiles that need it
    const bool full = k0 + BK - 1 <= q0 &&
                      (window <= 0 || k0 > q0 + BQ - 1 - window);
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      const int i0 = q0 + wr0 + m * 16 + g;     // rows i0 (e < 2), i0 + 8
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[m][n][e] * scale_log2;
          if (!full) {
            const int i = i0 + (e >> 1) * 8, jj = k0 + n * 8 + 2 * t + (e & 1);
            const bool ok = jj <= i && jj < S && (window <= 0 || jj > i - window);
            x = ok ? x : -INFINITY;
          }
          s[m][n][e] = x;
        }
    }

    // the online softmax of each row; the quad sharing a row reduces by
    // shuffles
#pragma unroll
    for (int m = 0; m < MW; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tm = -INFINITY;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
          tm = fmaxf(tm, fmaxf(s[m][n][2 * r], s[m][n][2 * r + 1]));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
        const float m_new = fmaxf(mx[m][r], tm);
        // no visible key yet: l and O are 0, any finite factor will do
        const float alpha = mx[m][r] == -INFINITY ? 1.f : ex2(mx[m][r] - m_new);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        mx[m][r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          s[m][n][2 * r] = ex2(s[m][n][2 * r] - m_use);
          s[m][n][2 * r + 1] = ex2(s[m][n][2 * r + 1] - m_use);
          sum += s[m][n][2 * r] + s[m][n][2 * r + 1];
        }
        l[m][r] = l[m][r] * alpha + sum;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[m][n][2 * r] *= alpha;
          o[m][n][2 * r + 1] *= alpha;
        }
      }
    }

    cp_async_wait<2>();              // V(j) landed
    __syncthreads();

    // O += P V: P's accumulator layout is the A-operand layout
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MW][4];
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        pa[m][0] = pack_bf16(s[m][2 * kk][0], s[m][2 * kk][1]);
        pa[m][1] = pack_bf16(s[m][2 * kk][2], s[m][2 * kk][3]);
        pa[m][2] = pack_bf16(s[m][2 * kk + 1][0], s[m][2 * kk + 1][1]);
        pa[m][3] = pack_bf16(s[m][2 * kk + 1][2], s[m][2 * kk + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < HD / 8; n += 2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                          (n + (lane >> 4)) * 8);
#pragma unroll
        for (int m = 0; m < MW; ++m) {
          mma16816(o[m][n], pa[m], vf[0], vf[1]);
          mma16816(o[m][n + 1], pa[m], vf[2], vf[3]);
        }
      }
    }
  }

  // normalise, stage this warp's rows in its own rows of the Q tile, and
  // store them as 16-byte vectors
  __syncwarp();
  bf16* so = sq + wr0 * LDS;
#pragma unroll
  for (int m = 0; m < MW; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[m][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      bf16* row = so + (m * 16 + r * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8) =
            pack_bf16(o[m][n][2 * r] * inv, o[m][n][2 * r + 1] * inv);
    }
  }
  __syncwarp();
  bf16* ob = out + (size_t)b * osb + (size_t)h * osh;
  constexpr int PER_ROW = HD / 8;
#pragma unroll
  for (int idx = lane; idx < 16 * MW * PER_ROW; idx += 32) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 8;
    const int i = q0 + wr0 + r;
    if (i < S)
      *reinterpret_cast<uint4*>(ob + (size_t)i * oss + c) =
          *reinterpret_cast<const uint4*>(so + r * LDS + c);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S, int window, const int (&st)[9],
           cudaStream_t stream) {
  using T = Tile<HD>;
  auto kernel = flash_attention_kernel<HD>;
  const int n_q = (S + T::BQ - 1) / T::BQ;
  if (B > 65535 || n_q > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, n_q);
  kernel<<<grid, T::NT, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Hq, Hkv, S,
      window, 1.4426950408889634f / sqrtf((float)HD), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

}  // namespace fa

// The f32 body: f32 operands, f32 FFMA on the CUDA cores (no tensor-core
// product takes f32 x f32 at full precision; TF32 keeps about three
// digits), P kept in f32.  What bounds it is the FFMA rate (the causal
// half of the two products at the forward's shape, 4.3 GFLOP, 0.064 ms
// at 67 TFLOP/s) and the shared-memory loads that feed it, so it is
// register-tiled.  One block of NT = 128 threads (8 x 16) per (BQ = 64-row
// q tile, q head, batch row), the q tile walked from the end of the
// sequence as above, over the BK = 64-key tiles in [lo, hi).  Thread
// (ty, tx) holds rows ty 8 .. ty 8 + 7 in both products: in S = Q K^T
// the keys tx + 16 j (j < 4), an 8 x 4 patch of S, every 4 head dims from
// 8 + 4 LDS.128 for 128 FFMA; in O += P V the head dims tx VW + 16 VW m
// (VW 4 at hd 64 and 128, 2 at 32, 1 at 80), an 8 x hd / 16 patch of O,
// every key from 2 LDS.128 of P and hd / 64 of V (hd 128: 64 FFMA).  The
// online softmax runs in base 2 (ex2.approx.ftz, as the bf16 body); the
// 16 threads of a row share its running max by shuffles, and each keeps
// its own part of the row's sum, summed by shuffles at the end.  P goes
// through shared memory key-major ([key][row], 16-byte chunks swizzled by
// the key), Q and K row-major at a pitch of hd rounded up to 32 with their
// 16-byte chunks swizzled by the row (Q by its thread row, K by its low
// three bits), so every load is an LDS.128 whose quarter warps hit
// distinct banks or one broadcast address.  Q, K and V land by 16-byte
// cp.async: K(j + 1) is in flight during tile j's softmax and P V, V(j +
// 1) during tile j + 1's Q K^T (K and V in separate commit groups, one
// buffer each).  Shared memory: Q 64 x P + K 64 x P + V 64 x hd + P 64 x
// 64 floats (P = hd rounded up to 32): 112 KB at hd 128, so two blocks
// share an SM (86 KB at 80, 64 KB at 64, 40 KB at 32).  Only the tiles
// that cross the diagonal, the window's edge or the sequence's end
// evaluate the mask; a ragged last q or kv tile is zero-filled on load
// and masked; rows past S are never stored.  Every output sums its keys
// and head dims in a fixed order, so a batch row's output does not depend
// on the other rows of the batch.
namespace fa32 {

constexpr int NT = 128;                // 8 x 16 threads
constexpr int BQ = 64;                 // q rows a block
constexpr int BK = 64;                 // keys a tile
constexpr int MIN_BLOCKS = 2;          // the launch bound's blocks an SM
constexpr int TR = BQ / 8;             // rows a thread
constexpr int TK = BK / 16;            // keys a thread
constexpr int PCH = BQ / 4;            // 16-byte chunks of a key's P row
constexpr int PSWZ = (PCH < 16 ? PCH : 16) - 1;   // their swizzle mask
static_assert(BQ % 32 == 0 && BK % 16 == 0, "whole 8 x 16 thread tiles");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct Cfg {
  static constexpr int VW = HD % 64 == 0 ? 4 : HD % 32 == 0 ? 2 : 1;
  static constexpr int NG = HD / (16 * VW);       // V groups a thread
  static constexpr int P = (HD + 31) / 32 * 32;   // Q's and K's row pitch
  static constexpr int K_OFF = BQ * P;
  static constexpr int V_OFF = K_OFF + BK * P;
  static constexpr int P_OFF = V_OFF + BK * HD;
  static constexpr int BYTES = (P_OFF + BK * BQ) * 4;
};

// rows [row0, row0 + ROWS) of an [S, HD] matrix (row pitch ld) into
// shared memory at pitch PITCH, 16-byte chunk c of row r at chunk c ^
// swz(r); zeros past S; cp.async, not committed
template <int HD, int ROWS, int PITCH, class Swz>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int S, int ld, Swz swz) {
  constexpr int CH = HD / 4;
  static_assert(ROWS * CH % NT == 0, "row loads split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / CH, c = idx % CH;
    const bool ok = row0 + r < S;
    fa::cp_async16(dst + r * PITCH + (c ^ swz(r)) * 4,
                   src + (ok ? (size_t)(row0 + r) * ld + c * 4 : 0), ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int Hq, int Hkv, int S,
                           int window, float scale_log2, int qsb, int qsh,
                           int qss, int ksb, int ksh, int kss, int osb,
                           int osh, int oss) {
  using CF = Cfg<HD>;
  constexpr int P = CF::P, VW = CF::VW, NG = CF::NG;
  extern __shared__ __align__(16) float smem_f[];
  float* sq = smem_f;
  float* sk = smem_f + CF::K_OFF;
  float* sv = smem_f + CF::V_OFF;
  float* sp = smem_f + CF::P_OFF;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;    // longest kv walks first
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * BQ;
  const float* kb = k + (size_t)b * ksb + (size_t)hk * ksh;
  const float* vb = v + (size_t)b * ksb + (size_t)hk * ksh;
  auto q_swz = [](int r) { return (r / TR) & 7; };
  auto k_swz = [](int r) { return r & 7; };
  auto no_swz = [](int) { return 0; };

  const int hi = min(q0 + BQ, S);
  const int n_hi = (hi + BK - 1) / BK;
  const int n_lo = window > 0 ? max(q0 - (window - 1), 0) / BK : 0;

  // groups in flight: (Q, K(lo)), V(lo)
  load_rows<HD, BQ, P>(sq, q + (size_t)b * qsb + (size_t)h * qsh, q0, S, qss,
                       q_swz);
  load_rows<HD, BK, P>(sk, kb, n_lo * BK, S, kss, k_swz);
  fa::cp_async_commit();
  load_rows<HD, BK, HD>(sv, vb, n_lo * BK, S, kss, no_swz);
  fa::cp_async_commit();

  float o[TR][NG * VW], mx[TR], l[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    mx[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < NG * VW; ++d) o[i][d] = 0.f;
  }

  for (int j = n_lo; j < n_hi; ++j) {
    const int k0 = j * BK;
    fa::cp_async_wait<1>();            // K(j) (and Q) landed
    __syncthreads();

    // S = Q K^T: rows ty 8 + i, keys tx + 16 jj
    float s[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int jj = 0; jj < TK; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
    for (int g = 0; g < HD / 4; ++g) {
      float4 kf[TK];
#pragma unroll
      for (int jj = 0; jj < TK; ++jj)    // (tx + 16 jj) & 7 == tx & 7
        kf[jj] = *reinterpret_cast<const float4*>(
            sk + (tx + 16 * jj) * P + ((g ^ (tx & 7)) * 4));
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(
            sq + (ty * TR + i) * P + ((g ^ (ty & 7)) * 4));
#pragma unroll
        for (int jj = 0; jj < TK; ++jj) {
          float a = s[i][jj];
          a = fmaf(qf.x, kf[jj].x, a);
          a = fmaf(qf.y, kf[jj].y, a);
          a = fmaf(qf.z, kf[jj].z, a);
          a = fmaf(qf.w, kf[jj].w, a);
          s[i][jj] = a;
        }
      }
    }
    __syncthreads();                   // every thread is done with K(j)
    if (j + 1 < n_hi)
      load_rows<HD, BK, P>(sk, kb, k0 + BK, S, kss, k_swz);
    fa::cp_async_commit();             // an empty group keeps the count

    // scale to base 2; mask by index only on tiles that need it
    const bool full = k0 + BK - 1 <= q0 &&
                      (window <= 0 || k0 > q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ty * TR + i;
#pragma unroll
      for (int jj = 0; jj < TK; ++jj) {
        float x = s[i][jj] * scale_log2;
        if (!full) {
          const int key = k0 + tx + 16 * jj;
          const bool ok = key <= row && key < S &&
                          (window <= 0 || key > row - window);
          x = ok ? x : -INFINITY;
        }
        s[i][jj] = x;
      }
    }

    // the online softmax of each row: the 16 threads of a row share its
    // max by shuffles; each keeps its own part of the sum
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float tm = s[i][0];
#pragma unroll
      for (int jj = 1; jj < TK; ++jj) tm = fmaxf(tm, s[i][jj]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, off));
      const float m_new = fmaxf(mx[i], tm);
      // no visible key yet: l and O are 0, any finite factor will do
      const float alpha = mx[i] == -INFINITY ? 1.f : ex2(mx[i] - m_new);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      mx[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < TK; ++jj) {
        s[i][jj] = ex2(s[i][jj] - m_use);
        sum += s[i][jj];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int d = 0; d < NG * VW; ++d) o[i][d] *= alpha;
    }

    // P to shared memory, [key][row]: chunk c (rows 4c..4c+3) of key kk at
    // chunk c ^ (kk & PSWZ); this thread's rows are chunks ty TR / 4 + c
#pragma unroll
    for (int jj = 0; jj < TK; ++jj) {
      float* pk = sp + (tx + 16 * jj) * BQ;
#pragma unroll
      for (int c = 0; c < TR / 4; ++c)
        *reinterpret_cast<float4*>(
            pk + (((ty * TR / 4 + c) ^ (tx & PSWZ)) * 4)) =
            make_float4(s[4 * c][jj], s[4 * c + 1][jj], s[4 * c + 2][jj],
                        s[4 * c + 3][jj]);
    }
    fa::cp_async_wait<1>();            // V(j) landed
    __syncthreads();                   // and P is written

    // O += P V: rows ty 8 + i, head dims tx VW + 16 VW m
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float* pk = sp + kk * BQ;
      float pv[TR];
#pragma unroll
      for (int c = 0; c < TR / 4; ++c) {
        const float4 t = *reinterpret_cast<const float4*>(
            pk + (((ty * TR / 4 + c) ^ (kk & PSWZ)) * 4));
        pv[4 * c] = t.x, pv[4 * c + 1] = t.y, pv[4 * c + 2] = t.z,
        pv[4 * c + 3] = t.w;
      }
      const float* vk = sv + kk * HD + tx * VW;
#pragma unroll
      for (int m = 0; m < NG; ++m) {
        float vv[VW];
        if constexpr (VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vk + m * 16 * VW);
          vv[0] = t.x, vv[1] = t.y, vv[2] = t.z, vv[3] = t.w;
        } else if constexpr (VW == 2) {
          const float2 t = *reinterpret_cast<const float2*>(vk + m * 16 * VW);
          vv[0] = t.x, vv[1] = t.y;
        } else {
          vv[0] = vk[m * 16];
        }
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int w = 0; w < VW; ++w)
            o[i][m * VW + w] = fmaf(pv[i], vv[w], o[i][m * VW + w]);
      }
    }
    __syncthreads();                   // every thread is done with V(j), P
    if (j + 1 < n_hi)
      load_rows<HD, BK, HD>(sv, vb, k0 + BK, S, kss, no_swz);
    fa::cp_async_commit();
  }
  fa::cp_async_wait<0>();              // no copy outlives the block

  float* ob = out + (size_t)b * osb + (size_t)h * osh;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = q0 + ty * TR + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    float* orow = ob + (size_t)row * oss + tx * VW;
#pragma unroll
    for (int m = 0; m < NG; ++m) {
      const float* a = o[i] + m * VW;
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(orow + m * 16 * VW) =
            make_float4(a[0] * inv, a[1] * inv, a[2] * inv, a[3] * inv);
      else if constexpr (VW == 2)
        *reinterpret_cast<float2*>(orow + m * 16 * VW) =
            make_float2(a[0] * inv, a[1] * inv);
      else
        orow[m * 16] = a[0] * inv;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S, int window, const int (&st)[9],
           cudaStream_t stream) {
  auto kernel = flash_attention_f32_kernel<HD>;
  const int n_q = (S + BQ - 1) / BQ;
  if (B > 65535 || n_q > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<HD>::BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(Hq, B, n_q), NT, Cfg<HD>::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Hq, Hkv, S,
      window, 1.4426950408889634f / sqrtf((float)HD), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

}  // namespace fa32

// Returns cudaGetLastError() after launch (cudaErrorInvalidValue for a
// head size other than 32, 64, 80 or 128, or a row stride that breaks
// 16-byte loads).  window <= 0: none.  (qsb, qsh, qss), (ksb, ksh, kss) and
// (osb, osh, oss) are the batch, head and row strides of q, of k and v,
// and of out, in elements; the caller also keeps the base pointers 16-byte
// aligned.  f32: q, k, v and out are f32 (the fa32 body), else bf16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int S, int hd, int window,
                                      int qsb, int qsh, int qss, int ksb,
                                      int ksh, int kss, int osb, int osh,
                                      int oss, int f32, void* stream) {
  const int st[9] = {qsb, qsh, qss, ksb, ksh, kss, osb, osh, oss};
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const int vec = f32 ? 4 : 8;         // elements of a 16-byte load
  for (int i = 0; i < 9; ++i)
    if (st[i] < 0 || st[i] % vec != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (f32) {
    switch (hd) {
      case 32: return fa32::launch<32>(q, k, v, out, B, Hq, Hkv, S, window, st, s);
      case 64: return fa32::launch<64>(q, k, v, out, B, Hq, Hkv, S, window, st, s);
      case 80: return fa32::launch<80>(q, k, v, out, B, Hq, Hkv, S, window, st, s);
      case 128: return fa32::launch<128>(q, k, v, out, B, Hq, Hkv, S, window, st, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 32: return fa::launch<32>(q, k, v, out, B, Hq, Hkv, S, window, st, s);
    case 64: return fa::launch<64>(q, k, v, out, B, Hq, Hkv, S, window, st, s);
    case 80: return fa::launch<80>(q, k, v, out, B, Hq, Hkv, S, window, st, s);
    case 128: return fa::launch<128>(q, k, v, out, B, Hq, Hkv, S, window, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
