// flash_attention: causal (optionally windowed) GQA attention over a whole
// sequence, for the train / prefill forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas.  Contract: q [B, Hq, S, hd], k, v [B, Hkv, S, hd]
// bf16 -> out [B, Hq, S, hd] bf16, each addressed through its own (batch,
// head, row) element strides with unit stride along hd, so the model's
// [B, S, H, hd] activations are read and written in place, without
// transposed copies; k and v share strides.  q head h reads kv head
// h / (Hq / Hkv).  Masking is by index: key j is visible to query i iff
// j <= i (and j > i - window when a window is set).  Softmax and the
// output accumulate in f32; the output is rounded to bf16 once.
//
// What bounds it on the H100: at the forward's shapes (B 4, 16 heads,
// S 512, hd 128) bytes and operations are close: 33.6 MB of q, k, v and
// out (0.010 ms at 3.35 TB/s) against 4.3 GFLOP of the causal half of the
// two products (0.004 ms at 989 TFLOP/s).
//
// Design.  One CUDA block of 4 warps per (64-row q tile, q head, batch
// row), as the TPU grid (B, Hq, Sq/bq); the tiles nearest the end of the
// sequence, which see the most keys, are scheduled first.  The block loops
// over the 64-row kv tiles in [lo, hi) that causality and the window leave
// visible (the TPU kernel's n_lo / n_hi), staging each K and V tile in
// shared memory (rows padded by 8 elements, so the fragment loads below
// hit 32 distinct banks).  Each warp owns 16 q rows and keeps everything
// else in registers, as FlashAttention-2 does: its Q fragments, the scores
// S = Q K^T of the current tile (mma.sync m16n8k16, bf16 in, f32
// accumulate), the online-softmax state of its rows -- a thread holds two
// rows, and the quad of threads sharing them reduces by shuffles -- and the
// f32 output accumulator O, rescaled in place by e^(m_old - m_new).  The
// score accumulator's layout is the A-operand layout of the next product,
// so P (rounded to bf16) feeds O += P V without leaving the registers.  A
// ragged last q or kv tile is zero-filled on load and masked, so any S
// runs with 64-row tiles (the TPU wrapper instead halves its tile until it
// divides S).  hd is a template parameter, 64 or 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define BQ 64            // q rows per block
#define BK 64            // kv rows per tile
#define NWARP 4          // 16 q rows per warp
#define NT (NWARP * 32)
#define PAD 8            // elements of padding per shared-memory row

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + 64) of an [S, HD] matrix whose rows lie ``ld``
// elements apart into shared memory with row pitch HD + PAD, rows past S
// zero-filled; 16-byte loads
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int S, int ld) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = HD / VEC;
  for (int idx = threadIdx.x; idx < 64 * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * (HD + PAD) + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int Hq, int Hkv, int S, int window, float scale,
                       int qsb, int qsh, int qss, int ksb, int ksh, int kss,
                       int osb, int osh, int oss) {
  constexpr int LDS = HD + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + BQ * LDS;
  bf16* sv = sk + BK * LDS;
  const uint16_t* sv16 = reinterpret_cast<const uint16_t*>(sv);

  const int qt = gridDim.x - 1 - blockIdx.x;    // longest kv walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;        // mma fragment coordinates
  const int q0 = qt * BQ;
  const size_t q_base = (size_t)b * qsb + (size_t)h * qsh;
  const size_t kv_base = (size_t)b * ksb + (size_t)hk * ksh;

  load_tile<HD>(sq, q + q_base, q0, S, qss);
  __syncthreads();
  const int r0 = warp * 16 + g;                 // this thread's rows r0, r0+8
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bf16* p = sq + r0 * LDS + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * LDS);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * LDS + 8);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int qi[2] = {q0 + r0, q0 + r0 + 8};     // global query rows
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};                      // this thread's partial sums

  const int hi = min(q0 + BQ, S);
  const int n_hi = (hi + BK - 1) / BK;
  const int n_lo = window > 0 ? max(q0 - (window - 1), 0) / BK : 0;
  for (int j = n_lo; j < n_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();                            // every warp is done with the last tile
    load_tile<HD>(sk, k + kv_base, k0, S, kss);
    load_tile<HD>(sv, v + kv_base, k0, S, kss);
    __syncthreads();

    // S = Q K^T: 8 column blocks of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const bf16* p = sk + (n * 8 + g) * LDS + kk * 16 + 2 * t;
        mma16816(s[n], qa[kk], ld32(p), ld32(p + 8));
      }
    }

    // mask, then the online softmax of rows qi[0] (s[.][0..1]) and
    // qi[1] (s[.][2..3]); the quad sharing a row reduces by shuffles
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = qi[e >> 1], jj = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = i < S && jj <= i && (window <= 0 || jj > i - window);
        s[n][e] = ok ? s[n][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // no visible key yet: l and O are 0, any finite factor will do
      alpha[r] = m[r] == -INFINITY ? 1.f : __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[n][e] = s[n][e] == -INFINITY ? 0.f : __expf(s[n][e] - m[r]);
        l[r] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A-operand layout
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int kv = kk * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int d = n * 8 + g;
        const uint32_t b0 = (uint32_t)sv16[kv * LDS + d] |
                            ((uint32_t)sv16[(kv + 1) * LDS + d] << 16);
        const uint32_t b1 = (uint32_t)sv16[(kv + 8) * LDS + d] |
                            ((uint32_t)sv16[(kv + 9) * LDS + d] << 16);
        mma16816(o[n], pa, b0, b1);
      }
    }
  }

  bf16* ob = out + (size_t)b * osb + (size_t)h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    if (qi[r] < S) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(ob + (size_t)qi[r] * oss + n * 8 + 2 * t) =
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

template <int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Hq, int Hkv, int S, int window,
                  const int (&st)[9], cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * (HD + PAD) * (int)sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Hq, Hkv, S,
      window, 1.0f / sqrtf((float)HD), st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after launch (cudaErrorInvalidValue for a
// head size other than 64 or 128, or a row stride that breaks 16-byte
// loads).  window <= 0: none.  (qsb, qsh, qss), (ksb, ksh, kss) and (osb,
// osh, oss) are the batch, head and row strides of q, of k and v, and of
// out, in elements; the caller also keeps the base pointers 16-byte
// aligned.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int S, int hd, int window,
                                      int qsb, int qsh, int qss, int ksb,
                                      int ksh, int kss, int osb, int osh,
                                      int oss, void* stream) {
  const int st[9] = {qsb, qsh, qss, ksb, ksh, kss, osb, osh, oss};
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || B <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (st[i] < 0 || st[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k, v, out, B, Hq, Hkv, S, window, st, s);
    case 128: return launch<128>(q, k, v, out, B, Hq, Hkv, S, window, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
