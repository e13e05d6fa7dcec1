// moe_decode_quant: fused routed-expert SwiGLU for decode-shaped MoE
// batches, on int8- or int4-stored expert weights widened on chip.
//
// Replaces the TPU kernel
// src/repro/kernels/moe_decode.py::moe_decode_quant_pallas.  Contract
// (identical): x [B, D] bf16 or f32 (the reference takes any float x and
// writes x.dtype), idx [B, k] int32, weights [B, k] f32,
//   int8: w1q [E, D, 2F], w2q [E, F, D];
//   int4: w1q [E, D/2, 2F] packed along D (the contraction), w2q
//         [E, F, D/2] packed along D (the output), blocked halves
//         (quant_common.cuh);
//   s1 [E, 2, F] f32 (gate scales, then up scales), s2 [E, F] f32
// -> y [B, D] in x's dtype, y[b] = sum_j weights[b, j] * (h_bj @ w2q[e]) with
// e = idx[b, j] and h_bj = silu(gate * s1[e,0]) * (up * s1[e,1]) * s2[e],
// gate / up = x[b] @ the first / next F columns of w1q[e], all in f32:
// s1 after the first product (constant along D), s2 folded into h before
// the second (it varies along the F contraction).  Only the routed
// experts' weights are read, and a slot with weight 0 adds exactly nothing
// (acc += 0 * partial), which is what route()'s k_budget relies on.  f32
// x is staged as f32 (pass 1's x rows take 4 bytes an element), the
// weights are widened to f32 in registers as for bf16 x, and every product
// is an f32 FMA: nothing rounds to bf16 or TF32; the SiLU takes the
// precise exp, as the f32 plain version does.  The bf16 instance is the
// code it was, bit for bit.
//
// What bounds it on the H100: bytes.  At B 8, k 8, D 2048, F 1024 each
// routed expert is 6.3 MB in int8 (3.1 MB in int4); reading each distinct
// routed expert once -- about 44 of 64 -- takes about 0.083 (0.041) ms at
// 3.35 TB/s.  The products are 0.2 GFLOP.
//
// Design: B3's (moe_decode.cu), sharing its grouping (decode_slots.cuh):
// the blocks of one expert serve every slot routed to it, so each routed
// expert is read once a call, and the slots' f32 partials are combined in
// slot order by a third pass.
//   pass 1 (decodeq_up), grid (ceil(F/64), E): the block of expert e finds
//     its slots (none: it exits at once), stages their x rows in shared
//     memory and streams its 64 gate and 64 up columns of w1q[e] once for
//     all of them: 8 threads cover the block's 128 bytes of a stored row
//     in 16-byte loads (16 columns a thread), 32 row groups split the
//     stored rows, and a thread's loads go in batches, the next batch in
//     flight while one is summed; two blocks an SM.  Each weight byte is
//     widened to f32 once (a byte
//     permute and an add, quant_common.cuh) and FMA'd into up to 8 slots'
//     sums, one f32 sum per (slot, column) in registers.  An int4 byte
//     gives two contraction rows: x[r] times its low nibble, x[r + D/2]
//     times its high one.  The row groups' sums meet in a fixed order
//     (the four of a warp by shuffles, then the warps in shared memory)
//     and h[slot, f] = silu(gate * s1g) * (up * s1u) * s2 is stored in f32.
//   pass 2 (decodeq_down), grid (stored columns / 128, E): the same
//     grouping; the block streams its 128 stored columns of w2q[e] once
//     (int8: 16-byte loads of 16 columns, 32 row groups split F; int4:
//     8-byte loads of 8 packed columns, which are 16 outputs -- columns c
//     and D/2 + c -- over 16 row groups) and stores each slot's f32
//     partial.
//   pass 3: decode_combine, as in B3.
// Up to 8 slots of an expert are served by one pass over its weights (the
// sums are specialised to the count); an expert with more slots is
// streamed once per 8 of them, the later passes mostly from the L2.  F
// may be any multiple of 32: in a ragged last column block the lanes past
// F load nothing and store nothing.  Pass 2 stages the slots' h rows
// [F][R] f32 in shared memory FC rows (128 KB) at a time, as B3 does, each
// thread's sums kept in registers across chunks; the chunks start at
// multiples of a thread's row stride, so every sum takes its rows in the
// same order whatever the chunking (llama4-scout's F = 8192 needs two
// chunks; every F up to 4096 is one, with the bits it had unchunked).

#include "decode_slots.cuh"
#include "quant_common.cuh"

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;           // 8 warps
constexpr int NW = NT / 32;
constexpr int R = 8;              // slots served by one pass over the weights
constexpr int CB = 128;           // stored bytes of a row a block reads
constexpr int FT = CB / 2;        // gate (and up) columns of a pass-1 block
constexpr int FC = 4096;          // h rows pass 2 stages at once
// columns a thread sums (16: 16-byte loads of int8), the weight loads of
// a batch (one batch is in flight while the one before it is summed) for
// up to 2 slots, up to 4 and more, and blocks an SM (the launch bound: 2
// leave 128 registers a thread, so the sums of 6 to 8 slots spill);
// tools/expert_kernel_variants.py times other values
constexpr int C = 16;
constexpr int UNROLL_TWO = 4;
constexpr int UNROLL_FOUR = 4;
constexpr int UNROLL_MANY = 2;
constexpr int MIN_BLOCKS = 2;
// passes 2 and 3 launched as programmatic dependents of the pass before
constexpr bool DEPENDENT_LAUNCH = true;

// A pass's reading of its weights: a thread sums C columns (C/2 low- and
// C/2 high-nibble outputs in int4 pass 2) of VB bytes of a stored row,
// TPR threads cover the block's CB bytes of a row, GROUPS row groups
// split the rows; COLS accumulator columns a block (pass 1: 64 gate, then
// 64 up; pass 2: 128 outputs, or for int4 128 low-nibble then 128
// high-nibble outputs).
template <bool UP, bool PACKED>
struct Geo {
  static constexpr int VB = !UP && PACKED ? C / 2 : C;
  static constexpr int TPR = CB / VB;
  static constexpr int GROUPS = NT / TPR;
  static constexpr int COLS = TPR * C;
};

template <int M>
__host__ __device__ constexpr int unroll() {
  return M <= 2 ? UNROLL_TWO : M <= 4 ? UNROLL_FOUR : UNROLL_MANY;
}

// The 4 values of word w of a load as f32, in column order (int8), or its
// 4 low and 4 high nibbles (int4).
__device__ __forceinline__ void widen_word_i8(uint32_t w, float (&v)[4]) {
  const uint32_t o = w ^ 0x80808080u;
  v[0] = i8_f32<0>(o);
  v[1] = i8_f32<1>(o);
  v[2] = i8_f32<2>(o);
  v[3] = i8_f32<3>(o);
}
__device__ __forceinline__ void widen_word_i4(uint32_t w, float (&lo)[4],
                                              float (&hi)[4]) {
  uint32_t l[2], h[2];
  widen_i4(w, l, h);                // pairs of bytes (0, 2) and (1, 3)
  lo[0] = bf2_lo(l[0]);
  lo[1] = bf2_lo(l[1]);
  lo[2] = bf2_hi(l[0]);
  lo[3] = bf2_hi(l[1]);
  hi[0] = bf2_lo(h[0]);
  hi[1] = bf2_lo(h[1]);
  hi[2] = bf2_hi(h[0]);
  hi[3] = bf2_hi(h[1]);
}

template <int VB>
struct Load;
template <>
struct Load<16> {
  typedef uint4 T;
  static constexpr int WORDS = 4;
  __device__ static uint32_t word(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct Load<8> {
  typedef uint2 T;
  static constexpr int WORDS = 2;
  __device__ static uint32_t word(const T& v, int i) {
    return i == 0 ? v.x : v.y;
  }
};
template <>
struct Load<4> {
  typedef uint32_t T;
  static constexpr int WORDS = 1;
  __device__ static uint32_t word(const T& v, int) { return v; }
};

// acc[r][c] += a[r] * W[row][c] for the 16 columns of the load ``w`` of
// row ``row``; ``operand(row, a, a2)`` reads the M slots' values at row
// ``row`` (a2: at row + D/2, int4 pass 1 only).
template <int M, bool UP, bool PACKED, class V, class Operand>
__device__ __forceinline__ void fma_row(float (&acc)[M][C], const V& w,
                                        int row, Operand& operand) {
  typedef Load<sizeof(V)> L;
  float a[M], a2[M];
  operand(row, a, a2);
#pragma unroll
  for (int i = 0; i < L::WORDS; ++i) {
    const uint32_t word = L::word(w, i);
    if constexpr (!PACKED) {
      float v[4];
      widen_word_i8(word, v);
#pragma unroll
      for (int r = 0; r < M; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[r][4 * i + j] = fmaf(a[r], v[j], acc[r][4 * i + j]);
    } else {
      float lo[4], hi[4];
      widen_word_i4(word, lo, hi);
#pragma unroll
      for (int r = 0; r < M; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (UP) {           // rows r and r + D/2, one column
            acc[r][4 * i + j] = fmaf(a[r], lo[j], acc[r][4 * i + j]);
            acc[r][4 * i + j] = fmaf(a2[r], hi[j], acc[r][4 * i + j]);
          } else {                      // columns c and D/2 + c
            acc[r][4 * i + j] = fmaf(a[r], lo[j], acc[r][4 * i + j]);
            acc[r][C / 2 + 4 * i + j] =
                fmaf(a[r], hi[j], acc[r][C / 2 + 4 * i + j]);
          }
        }
    }
  }
}

// The thread's loads of U rows from row0, GROUPS apart (zeros past n_rows).
template <int U, int GROUPS, class V>
__device__ __forceinline__ void load_rows(V (&w)[U], const int8_t* W,
                                          size_t ld, int row0, int n_rows) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int row = row0 + u * GROUPS;
    w[u] = row < n_rows ? __ldg(reinterpret_cast<const V*>(W + row * ld))
                        : V{};
  }
}

// acc[r][c] += sum over this thread's rows of a[r] * W[row][c] (16
// columns), rows r0 + g, r0 + g + GROUPS, ... < r1 of the thread's load at
// W (row stride ld bytes), in batches of U loads: the next batch is in
// flight while one is summed.  Each thread takes its rows in increasing
// order, so ranges that start at multiples of GROUPS add them in
// stream_rows' order.
template <int M, bool UP, bool PACKED, class Operand>
__device__ __forceinline__ void stream_rows_range(
    float (&acc)[M][C], const int8_t* __restrict__ W, size_t ld, int r0,
    int r1, bool live, Operand operand) {
  typedef Geo<UP, PACKED> G;
  typedef typename Load<G::VB>::T V;
  constexpr int U = unroll<M>();
  constexpr int STEP = G::GROUPS * U;
  if (live) {
    V w0[U], w1[U];
    const int g = r0 + threadIdx.x / G::TPR;
    load_rows<U, G::GROUPS>(w0, W, ld, g, r1);
    for (int row0 = g; row0 < r1; row0 += 2 * STEP) {
      load_rows<U, G::GROUPS>(w1, W, ld, row0 + STEP, r1);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (row0 + u * G::GROUPS < r1)
          fma_row<M, UP, PACKED>(acc, w0[u], row0 + u * G::GROUPS, operand);
      load_rows<U, G::GROUPS>(w0, W, ld, row0 + 2 * STEP, r1);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (row0 + STEP + u * G::GROUPS < r1)
          fma_row<M, UP, PACKED>(acc, w1[u], row0 + STEP + u * G::GROUPS,
                                 operand);
    }
  }
}

template <int M>
__device__ __forceinline__ void zero_acc(float (&acc)[M][C]) {
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
}

// the row groups of each warp summed by shuffles (lanes < TPR hold them)
template <int M, bool UP, bool PACKED>
__device__ __forceinline__ void sum_groups(float (&acc)[M][C]) {
#pragma unroll
  for (int off = Geo<UP, PACKED>::TPR; off < 32; off *= 2)
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
}

// acc = the sums of stream_rows_range over rows [0, n_rows), the row
// groups of each warp summed
template <int M, bool UP, bool PACKED, class Operand>
__device__ __forceinline__ void stream_rows(float (&acc)[M][C],
                                            const int8_t* __restrict__ W,
                                            size_t ld, int n_rows, bool live,
                                            Operand operand) {
  zero_acc<M>(acc);
  stream_rows_range<M, UP, PACKED>(acc, W, ld, 0, n_rows, live, operand);
  sum_groups<M, UP, PACKED>(acc);
}

// Lanes < TPR of each warp write their sums to red[warp][r][column]: the
// thread's C columns from C q (int4 pass 2: C/2 from (C/2) q, and C/2
// from COLS / 2 + (C/2) q).
template <int M, bool UP, bool PACKED>
__device__ __forceinline__ void to_red(const float (&acc)[M][C], float* red) {
  typedef Geo<UP, PACKED> G;
  constexpr int H = C / 2;
  const int warp = threadIdx.x / 32, q = threadIdx.x % 32;
  if (q < G::TPR) {
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = !UP && PACKED ? (c < H ? H * q + c
                                               : G::COLS / 2 + H * q + c - H)
                                      : C * q + c;
        red[(warp * R + r) * G::COLS + col] = acc[r][c];
      }
  }
}

// Pass 1 over M (1..R) slots staged in xs [D][R] (bf16 or f32).  Thread q
// reads gate columns f0 + C q.. (q < TPR / 2) or up columns f0 + C (q -
// TPR / 2)..
template <int M, bool PACKED, class T>
__device__ void up_rows(const int8_t* __restrict__ w1e, const T* xs,
                        float* red, int D, int F, int f0) {
  constexpr int HALF = Geo<true, PACKED>::TPR / 2;
  const int q = threadIdx.x % (2 * HALF);
  const int col = f0 + C * (q % HALF);
  float acc[M][C];
  stream_rows<M, true, PACKED>(
      acc, w1e + (q < HALF ? 0 : F) + col, 2 * (size_t)F, PACKED ? D / 2 : D,
      col < F, [&](int d, float (&a)[M], float (&a2)[M]) {
        float xf[8];
        staged8(xs + d * R, xf);
#pragma unroll
        for (int r = 0; r < M; ++r) a[r] = xf[r];
        if constexpr (PACKED) {
          staged8(xs + (d + D / 2) * R, xf);
#pragma unroll
          for (int r = 0; r < M; ++r) a2[r] = xf[r];
        }
      });
  to_red<M, true, PACKED>(acc, red);
}

// Pass 2 over M slots (slots: their slot indices), the block's 128 stored
// columns from c0: their h rows staged in hs [FC][R] f32 a chunk at a
// time.
template <int M, bool PACKED>
__device__ void down_rows(const int8_t* __restrict__ w2e,
                          const float* __restrict__ h, const int* slots,
                          float* hs, float* red, int Dp, int F, int c0) {
  typedef Geo<false, PACKED> G;
  const int q = threadIdx.x % G::TPR;
  const int col = c0 + G::VB * q;
  float acc[M][C];
  zero_acc<M>(acc);
  for (int f0 = 0; f0 < F; f0 += FC) {
    const int f1 = min(F, f0 + FC);
    __syncthreads();                    // the previous chunk is consumed
    for (int i = threadIdx.x; i < M * (f1 - f0); i += NT) {
      const int r = i / (f1 - f0), f = i % (f1 - f0);
      hs[f * R + r] = h[(size_t)slots[r] * F + f0 + f];
    }
    __syncthreads();
    stream_rows_range<M, false, PACKED>(
        acc, w2e + col, (size_t)Dp, f0, f1, col < Dp,
        [&](int f, float (&a)[M], float (&)[M]) {
#pragma unroll
          for (int r = 0; r < M; ++r) a[r] = hs[(f - f0) * R + r];
        });
  }
  sum_groups<M, false, PACKED>(acc);
  to_red<M, false, PACKED>(acc, red);
}

static_assert(FC % Geo<false, false>::GROUPS == 0 &&
                  FC % Geo<false, true>::GROUPS == 0,
              "a chunk starts where a thread's row stride does");

// the warps' sums, red [NW][R][cols] f32, in shared memory
__host__ __device__ constexpr size_t red_bytes(int cols) {
  return (size_t)NW * R * cols * 4;
}

template <bool PACKED, class T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
decodeq_up_kernel(const T* __restrict__ x, const int8_t* __restrict__ w1q,
                  const float* __restrict__ s1, const float* __restrict__ s2,
                  const int* __restrict__ idx, float* __restrict__ h,
                  int D, int F, int k, int n_slots) {
  constexpr int COLS = Geo<true, PACKED>::COLS;
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ int count;
  int* slots = reinterpret_cast<int*>(sm);
  float* red = reinterpret_cast<float*>(sm + red_offset(n_slots));
  T* xs = reinterpret_cast<T*>(sm + operand_offset(n_slots, red_bytes(COLS)));
  const int e = blockIdx.y, f0 = blockIdx.x * FT;
  launch_dependents();
  const int n = find_slots(idx, n_slots, e, slots, &count);
  if (n == 0) return;
  const int8_t* w1e = w1q + (size_t)e * (PACKED ? D / 2 : D) * 2 * F;
  for (int s0 = 0; s0 < n; s0 += R) {
    const int m = min(R, n - s0);
    for (int i = threadIdx.x; i < m * D; i += NT) {
      const int r = i / D, d = i % D;
      xs[d * R + r] = x[(size_t)(slots[s0 + r] / k) * D + d];
    }
    __syncthreads();
    switch (m) {
      case 1: up_rows<1, PACKED, T>(w1e, xs, red, D, F, f0); break;
      case 2: up_rows<2, PACKED, T>(w1e, xs, red, D, F, f0); break;
      case 3: up_rows<3, PACKED, T>(w1e, xs, red, D, F, f0); break;
      case 4: up_rows<4, PACKED, T>(w1e, xs, red, D, F, f0); break;
      case 5: up_rows<5, PACKED, T>(w1e, xs, red, D, F, f0); break;
      case 6: up_rows<6, PACKED, T>(w1e, xs, red, D, F, f0); break;
      case 7: up_rows<7, PACKED, T>(w1e, xs, red, D, F, f0); break;
      default: up_rows<8, PACKED, T>(w1e, xs, red, D, F, f0); break;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m * FT; i += NT) {
      const int r = i / FT, c = i % FT, f = f0 + c;
      if (f < F) {
        float g = 0.f, u = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          g += red[(w * R + r) * COLS + c];
          u += red[(w * R + r) * COLS + FT + c];
        }
        g *= s1[(size_t)e * 2 * F + f];
        u *= s1[(size_t)e * 2 * F + F + f];
        h[(size_t)slots[s0 + r] * F + f] =
            swiglu<T>(g, u) * s2[(size_t)e * F + f];
      }
    }
    __syncthreads();
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
decodeq_down_kernel(const float* __restrict__ h,
                    const int8_t* __restrict__ w2q,
                    const int* __restrict__ idx, float* __restrict__ partial,
                    int D, int F, int n_slots) {
  constexpr int COLS = Geo<false, PACKED>::COLS;
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ int count;
  int* slots = reinterpret_cast<int*>(sm);
  float* red = reinterpret_cast<float*>(sm + red_offset(n_slots));
  float* hs =
      reinterpret_cast<float*>(sm + operand_offset(n_slots, red_bytes(COLS)));
  const int Dp = PACKED ? D / 2 : D;            // stored columns of w2q[e]
  const int e = blockIdx.y, c0 = blockIdx.x * CB;
  launch_dependents();
  const int n = find_slots(idx, n_slots, e, slots, &count);
  if (n == 0) return;
  const int8_t* w2e = w2q + (size_t)e * F * Dp;
  wait_for_previous();                  // h of pass 1
  for (int s0 = 0; s0 < n; s0 += R) {
    const int m = min(R, n - s0);
    const int* sl = slots + s0;
    switch (m) {
      case 1: down_rows<1, PACKED>(w2e, h, sl, hs, red, Dp, F, c0); break;
      case 2: down_rows<2, PACKED>(w2e, h, sl, hs, red, Dp, F, c0); break;
      case 3: down_rows<3, PACKED>(w2e, h, sl, hs, red, Dp, F, c0); break;
      case 4: down_rows<4, PACKED>(w2e, h, sl, hs, red, Dp, F, c0); break;
      case 5: down_rows<5, PACKED>(w2e, h, sl, hs, red, Dp, F, c0); break;
      case 6: down_rows<6, PACKED>(w2e, h, sl, hs, red, Dp, F, c0); break;
      case 7: down_rows<7, PACKED>(w2e, h, sl, hs, red, Dp, F, c0); break;
      default: down_rows<8, PACKED>(w2e, h, sl, hs, red, Dp, F, c0); break;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
          // int4: columns c0 + c (low nibbles), then D/2 + c0 + c - CB (high)
      const int sc = c0 + (PACKED ? c % CB : c);
      if (sc < Dp) {
        float p = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) p += red[(w * R + r) * COLS + c];
        partial[(size_t)slots[s0 + r] * D + sc + (c >= CB ? D / 2 : 0)] = p;
      }
    }
    __syncthreads();
  }
}

template <bool PACKED, class T>
static int launch(const void* x, const void* w1q, const void* w2q,
                  const void* s1, const void* s2, const void* idx,
                  const void* weights, void* h, void* partial, void* y, int B,
                  int D, int F, int k, int E, cudaStream_t s) {
  const int n_slots = B * k;
  const int Dp = PACKED ? D / 2 : D;
  const size_t smem1 =
      operand_offset(n_slots, red_bytes(Geo<true, PACKED>::COLS)) +
      (size_t)D * R * sizeof(T);
  const size_t smem2 =
      operand_offset(n_slots, red_bytes(Geo<false, PACKED>::COLS)) +
      (size_t)min(F, FC) * R * 4;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(decodeq_up_kernel<PACKED, T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(decodeq_down_kernel<PACKED>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem2)) != cudaSuccess)
    return (int)err;
  decodeq_up_kernel<PACKED, T><<<dim3((F + FT - 1) / FT, E), NT, smem1, s>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w1q),
      static_cast<const float*>(s1), static_cast<const float*>(s2),
      static_cast<const int*>(idx), static_cast<float*>(h), D, F, k, n_slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_pass(decodeq_down_kernel<PACKED>,
                         dim3((Dp + CB - 1) / CB, E), NT, smem2, s,
                         DEPENDENT_LAUNCH, static_cast<const float*>(h),
                         static_cast<const int8_t*>(w2q),
                         static_cast<const int*>(idx),
                         static_cast<float*>(partial), D, F, n_slots)) !=
      cudaSuccess)
    return (int)err;
  return (int)launch_combine(static_cast<const float*>(partial),
                             static_cast<const float*>(weights),
                             static_cast<T*>(y), B, D, k, s,
                             DEPENDENT_LAUNCH);
}

// x [B, D] and y [B, D] bf16 (f32 when f32 is nonzero), w1q / w2q int8 as
// above (packed != 0: int4), s1 [E, 2, F] and s2 [E, F] f32, idx [B, k]
// int32, weights [B, k] f32; h [B, k, F] and partial [B, k, D] f32
// scratch.  Needs D % 64 == 0 (int4:
// (D / 2) % 64 == 0), F % 32 == 0 and 16-byte aligned bases.  Returns
// cudaGetLastError() after launch.
extern "C" int moe_decode_quant_launch(const void* x, const void* w1q,
                                       const void* w2q, const void* s1,
                                       const void* s2, const void* idx,
                                       const void* weights, void* h,
                                       void* partial, void* y, int B, int D,
                                       int F, int k, int E, int packed,
                                       int f32, void* stream) {
  const int Dp = packed ? D / 2 : D;
  if (D % 64 || Dp % 64 || F % 32 || B <= 0 || k <= 0 || E <= 0 ||
      E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (f32)
    return packed ? launch<true, float>(x, w1q, w2q, s1, s2, idx, weights, h,
                                        partial, y, B, D, F, k, E, s)
                  : launch<false, float>(x, w1q, w2q, s1, s2, idx, weights, h,
                                         partial, y, B, D, F, k, E, s);
  return packed ? launch<true, bf16>(x, w1q, w2q, s1, s2, idx, weights, h,
                                     partial, y, B, D, F, k, E, s)
                : launch<false, bf16>(x, w1q, w2q, s1, s2, idx, weights, h,
                                      partial, y, B, D, F, k, E, s);
}
