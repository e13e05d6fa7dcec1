// moe_decode: fused routed-expert SwiGLU for decode-shaped MoE batches.
//
// Replaces the TPU kernel src/repro/kernels/moe_decode.py::moe_decode_pallas.
// Contract (identical): x [B, D], w1 [E, D, 2F] (gate = first F columns,
// up = next F), w2 [E, F, D], idx [B, k] int32, weights [B, k] f32 ->
// y [B, D] with y[b] = sum_j weights[b, j] * SwiGLU(x[b]; expert idx[b, j]),
// accumulated in f32; x, w1, w2 and y are bf16 or, as the reference's
// kernel takes any float dtype, all f32 (the same passes on f32 elements:
// a thread's 8 weight columns are 32 bytes, half as many rows in flight).
// Only the routed experts' weights are read, and a slot with weight 0 adds
// exactly nothing (acc += 0 * partial), which is what route()'s k_budget
// relies on.
//
// What bounds it on the H100: bytes.  At B 8, k 8, D 2048, F 1024 the work
// is 0.2 GFLOP against 12.6 MB of weights per routed expert; the 64 slots
// route to about 44 distinct experts, 0.55 GB, 0.165 ms at 3.35 TB/s.
//
// Design.  The TPU grid (B, k, F/bf) runs in order and carries one
// accumulator per token across slots and F steps.  CUDA blocks run in
// parallel, so each block owns its output instead, and the blocks of one
// expert serve every slot routed to it, so each routed expert is read once
// a call, whatever its number of slots.  Three passes:
//   pass 1 (decode_up), grid (ceil(F/64), E): the block of expert e finds
//     the slots routed to e (idx scanned by one warp with a ballot, in slot
//     order); none: it exits at once.  Else it stages those slots' x rows
//     in shared memory and streams its 64 gate and 64 up columns of w1[e]
//     once for all of them: 16 threads cover a 256-byte weight row in
//     16-byte loads, 16 row groups split D, eight loads a thread in flight
//     (four past 4 slots); each thread keeps one f32 sum per (slot,
//     column) in registers.  The row groups' sums meet in a fixed order
//     (the two of a warp by a shuffle, then the warps in shared memory)
//     and h[slot, f] = silu(gate) * up is stored in f32.
//   pass 2 (decode_down), grid (ceil(D/128), E): the same grouping; the
//     block streams its 128 columns of w2[e] once and stores each slot's
//     f32 partial[slot, d] = h[slot] . w2[e][:, d].
//   pass 3 (decode_combine), grid (B, ceil(D/256)):
//     y[b, d] = sum_j weights[b, j] * partial[b * k + j, d], in slot order.
// The grouping, the combine pass and the dependent launches of passes 2
// and 3 are decode_slots.cuh's, shared with moe_decode_quant.cu.  The slot
// groups are found on the device, inside the launch: no host sync and no
// sort, so the decode step can be captured in a CUDA graph.  The sums of
// one slot are taken in the same order whatever other slots share its
// expert or its batch, so each row's output is bitwise the same alone or
// in a batch, and no float atomics are used.  Up to 8 slots of an
// expert are served by one pass over its weights (the sums are specialised
// to the count); an expert with more slots is streamed once per 8 of them,
// the later passes mostly from the L2.  F may be any multiple of 32 (an
// intra-pruned DeepSeek-V2-Lite expert has F = 1056): in a ragged last
// column block the lanes past F load nothing and store nothing.  Pass 2
// stages the slots' h rows [F][R] f32 in shared memory FC rows (128 KB) at
// a time, each thread's sums kept in registers across chunks.  The chunks
// start at multiples of a thread's row stride, so every sum takes its rows
// in the same order whatever the chunking (llama4-scout's F = 8192 needs
// two chunks; every F up to 4096 is one).

#include "decode_slots.cuh"

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;           // 8 warps
constexpr int NW = NT / 32;
constexpr int GROUPS = NT / 16;   // row groups of 16 threads
constexpr int R = 8;              // slots served by one pass over the weights
constexpr int FT = 64;            // gate (and up) columns of a pass-1 block
constexpr int DT = 128;           // output columns of a pass-2 block
constexpr int FC = 4096;          // h rows pass 2 stages at once
// weight loads a thread keeps in flight, fewer when it keeps sums of more
// than 4 slots; blocks an SM (the launch bound); tools/
// expert_kernel_variants.py times other values
constexpr int UNROLL_FEW = 8;
constexpr int UNROLL_MANY = 4;
constexpr int MIN_BLOCKS = 2;
// passes 2 and 3 launched as programmatic dependents of the pass before:
// their blocks start as the earlier pass's last blocks run, find their
// slots and wait for its results there
constexpr bool DEPENDENT_LAUNCH = true;
// f32 weights: half the rows in flight, as each row is twice the bytes
template <class T>
__host__ __device__ constexpr int unroll(int m) {
  return (m <= 4 ? UNROLL_FEW : UNROLL_MANY) / (int)(sizeof(T) / 2);
}

// a thread's 8 columns of one weight row: 16 bytes of bf16, or 32 of f32
template <class T>
struct Cols8;
template <>
struct Cols8<bf16> {
  uint4 w;
  __device__ __forceinline__ void load(const bf16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { w = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float (&f)[8]) const { unpack8(w, f); }
};
template <>
struct Cols8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// acc[r][c] += a[r][row] * W[row][c] over rows g, g + GROUPS, ... < n_rows
// of a 16-byte column group at W (row stride ld elements); a[r] of row
// ``row`` is read by ``operand(row, a)`` (M values); then the two row
// groups of each warp are summed by a shuffle.
// stream_rows_range adds rows [r0, r1) to acc without zeroing it or
// summing the groups: r0 a multiple of GROUPS * UNROLL keeps each thread's
// rows in stream_rows' order.
template <int M, class T, class Operand>
__device__ __forceinline__ void stream_rows_range(float (&acc)[M][8],
                                                  const T* __restrict__ W,
                                                  size_t ld, int r0, int r1,
                                                  bool live,
                                                  Operand operand) {
  constexpr int UNROLL = unroll<T>(M);
  const int g = threadIdx.x / 16;
  if (live) {
    for (int row0 = r0 + g; row0 < r1; row0 += GROUPS * UNROLL) {
      Cols8<T> w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int row = row0 + u * GROUPS;
        if (row < r1) w[u].load(W + row * ld);
        else w[u].zero();
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int row = row0 + u * GROUPS;
        if (row < r1) {
          float wf[8], a[M];
          w[u].get(wf);
          operand(row, a);
#pragma unroll
          for (int r = 0; r < M; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[r][c] = fmaf(a[r], wf[c], acc[r][c]);
        }
      }
    }
  }
}

template <int M>
__device__ __forceinline__ void zero_acc(float (&acc)[M][8]) {
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
}

// the two row groups of each warp summed by a shuffle
template <int M>
__device__ __forceinline__ void pair_groups(float (&acc)[M][8]) {
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
}

template <int M, class T, class Operand>
__device__ __forceinline__ void stream_rows(float (&acc)[M][8],
                                            const T* __restrict__ W,
                                            size_t ld, int n_rows, bool live,
                                            Operand operand) {
  zero_acc<M>(acc);
  stream_rows_range<M>(acc, W, ld, 0, n_rows, live, operand);
  pair_groups<M>(acc);
}

// Lanes 0-15 of each warp write their sums to red[warp][r][q * 8 + c].
template <int M>
__device__ __forceinline__ void to_red(const float (&acc)[M][8], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < 16) {
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        red[(warp * R + r) * 128 + lane * 8 + c] = acc[r][c];
  }
}

// Pass 1 over M (1..R) slots staged in xs [D][R] (bf16 or f32): gate and
// up sums of 64 columns each into red.  Thread q = t % 16 reads gate
// columns f0 + 8q.. (q < 8) or up columns f0 + 8(q - 8).. (q >= 8).
template <int M, class T>
__device__ void up_rows(const T* __restrict__ w1e, const T* xs,
                        float* red, int D, int F, int f0) {
  const int q = threadIdx.x % 16;
  const int col = f0 + 8 * (q % 8);
  float acc[M][8];
  stream_rows<M>(acc, w1e + (q < 8 ? 0 : F) + col, 2 * (size_t)F, D,
                 col < F, [&](int d, float (&a)[M]) {
                   float xf[8];
                   staged8(xs + d * R, xf);
#pragma unroll
                   for (int r = 0; r < M; ++r) a[r] = xf[r];
                 });
  to_red<M>(acc, red);
}

// Pass 2 over M slots (slots: their slot indices), 128 columns from d0: their
// h rows staged in hs [FC][R] f32 a chunk at a time.
template <int M, class T>
__device__ void down_rows(const T* __restrict__ w2e,
                          const float* __restrict__ h, const int* slots,
                          float* hs, float* red, int D, int F, int d0) {
  const int q = threadIdx.x % 16;
  const int col = d0 + 8 * q;
  float acc[M][8];
  zero_acc<M>(acc);
  for (int c0 = 0; c0 < F; c0 += FC) {
    const int c1 = min(F, c0 + FC);
    __syncthreads();                    // the previous chunk is consumed
    for (int i = threadIdx.x; i < M * (c1 - c0); i += NT) {
      const int r = i / (c1 - c0), f = i % (c1 - c0);
      hs[f * R + r] = h[(size_t)slots[r] * F + c0 + f];
    }
    __syncthreads();
    stream_rows_range<M>(acc, w2e + col, (size_t)D, c0, c1, col < D,
                         [&](int f, float (&a)[M]) {
#pragma unroll
                           for (int r = 0; r < M; ++r)
                             a[r] = hs[(f - c0) * R + r];
                         });
  }
  pair_groups<M>(acc);
  to_red<M>(acc, red);
}

static_assert(FC % (GROUPS * unroll<bf16>(1)) == 0 &&
                  FC % (GROUPS * unroll<bf16>(R)) == 0 &&
                  FC % (GROUPS * unroll<float>(1)) == 0 &&
                  FC % (GROUPS * unroll<float>(R)) == 0,
              "a chunk starts where a thread's row stride does");

// the warps' sums, red [NW][R][128] f32, in shared memory
constexpr size_t RED_BYTES = (size_t)NW * R * 128 * 4;

template <class T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
decode_up_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const int* __restrict__ idx, float* __restrict__ h,
                 int D, int F, int k, int n_slots) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ int count;
  int* slots = reinterpret_cast<int*>(sm);
  float* red = reinterpret_cast<float*>(sm + red_offset(n_slots));
  T* xs = reinterpret_cast<T*>(sm + operand_offset(n_slots, RED_BYTES));
  const int e = blockIdx.y, f0 = blockIdx.x * FT;
  launch_dependents();
  const int n = find_slots(idx, n_slots, e, slots, &count);
  if (n == 0) return;
  const T* w1e = w1 + (size_t)e * D * 2 * F;
  for (int s0 = 0; s0 < n; s0 += R) {
    const int m = min(R, n - s0);
    for (int i = threadIdx.x; i < m * D; i += NT) {
      const int r = i / D, d = i % D;
      xs[d * R + r] = x[(size_t)(slots[s0 + r] / k) * D + d];
    }
    __syncthreads();
    switch (m) {
      case 1: up_rows<1>(w1e, xs, red, D, F, f0); break;
      case 2: up_rows<2>(w1e, xs, red, D, F, f0); break;
      case 3: up_rows<3>(w1e, xs, red, D, F, f0); break;
      case 4: up_rows<4>(w1e, xs, red, D, F, f0); break;
      case 5: up_rows<5>(w1e, xs, red, D, F, f0); break;
      case 6: up_rows<6>(w1e, xs, red, D, F, f0); break;
      case 7: up_rows<7>(w1e, xs, red, D, F, f0); break;
      default: up_rows<8>(w1e, xs, red, D, F, f0); break;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m * FT; i += NT) {
      const int r = i / FT, c = i % FT;
      if (f0 + c < F) {
        float g = 0.f, u = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          g += red[(w * R + r) * 128 + c];
          u += red[(w * R + r) * 128 + FT + c];
        }
        h[(size_t)slots[s0 + r] * F + f0 + c] = swiglu<T>(g, u);
      }
    }
    __syncthreads();
  }
}

template <class T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
decode_down_kernel(const float* __restrict__ h, const T* __restrict__ w2,
                   const int* __restrict__ idx, float* __restrict__ partial,
                   int D, int F, int n_slots) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ int count;
  int* slots = reinterpret_cast<int*>(sm);
  float* red = reinterpret_cast<float*>(sm + red_offset(n_slots));
  float* hs =
      reinterpret_cast<float*>(sm + operand_offset(n_slots, RED_BYTES));
  const int e = blockIdx.y, d0 = blockIdx.x * DT;
  launch_dependents();
  const int n = find_slots(idx, n_slots, e, slots, &count);
  if (n == 0) return;
  const T* w2e = w2 + (size_t)e * F * D;
  wait_for_previous();                  // h of pass 1
  for (int s0 = 0; s0 < n; s0 += R) {
    const int m = min(R, n - s0);
    const int* sl = slots + s0;
    switch (m) {
      case 1: down_rows<1>(w2e, h, sl, hs, red, D, F, d0); break;
      case 2: down_rows<2>(w2e, h, sl, hs, red, D, F, d0); break;
      case 3: down_rows<3>(w2e, h, sl, hs, red, D, F, d0); break;
      case 4: down_rows<4>(w2e, h, sl, hs, red, D, F, d0); break;
      case 5: down_rows<5>(w2e, h, sl, hs, red, D, F, d0); break;
      case 6: down_rows<6>(w2e, h, sl, hs, red, D, F, d0); break;
      case 7: down_rows<7>(w2e, h, sl, hs, red, D, F, d0); break;
      default: down_rows<8>(w2e, h, sl, hs, red, D, F, d0); break;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m * DT; i += NT) {
      const int r = i / DT, c = i % DT;
      if (d0 + c < D) {
        float p = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) p += red[(w * R + r) * 128 + c];
        partial[(size_t)slots[s0 + r] * D + d0 + c] = p;
      }
    }
    __syncthreads();
  }
}

template <class T>
static int launch(const void* x, const void* w1, const void* w2,
                  const void* idx, const void* weights, void* h,
                  void* partial, void* y, int B, int D, int F, int k, int E,
                  cudaStream_t s) {
  const int n_slots = B * k;
  const size_t smem1 =
      operand_offset(n_slots, RED_BYTES) + (size_t)D * R * sizeof(T);
  const size_t smem2 =
      operand_offset(n_slots, RED_BYTES) + (size_t)min(F, FC) * R * 4;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(decode_up_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(decode_down_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem2)) != cudaSuccess)
    return (int)err;
  decode_up_kernel<T><<<dim3((F + FT - 1) / FT, E), NT, smem1, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const int*>(idx), static_cast<float*>(h), D, F, k, n_slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_pass(decode_down_kernel<T>, dim3((D + DT - 1) / DT, E),
                         NT, smem2, s, DEPENDENT_LAUNCH,
                         static_cast<const float*>(h),
                         static_cast<const T*>(w2),
                         static_cast<const int*>(idx),
                         static_cast<float*>(partial), D, F, n_slots)) !=
      cudaSuccess)
    return (int)err;
  return (int)launch_combine(static_cast<const float*>(partial),
                             static_cast<const float*>(weights),
                             static_cast<T*>(y), B, D, k, s,
                             DEPENDENT_LAUNCH);
}

// x [B, D], w1 [E, D, 2F], w2 [E, F, D], y [B, D] bf16 (f32 when f32 is
// nonzero); idx [B, k] int32;
// weights [B, k] f32; h [B, k, F] and partial [B, k, D] f32 scratch.  Needs
// D % 64 == 0, F % 32 == 0 and 16-byte aligned bases.  Returns
// cudaGetLastError() after launch.
extern "C" int moe_decode_launch(const void* x, const void* w1, const void* w2,
                                 const void* idx, const void* weights, void* h,
                                 void* partial, void* y, int B, int D, int F,
                                 int k, int E, int f32, void* stream) {
  if (D % 64 || F % 32 || B <= 0 || k <= 0 || E <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(x, w1, w2, idx, weights, h, partial, y, B, D, F,
                             k, E, s)
             : launch<bf16>(x, w1, w2, idx, weights, h, partial, y, B, D, F,
                            k, E, s);
}
