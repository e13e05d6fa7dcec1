// The register-tiled f32 row-tile body of the expert kernels' two passes:
// moe_ffn.cu's tile body (C above its decode body's reach), moe_gmm.cu's
// f32 instance and moe_gmm_quant.cu's (int8 / int4 weights widened to f32
// as they are staged).  f32 x f32 has no full-precision tensor-core form
// (TF32 keeps about three digits), so it runs f32 FFMA on the CUDA cores,
// and what bounds it is the FFMA rate (67 TFLOP/s on the H100) and the
// shared-memory loads that feed it.
//
// A block of NT = 256 threads (16 x 16) owns BM = 16 TM rows of one
// expert's row tile by two groups of GW = 64 output columns: pass 1's gate
// and up columns of the same 64 h columns, pass 2's two neighbouring
// 64-column groups (128 output columns).  Thread (ty, tx) keeps a TM x 4
// patch of each group in registers (rows ty TM .. ty TM + TM - 1, columns
// tx 4 .. tx 4 + 3): per k it reads its rows' activations and the two
// groups' float4s and adds 2 x TM x 4 products, so at TM 8 every 16 FFMA
// cost one shared-memory load, all of them LDS.128 (A is read four k at
// a time).  TM is the launch's choice (1..8): moe_ffn cuts the row tile
// to the capacity (C 80 computes 80 rows, TM 5, not 128), moe_gmm and
// moe_gmm_quant to the rows a tile really holds (``count_rows``,
// ``with_rows``); there a warp (two thread rows) whose 2 TM rows all lie
// past the tile's rows adds no products (``SKIP``).
//
// Loads.  A stage holds BK (16 or 32) contraction rows: A as [BM][BK] (the
// activations' rows as stored, 64 B each) and the weights' BK rows as the
// weight stager lays them out, filled by 16-byte cp.async, STAGES stages
// in a ring, so stage k + STAGES - 1 is in flight while the FFMAs of stage
// k run.  Rows past the tile's height and columns past a group's width
// are zero-filled by the copy (src-size 0: no global read) and never
// stored.  The weight stager is a hook: ``F32Cols`` (f32 weights) copies
// the two groups' columns as [BK][2 GW] f32 that the FFMAs read where
// they land; moe_gmm_quant.cu's copies the int8 / int4 bytes and widens
// them into one [BK][2 GW] f32 stage after they land (``ready``).  A warp
// is two thread rows of 16 threads: a quarter warp's LDS.128 reads one A
// address (a broadcast) and 8 consecutive B float4s, and A's 16-byte
// chunks are swizzled by the parity of their thread row, so the warp's two
// A rows lie in distinct banks (1.6828 -> 1.6195 ms at C 80, PERF.md).
// The pass-1 epilogue is the other hook: SwiGLU by default,
// moe_gmm_quant's scaled SwiGLU.
//
// Every output sums its k in order in one FFMA chain from +0, so a row's
// result does not depend on the other rows of the tile or on TM, and an
// all-zero row comes out exactly +0 (fmaf(+0, w, +0) = +0 for finite w;
// against an inf or NaN weight it would be NaN, which a row skipped as
// all zero does not give).  Names live in namespace f32g.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32g {

constexpr int NT = 256;         // 16 x 16 threads
constexpr int GW = 64;          // columns of a B group: 16 threads x 4
constexpr int MAX_TM = 8;       // rows a thread at most: BM <= 128

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The default weight stager: two groups of f32 columns (group g's first
// column's pointer at row 0 and the number of its columns that exist, <=
// 0: none; one row pitch), copied as [BK][2 GW] into the ring and read
// there.
struct F32Cols {
  static constexpr int ROW_BYTES = 2 * GW * 4;  // a staged row in the ring
  static constexpr bool WIDENS = false;         // no f32 stage of its own
  const float* b[2];
  int n[2];
  size_t ld;

  template <int BK>
  __device__ __forceinline__ void load(float* ring, int k0) const {
#pragma unroll
    for (int i = 0; i < BK * 2 * GW / 4 / NT; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int k = idx / (2 * GW / 4), cc = (idx % (2 * GW / 4)) * 4;
      const bool g1 = cc >= GW;           // selects, not b[g]: no local copy
      const int c = cc - (g1 ? GW : 0);
      const bool ok = c < (g1 ? n[1] : n[0]);
      cp16(ring + k * 2 * GW + cc,
           ok ? (g1 ? b[1] : b[0]) + (size_t)(k0 + k) * ld + c : b[0], ok);
    }
  }

  template <int BK>
  __device__ __forceinline__ const float* ready(const float* ring, float*,
                                                int) const {
    return ring;
  }
};

template <int TM, int STAGES, int BK, class W = F32Cols>
struct Tile {
  static_assert(BK % 16 == 0, "whole float4 loads a thread");
  static_assert(TM >= 1 && TM <= MAX_TM, "16..128 rows a block");
  static constexpr int BM = 16 * TM;
  static constexpr int STAGE = BM * BK + BK * W::ROW_BYTES / 4;   // floats
  static constexpr int WIDE = W::WIDENS ? BK * 2 * GW : 0;        // floats
  static constexpr int BYTES = (STAGES * STAGE + WIDE) * 4;
};

// The FFMAs of one stage: acc[g][i][j] += a[ty TM + i, k] b[k, g GW + tx 4
// + j] for the stage's BK k in order (``as`` the swizzled [BM][BK] rows,
// ``bs`` [BK][2 GW] f32).  The inner loop of every f32 row-tile body.
template <int TM, int BK>
__device__ __forceinline__ void fma_stage(const float* as, const float* bs,
                                          int ty, int tx,
                                          float (&acc)[2][TM][4]) {
#pragma unroll
  for (int kq = 0; kq < BK; kq += 4) {
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(
          as + (ty * TM + i) * BK + (((kq / 4) ^ (ty & 1)) * 4));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b0 = *reinterpret_cast<const float4*>(
          bs + (kq + q) * 2 * GW + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(
          bs + (kq + q) * 2 * GW + GW + tx * 4);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                       : q == 2 ? a[i].z : a[i].w;
        acc[0][i][0] = fmaf(av, b0.x, acc[0][i][0]);
        acc[0][i][1] = fmaf(av, b0.y, acc[0][i][1]);
        acc[0][i][2] = fmaf(av, b0.z, acc[0][i][2]);
        acc[0][i][3] = fmaf(av, b0.w, acc[0][i][3]);
        acc[1][i][0] = fmaf(av, b1.x, acc[1][i][0]);
        acc[1][i][1] = fmaf(av, b1.y, acc[1][i][1]);
        acc[1][i][2] = fmaf(av, b1.z, acc[1][i][2]);
        acc[1][i][3] = fmaf(av, b1.w, acc[1][i][3]);
      }
    }
  }
}

// acc[g][i][j] = sum_k x[ty TM + i, k] * B_g[k, tx 4 + j] over K (a
// multiple of BK) for ``rows`` rows of x (row pitch ldx), in k order, B
// as the weight stager ``w`` stages it.  SKIP: a warp whose rows all lie
// past ``rows`` adds no products (its accumulators stay 0 and are never
// stored); off where every warp has rows (moe_ffn: the test costs its
// tile body 1.6 % at C 80, PERF.md).
template <int TM, int STAGES, int BK, bool SKIP, class W>
__device__ __forceinline__ void tile_loop(float* smem,
                                          const float* __restrict__ x,
                                          size_t ldx, int rows, int K,
                                          const W& w,
                                          float (&acc)[2][TM][4]) {
  using T = Tile<TM, STAGES, BK, W>;
  constexpr int BM = T::BM;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nk = K / BK;
  float* wide = smem + STAGES * T::STAGE;
  const bool busy = !SKIP || (ty & ~1) * TM < rows;   // its first row

  auto load = [&](int kt, int stage) {
    float* as = smem + stage * T::STAGE;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < (BM * BK / 4 + NT - 1) / NT; ++i) {
      const int idx = tid + i * NT;
      if (idx < BM * BK / 4) {
        const int r = idx / (BK / 4), c = idx % (BK / 4);
        const bool ok = r < rows;
        cp16(as + r * BK + ((c ^ ((r / TM) & 1)) * 4),
             ok ? x + (size_t)r * ldx + k0 + c * 4 : x, ok);
      }
    }
    w.template load<BK>(as + BM * BK, k0);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    commit();
  }
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    wait_groups<STAGES - 2>();          // stage kt landed
    __syncthreads();                    // and stage kt - 1 is consumed
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    commit();
    const float* as = smem + (kt % STAGES) * T::STAGE;
    const float* bs = w.template ready<BK>(as + BM * BK, wide, kt * BK);
    if (busy) fma_stage<TM, BK>(as, bs, ty, tx, acc);
  }
  wait_groups<0>();                     // no copy outlives the block
}

// SwiGLU, pass 1's default epilogue: h = silu(gate) * up
struct SwiGLU {
  __device__ __forceinline__ float operator()(float g, float u, int) const {
    return g / (1.0f + expf(-g)) * u;
  }
};

// Pass 1 on a row tile: rows of x [rows, D] (pitch D) against the gate
// and up columns that ``w`` stages (group 0: gate, group 1: up, 64 h
// columns from f0); dst[r * F + f0 + c] = act(gate, up, f0 + c).
template <int TM, int STAGES, int BK, bool SKIP, class W, class Act>
__device__ __forceinline__ void up_tile_with(float* smem, const float* x,
                                             int rows, int D, const W& w,
                                             Act act, float* dst, int F,
                                             int f0) {
  float acc[2][TM][4];
  tile_loop<TM, STAGES, BK, SKIP>(smem, x, D, rows, D, w, acc);
  const int ty = threadIdx.x / 16, c = f0 + (threadIdx.x % 16) * 4;
  if (c >= F) return;                   // F % 32 == 0: all 4 or none
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= rows) break;
    float h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = act(acc[0][i][j], acc[1][i][j], c + j);
    *reinterpret_cast<float4*>(dst + (size_t)r * F + c) =
        make_float4(h[0], h[1], h[2], h[3]);
  }
}

// Pass 1 on f32 weights: expert w1e [D, 2F], dst = silu(gate) * up.
template <int TM, int STAGES, int BK, bool SKIP = false>
__device__ __forceinline__ void up_tile(float* smem, const float* x,
                                        int rows, const float* w1e,
                                        float* dst, int D, int F, int f0) {
  up_tile_with<TM, STAGES, BK, SKIP>(
      smem, x, rows, D,
      F32Cols{{w1e + f0, w1e + F + f0}, {F - f0, F - f0}, 2 * (size_t)F},
      SwiGLU{}, dst, F, f0);
}

// Pass 2 on a row tile: rows of h [rows, F] (pitch F) against the columns
// that ``w`` stages (128 output columns from d0); dst[r * D + d0 + c].
template <int TM, int STAGES, int BK, bool SKIP, class W>
__device__ __forceinline__ void down_tile_with(float* smem, const float* h,
                                               int rows, int F, const W& w,
                                               float* dst, int D, int d0) {
  float acc[2][TM][4];
  tile_loop<TM, STAGES, BK, SKIP>(smem, h, F, rows, F, w, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int c = d0 + g * GW + tx * 4;
    if (c >= D) break;                  // D % 64 == 0: all 4 or none
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
      if (r >= rows) break;
      *reinterpret_cast<float4*>(dst + (size_t)r * D + c) = make_float4(
          acc[g][i][0], acc[g][i][1], acc[g][i][2], acc[g][i][3]);
    }
  }
}

// Pass 2 on f32 weights: expert w2e [F, D].
template <int TM, int STAGES, int BK, bool SKIP = false>
__device__ __forceinline__ void down_tile(float* smem, const float* h,
                                          int rows, const float* w2e,
                                          float* dst, int D, int F, int d0) {
  down_tile_with<TM, STAGES, BK, SKIP>(
      smem, h, rows, F,
      F32Cols{{w2e + d0, w2e + d0 + GW}, {D - d0, D - d0 - GW}, (size_t)D},
      dst, D, d0);
}

// ---- row tiles of the sorted buffer (moe_gmm, moe_gmm_quant) ----

template <int N>
struct Int {
  static constexpr int value = N;
};

// fn(Int<TM>{}) for the least TM in [TM0, TM1] whose 16 TM rows hold
// ``rows`` (<= 16 TM1): a block computes its tile's rows and at most 15
// more.
template <int TM0, int TM1, class Fn>
__device__ __forceinline__ void with_rows(int rows, Fn&& fn) {
  if constexpr (TM0 < TM1) {
    if (rows > 16 * TM0) {
      with_rows<TM0 + 1, TM1>(rows, fn);
      return;
    }
  }
  fn(Int<TM0>{});
}

// with_rows on a row tile of the sorted buffer holding ``rows`` rows: TM 1
// up to 16 rows, else the least TM in [MIN_TM, MAX_TM] (a thread's A loads
// then feed more FFMAs each, which is worth more than the warps it leaves
// idle: llama4-scout's tiles of about 32 rows, PERF.md); no TM between 1
// and MIN_TM is compiled.
template <int MIN_TM, class Fn>
__device__ __forceinline__ void with_tile_rows(int rows, Fn&& fn) {
  if (rows <= 16)
    fn(Int<1>{});
  else
    with_rows<MIN_TM, MAX_TM>(rows, fn);
}

// The count pass: the rows each row tile of the sorted buffer x [n_tiles
// * block_m, K] holds, 1 + its last row that is not all zero (a NaN
// counts as not zero), 0 for a dead tile or an all-zero one.  A block
// checks COUNT_ROWS rows of a tile (two a warp, a lane's loads in flight
// together) and writes its segment's count to seg[t][blockIdx.x]; grid
// (MAX_TM, n_tiles) covers block_m <= 128, and a tile's count is the
// largest of its MAX_TM segments' (``tile_count``).  So the pass reads
// the live tiles once at the memory's rate, no block waits on another,
// and the scratch needs no clearing.
constexpr int COUNT_ROWS = 16;

__global__ void __launch_bounds__(NT)
tile_rows_kernel(const float* __restrict__ x,
                 const int* __restrict__ tile_valid, int* __restrict__ seg,
                 int K, int block_m) {
  __shared__ int last[NT / 32];
  const int t = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * COUNT_ROWS + 2 * warp;
  bool nz0 = false, nz1 = false;
  if (tile_valid[t]) {
    const float* xr = x + ((size_t)t * block_m + r) * K;
    const bool has0 = r < block_m, has1 = r + 1 < block_m;
#pragma unroll 8
    for (int c = lane * 4; c < K; c += 128) {   // K % 64 == 0
      if (has0) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xr + c));
        nz0 |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
      }
      if (has1) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xr + K + c));
        nz1 |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
      }
    }
  }
  const int n = __reduce_max_sync(0xffffffffu, nz1 ? r + 2 : nz0 ? r + 1 : 0);
  if (lane == 0) last[warp] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) m = max(m, last[w]);
    seg[t * MAX_TM + blockIdx.x] = m;
  }
}

// The count pass on stream s into seg [n_tiles, MAX_TM] int32.
inline cudaError_t count_rows(const float* x, const int* tile_valid,
                              int* seg, int n_tiles, int K, int block_m,
                              cudaStream_t s) {
  tile_rows_kernel<<<dim3(MAX_TM, n_tiles), NT, 0, s>>>(x, tile_valid, seg,
                                                       K, block_m);
  return cudaGetLastError();
}

// Tile t's count: the largest of its segments' (the count pass's seg).
__device__ __forceinline__ int tile_count(const int* __restrict__ seg,
                                          int t) {
  int n = 0;
#pragma unroll
  for (int s = 0; s < MAX_TM; ++s) n = max(n, seg[t * MAX_TM + s]);
  return n;
}

// dst rows [r0, r1) (row pitch ld), columns [c0, c0 + n) (n a multiple of
// 4) set to +0 by the block's threads
__device__ __forceinline__ void zero_rows(float* dst, size_t ld, int r0,
                                          int r1, int c0, int n) {
  const int vecs = n / 4;
  for (int i = threadIdx.x; i < (r1 - r0) * vecs; i += NT)
    *reinterpret_cast<float4*>(dst + (size_t)(r0 + i / vecs) * ld + c0 +
                               (i % vecs) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace f32g
