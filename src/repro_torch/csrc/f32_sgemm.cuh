// A register-tiled f32 row-tile body for the expert kernels' two passes
// (moe_ffn.cu's tile body at C above its decode body's reach): f32 x f32
// has no full-precision tensor-core form (TF32 keeps about three digits),
// so it runs f32 FFMA on the CUDA cores, and what bounds it is the FFMA
// rate (67 TFLOP/s on the H100) and the shared-memory loads that feed it.
//
// A block of NT = 256 threads (16 x 16) owns BM = 16 TM rows of one
// expert's row tile by two groups of GW = 64 output columns: pass 1's gate
// and up columns of the same 64 h columns, pass 2's two neighbouring
// 64-column groups (128 output columns).  Thread (ty, tx) keeps a TM x 4
// patch of each group in registers (rows ty TM .. ty TM + TM - 1, columns
// tx 4 .. tx 4 + 3): per k it reads its rows' activations and the two
// groups' float4s and adds 2 x TM x 4 products, so at TM 8 every 16 FFMA
// cost one shared-memory load, all of them LDS.128 (A is read four k at
// a time).  TM is the launch's choice (2..8): the row tile is cut to the
// capacity, so C 80 computes 80 rows (TM 5), not 128.
//
// Loads.  A stage holds BK (16 or 32) contraction rows: A as [BM][BK] (the
// activations' rows as stored, 64 B each) and the two B groups as
// [BK][2 GW] (the weights' rows as stored), filled by 16-byte cp.async,
// STAGES stages in a ring, so stage k + STAGES - 1 is in flight while the
// FFMAs of stage k run.  Rows past the tile's height and columns past a
// group's width are zero-filled by the copy (src-size 0) and never stored.
// A warp is two thread rows of 16 threads: a quarter warp's LDS.128
// reads one A address (a broadcast) and 8 consecutive B float4s, and
// A's 16-byte chunks are swizzled by the parity of their thread row, so
// the warp's two A rows lie in distinct banks (1.6828 -> 1.6195 ms at C
// 80, PERF.md).
//
// Every output sums its k in order in one FFMA chain, so a row's result
// does not depend on the other rows of the tile, and an all-zero row
// comes out exactly zero.  Names live in namespace f32g.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32g {

constexpr int NT = 256;         // 16 x 16 threads
constexpr int GW = 64;          // columns of a B group: 16 threads x 4

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

template <int TM, int STAGES, int BK>
struct Tile {
  static_assert(BK % 16 == 0, "whole float4 loads a thread");
  static constexpr int BM = 16 * TM;
  static constexpr int STAGE = BM * BK + BK * 2 * GW;     // floats
  static constexpr int BYTES = STAGES * STAGE * 4;
};

// B group g of a pass: its first column's pointer (row 0) and the number
// of its columns that exist (<= 0: none); both groups share the row pitch
struct Groups {
  const float* b[2];
  int n[2];
  size_t ld;
};

// acc[g][i][j] += sum_k x[ty TM + i, k] * B_g[k, tx 4 + j] over K (a
// multiple of BK) for ``rows`` rows of x (row pitch ldx), in k order.
template <int TM, int STAGES, int BK>
__device__ __forceinline__ void tile_loop(float* smem,
                                          const float* __restrict__ x,
                                          size_t ldx, int rows, int K,
                                          const Groups& gr,
                                          float (&acc)[2][TM][4]) {
  using T = Tile<TM, STAGES, BK>;
  constexpr int BM = T::BM;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nk = K / BK;

  auto load = [&](int kt, int stage) {
    float* as = smem + stage * T::STAGE;
    float* bs = as + BM * BK;
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
#pragma unroll
    for (int i = 0; i < BK * 2 * GW / 4 / NT; ++i) {
      const int idx = tid + i * NT;
      const int k = idx / (2 * GW / 4), cc = (idx % (2 * GW / 4)) * 4;
      const bool g1 = cc >= GW;
      const int c = cc - (g1 ? GW : 0);
      const bool ok = c < (g1 ? gr.n[1] : gr.n[0]);
      cp16(bs + k * 2 * GW + cc,
           ok ? (g1 ? gr.b[1] : gr.b[0]) + (size_t)(k0 + k) * gr.ld + c
              : gr.b[0], ok);
    }
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
    const float* bs = as + BM * BK;
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
  wait_groups<0>();                     // no copy outlives the block
}

// Pass 1 on a row tile: rows of x [rows, D] (pitch D) against expert w1e
// [D, 2F]; dst[r * F + f0 + c] = silu(gate) * up for the block's 64 h
// columns from f0.
template <int TM, int STAGES, int BK>
__device__ __forceinline__ void up_tile(float* smem, const float* x,
                                        int rows, const float* w1e,
                                        float* dst, int D, int F, int f0) {
  Groups gr{{w1e + f0, w1e + F + f0}, {F - f0, F - f0}, 2 * (size_t)F};
  float acc[2][TM][4];
  tile_loop<TM, STAGES, BK>(smem, x, D, rows, D, gr, acc);
  const int ty = threadIdx.x / 16, c = f0 + (threadIdx.x % 16) * 4;
  if (c >= F) return;                   // F % 32 == 0: all 4 or none
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= rows) break;
    float h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float g = acc[0][i][j];
      h[j] = g / (1.0f + expf(-g)) * acc[1][i][j];
    }
    *reinterpret_cast<float4*>(dst + (size_t)r * F + c) =
        make_float4(h[0], h[1], h[2], h[3]);
  }
}

// Pass 2 on a row tile: rows of h [rows, F] (pitch F) against expert w2e
// [F, D]; dst[r * D + d0 + c] for the block's 128 output columns from d0.
template <int TM, int STAGES, int BK>
__device__ __forceinline__ void down_tile(float* smem, const float* h,
                                          int rows, const float* w2e,
                                          float* dst, int D, int F, int d0) {
  Groups gr{{w2e + d0, w2e + d0 + GW}, {D - d0, D - d0 - GW}, (size_t)D};
  float acc[2][TM][4];
  tile_loop<TM, STAGES, BK>(smem, h, F, rows, F, gr, acc);
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

}  // namespace f32g
