// An alternative design of csrc/moe_gmm_quant.cu, kept to be timed against
// it by tools/expert_kernel_variants.py (which builds it in place of that
// source); the package never builds it.  Same contract and launch.
//
// A dequantizing stage in shared memory: one producer thread keeps TMA
// loads in flight through two rings, the activation boxes into bf16 stages
// laid out as B1's (wgmma_tiles.cuh) and the int8 weight boxes into a ring
// of their own; three widening warps turn each int8 box into the bf16
// MN-major operand of its bf16 stage (the 128-byte swizzle on both sides,
// fence.proxy.async before the stage is marked full; int4: the low
// nibbles into one operand and the high ones into another); the two
// consumer warpgroups run B1's consume (SS wgmma, one group in flight) on
// the bf16 stages, in B1's orientation (rows as M).  Slower than the
// register-A design at the prefill check's shape on an H100: the widening
// warps, not the tensor cores, set the pace.

#include "quant_common.cuh"
#include "wgmma_tiles.cuh"

using namespace wgt;

constexpr int B_STAGES = 3;              // bf16 stages (x boxes + B operands)
constexpr int Q_STAGES = 3;              // int8 stages
constexpr int Q_BOX = 8192;              // an int8 box, 64 rows x 128 bytes
constexpr int WIDEN_REGS = 48;
constexpr int C_REGS = 224;
constexpr int WIDEN_WARPS = 3;           // warps 9-11; warp 8 lane 0 loads

__host__ __device__ constexpr int q_boxes(bool up, bool packed) {
  return up || !packed ? 2 : 1;
}
__host__ __device__ constexpr int smem_b(bool up, bool packed) {
  return B_STAGES * stage_bytes(2) + Q_STAGES * q_boxes(up, packed) * Q_BOX +
         1024;
}

// Widen int8 box ``src`` (64 rows x 128 bytes, 128-byte swizzle) into the
// bf16 MN-major operand at ``dst`` (two 64 x 64 boxes, the same swizzle):
// int8, or the low (HI false) / high nibbles of packed int4.
template <bool PACKED, bool HI>
__device__ __forceinline__ void widen_box(const uint8_t* src, uint8_t* dst,
                                          int t, int nt) {
  for (int task = t; task < 64 * 8; task += nt) {
    const int r = task / 8, j = task % 8;
    const uint4 v =
        *reinterpret_cast<const uint4*>(src + r * 128 + ((j ^ (r & 7)) << 4));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t p = __byte_perm(w[i], 0u, 0x3120);   // bytes 0 2 1 3
      if constexpr (PACKED) {
        uint32_t lo[2], hi[2];
        widen_i4(p, lo, hi);
        o[2 * i] = HI ? hi[0] : lo[0];
        o[2 * i + 1] = HI ? hi[1] : lo[1];
      } else {
        widen_i8(p, o[2 * i], o[2 * i + 1]);
      }
    }
    uint8_t* row = dst + (j / 4) * BOX_BYTES + r * 128;
    const int c0 = 2 * (j % 4);
    *reinterpret_cast<uint4*>(row + ((c0 ^ (r & 7)) << 4)) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (r & 7)) << 4)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The block's pipeline: nb bf16 stages (k-steps of the activation map)
// fed by int8 stages (int4: two bf16 stages each, low then high nibbles).
// ``load_x(i, st, bar)``: stage i's x boxes; ``load_w(j, q, bar)``: int8
// stage j's weight boxes; ``dst_of(j, box)`` unused.  Returns in the
// consumers with acc filled; the widening warpgroup returns early.
template <bool UP, bool PACKED, class LoadX, class LoadW>
__device__ __forceinline__ bool pipeline(float (&acc)[2][64], uint8_t* dyn,
                                         int n_wg, int nb, LoadX load_x,
                                         LoadW load_w) {
  constexpr int QB = q_boxes(UP, PACKED) * Q_BOX;
  constexpr int PER = PACKED && UP ? 2 : 1;          // bf16 stages an int8 stage
  __shared__ uint64_t full[B_STAGES], empty[B_STAGES];
  __shared__ uint64_t full8[Q_STAGES], empty8[Q_STAGES];
  uint8_t* ring = ring_base(dyn);
  uint8_t* qring = ring + B_STAGES * stage_bytes(2);
  if (threadIdx.x == 0) {
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&full[s], 1 + WIDEN_WARPS);
      mbar_init(&empty[s], 4 * n_wg);
    }
    for (int s = 0; s < Q_STAGES; ++s) {
      mbar_init(&full8[s], 1);
      mbar_init(&empty8[s], WIDEN_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= PRODUCER) {
    setmaxnreg_dec<WIDEN_REGS>();
    const int warp = (threadIdx.x - PRODUCER) / 32, lane = threadIdx.x % 32;
    if (warp == 0) {
      if (lane == 0)
        for (int i = 0; i < nb; ++i) {
          const int j = i / PER;
          if (i % PER == 0) {
            const int q = j % Q_STAGES;
            if (j >= Q_STAGES) mbar_wait(&empty8[q], (j / Q_STAGES - 1) & 1);
            mbar_expect_tx(&full8[q], QB);
            load_w(j, qring + q * QB, &full8[q]);
          }
          const int s = i % B_STAGES;
          if (i >= B_STAGES) mbar_wait(&empty[s], (i / B_STAGES - 1) & 1);
          mbar_expect_tx(&full[s], n_wg * BOX_BYTES);
          load_x(i, ring + s * stage_bytes(2), &full[s]);
        }
      return false;
    }
    const int t = threadIdx.x - PRODUCER - 32, nt = 32 * WIDEN_WARPS;
    for (int i = 0; i < nb; ++i) {
      const int j = i / PER, q = j % Q_STAGES, s = i % B_STAGES;
      if (i % PER == 0) mbar_wait(&full8[q], (j / Q_STAGES) & 1);
      if (i >= B_STAGES) mbar_wait(&empty[s], (i / B_STAGES - 1) & 1);
      const uint8_t* src = qring + q * QB;
      uint8_t* dst = ring + s * stage_bytes(2) + CONSUMERS * BOX_BYTES;
      if constexpr (UP) {
        // gate box -> operand 0, up box -> operand 1
        for (int b = 0; b < 2; ++b) {
          if (PACKED && i % 2)
            widen_box<PACKED, true>(src + b * Q_BOX, dst + b * 2 * BOX_BYTES, t, nt);
          else
            widen_box<PACKED, false>(src + b * Q_BOX, dst + b * 2 * BOX_BYTES, t, nt);
        }
      } else if constexpr (PACKED) {     // low nibbles -> operand 0, high -> 1
        widen_box<true, false>(src, dst, t, nt);
        widen_box<true, true>(src, dst + 2 * BOX_BYTES, t, nt);
      } else {
        for (int b = 0; b < 2; ++b)
          widen_box<false, false>(src + b * Q_BOX, dst + b * 2 * BOX_BYTES, t, nt);
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&full[s]);
        if (i % PER == PER - 1) mbar_arrive(&empty8[q]);
      }
    }
    return false;
  }
  setmaxnreg_inc<C_REGS>();
  const int wg = threadIdx.x / 128;
  if (wg >= n_wg) return false;
  consume<B_STAGES, 2>(acc, ring, full, empty, nb, wg);
  return true;
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS, 1)
gmmq_up_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w1,
               const float* __restrict__ s1, const float* __restrict__ s2,
               const int* __restrict__ tile_expert,
               const int* __restrict__ tile_valid, bf16* __restrict__ h,
               int D, int F, int block_m) {
  const int tile = blockIdx.y;
  if (!tile_valid[tile]) return;
  extern __shared__ uint8_t dyn_smem[];
  const int e = tile_expert[tile], row0 = tile * block_m;
  const int f0 = blockIdx.x * BN;
  const int Dp = PACKED ? D / 2 : D;
  const int n_wg = tile_wgs(block_m);
  const CUtensorMap* mx = &tm_x;
  const CUtensorMap* mw = &tm_w1;
  float acc[2][64];
  // bf16 stage i: int8 its k-step; int4 i even the low nibbles of packed
  // step i / 2 (x at k0), i odd the high ones (x at D/2 + k0)
  if (!pipeline<true, PACKED>(
          acc, dyn_smem, n_wg, D / BK,
          [=](int i, uint8_t* st, uint64_t* bar) {
            const int k0 = PACKED ? (i / 2) * BK + (i % 2) * (D / 2) : i * BK;
            for (int a = 0; a < n_wg; ++a)
              tma_load_3d(st + a * BOX_BYTES, mx, bar, k0, row0 + a * WG_ROWS, 0);
          },
          [=](int j, uint8_t* q, uint64_t* bar) {
            tma_load_3d(q, mw, bar, f0, 0, e * Dp + j * BK);
            tma_load_3d(q + Q_BOX, mw, bar, f0, 1, e * Dp + j * BK);
          }))
    return;
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = acc_row(wg, i), c = f0 + acc_col(i);
    if (r < block_m && c < F) {
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float g = acc[0][i + u] * s1[(size_t)e * 2 * F + c + u];
        const float up = acc[1][i + u] * s1[(size_t)e * 2 * F + F + c + u];
        v[u] = g / (1.0f + __expf(-g)) * up * s2[(size_t)e * F + c + u];
      }
      *reinterpret_cast<__nv_bfloat162*>(h + (size_t)(row0 + r) * F + c) =
          __floats2bfloat162_rn(v[0], v[1]);
    }
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS, 1)
gmmq_down_kernel(const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_w2,
                 const int* __restrict__ tile_expert,
                 const int* __restrict__ tile_valid, bf16* __restrict__ out,
                 int D, int F, int block_m) {
  constexpr int COLS = PACKED ? 128 : 256;
  const int tile = blockIdx.y, row0 = tile * block_m;
  const int Dp = PACKED ? D / 2 : D;
  const int c0 = blockIdx.x * COLS;
  if (!tile_valid[tile]) {
    const int vecs = min(COLS, Dp - c0) / 8;
    for (int i = threadIdx.x; i < block_m * vecs; i += THREADS) {
      bf16* o = out + (size_t)(row0 + i / vecs) * D + c0 + (i % vecs) * 8;
      *reinterpret_cast<uint4*>(o) = make_uint4(0u, 0u, 0u, 0u);
      if (PACKED)
        *reinterpret_cast<uint4*>(o + D / 2) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  extern __shared__ uint8_t dyn_smem[];
  const int e = tile_expert[tile];
  const int n_wg = tile_wgs(block_m);
  const CUtensorMap* mh = &tm_h;
  const CUtensorMap* mw = &tm_w2;
  float acc[2][64];
  if (!pipeline<false, PACKED>(
          acc, dyn_smem, n_wg, (F + BK - 1) / BK,
          [=](int i, uint8_t* st, uint64_t* bar) {
            for (int a = 0; a < n_wg; ++a)
              tma_load_3d(st + a * BOX_BYTES, mh, bar, i * BK, row0 + a * WG_ROWS, 0);
          },
          [=](int j, uint8_t* q, uint64_t* bar) {
            for (int b = 0; b < q_boxes(false, PACKED); ++b)
              tma_load_3d(q + b * Q_BOX, mw, bar, c0 + 128 * b, j * BK, e);
          }))
    return;
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = acc_row(wg, i), c = c0 + (PACKED ? 0 : 128 * b) + acc_col(i);
      if (r < block_m && c < Dp)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (size_t)(row0 + r) * D + c + (PACKED && b ? D / 2 : 0)) =
            __floats2bfloat162_rn(acc[b][i], acc[b][i + 1]);
    }
}

template <bool PACKED>
static int launch(const CUtensorMap& tx, const CUtensorMap& tw1,
                  const CUtensorMap& th, const CUtensorMap& tw2,
                  const void* s1, const void* s2, const void* tile_expert,
                  const void* tile_valid, void* h, void* out, int D, int F,
                  int block_m, int n_tiles, cudaStream_t s) {
  constexpr int smem_up = smem_b(true, PACKED);
  constexpr int smem_down = smem_b(false, PACKED);
  int err;
  if ((err = allow_smem(gmmq_up_kernel<PACKED>, smem_up)) ||
      (err = allow_smem(gmmq_down_kernel<PACKED>, smem_down)))
    return err;
  const int Dp = PACKED ? D / 2 : D;
  const int* te = static_cast<const int*>(tile_expert);
  const int* tv = static_cast<const int*>(tile_valid);
  gmmq_up_kernel<PACKED><<<dim3((F + BN - 1) / BN, n_tiles), THREADS, smem_up, s>>>(
      tx, tw1, static_cast<const float*>(s1), static_cast<const float*>(s2),
      te, tv, static_cast<bf16*>(h), D, F, block_m);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  constexpr int COLS = PACKED ? 128 : 256;
  gmmq_down_kernel<PACKED><<<dim3((Dp + COLS - 1) / COLS, n_tiles), THREADS, smem_down, s>>>(
      th, tw2, te, tv, static_cast<bf16*>(out), D, F, block_m);
  return (int)cudaGetLastError();
}

extern "C" int moe_gmm_quant_launch(const void* xs, const void* w1q,
                                    const void* w2q, const void* s1,
                                    const void* s2, const void* tile_expert,
                                    const void* tile_valid, void* h, void* out,
                                    int M, int D, int F, int block_m, int E,
                                    int packed, void* stream) {
  const int Dp = packed ? D / 2 : D;
  if (D % 64 || Dp % 64 || F % 32 || block_m % 8 || block_m > ROWS ||
      block_m <= 0 || M % block_m || E <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = M / block_m;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw1, th, tw2;
  int err;
  if ((err = activation_map(&tx, xs, 1, M, D)) ||
      (err = activation_map(&th, h, 1, M, F)) ||
      (err = weight_maps(&tw1, &tw2, w1q, w2q, E, Dp, F,
                         CU_TENSOR_MAP_DATA_TYPE_UINT8)))
    return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (packed)
    return launch<true>(tx, tw1, th, tw2, s1, s2, tile_expert, tile_valid, h,
                        out, D, F, block_m, n_tiles, s);
  return launch<false>(tx, tw1, th, tw2, s1, s2, tile_expert, tile_valid, h,
                       out, D, F, block_m, n_tiles, s);
}
