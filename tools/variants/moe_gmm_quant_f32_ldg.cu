// An alternative weight stager for the f32 instance of
// csrc/moe_gmm_quant.cu, kept to be timed against it by
// tools/expert_kernel_variants.py (which builds it in place of that
// source); the package never builds it.  Same contract and launch for f32
// activations; bf16 activations are refused (cudaErrorNotSupported).
//
// Each thread loads its stored int8 / int4 words with __ldg and stores
// them widened to f32 straight into the cp.async ring as it stages them,
// so the ring holds f32 weights and no separate f32 stage is needed; its
// loads are synchronous, so they stall the stage.  Slower than the byte
// ring (bytes by cp.async, widened once after they land) at every shape
// measured on an H100 (PERF.md, PR 38).

#include "f32_sgemm.cuh"
#include "quant_common.cuh"
#include "wgmma_tiles.cuh"

using namespace wgt;

constexpr int F32_STAGES = 2;
constexpr int F32_BK = 16;
constexpr int F32_MIN_TM = 4;
constexpr int F32_MIN_BLOCKS = 2;
constexpr bool F32_SKIP = true;

__device__ __forceinline__ float4 i8x4_f32(uint32_t w) {
  const uint32_t o = w ^ 0x80808080u;
  return make_float4(i8_f32<0>(o), i8_f32<1>(o), i8_f32<2>(o), i8_f32<3>(o));
}

__device__ __forceinline__ float4 i4x4_f32(uint32_t w, bool hi) {
  const uint32_t n = hi ? w >> 4 : w;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = (float)((int)(((n >> (8 * j)) & 0xFu) ^ 8u) - 8);
  return make_float4(v[0], v[1], v[2], v[3]);
}

enum QLayout { Q_INT8, Q_INT4_ROWS, Q_INT4_COLS };

// csrc/moe_gmm_quant.cu's QCols with the words widened as loaded.
template <QLayout L>
struct QColsLdg {
  static constexpr int ROW_BYTES = 2 * f32g::GW * 4;
  static constexpr bool WIDENS = false;
  const int8_t* b[2];
  int n[2];
  size_t ld;
  bool hi[2];
  int half;

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
#pragma unroll
    for (int i = 0; i < BK * 2 * GW / 4 / NT; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int k = idx / (2 * GW / 4), cc = (idx % (2 * GW / 4)) * 4;
      const bool g1 = cc >= GW;
      const int c = cc - (g1 ? GW : 0);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < (g1 ? n[1] : n[0]))
        v = widen(__ldg(reinterpret_cast<const uint32_t*>(
                      word(g1, k0 + k, c))), g1, k0 + k);
      *reinterpret_cast<float4*>(ring + k * 2 * GW + cc) = v;
    }
  }

  template <int BK>
  __device__ __forceinline__ const float* ready(const float* ring, float*,
                                                int) const {
    return ring;
  }
};

template <bool PACKED>
using F32QTile = f32g::Tile<f32g::MAX_TM, F32_STAGES, F32_BK,
                            QColsLdg<PACKED ? Q_INT4_ROWS : Q_INT8>>;

template <bool PACKED>
__global__ void __launch_bounds__(f32g::NT, F32_MIN_BLOCKS)
gmmq_up_f32_kernel(const float* __restrict__ xs,
                   const int8_t* __restrict__ w1q,
                   const float* __restrict__ s1, const float* __restrict__ s2,
                   const int* __restrict__ tile_expert,
                   const int* __restrict__ tile_rows, float* __restrict__ h,
                   int D, int F, int block_m) {
  const int tile = blockIdx.y, rows = f32g::tile_count(tile_rows, tile);
  if (rows == 0) return;
  extern __shared__ __align__(16) float fsm[];
  const int e = tile_expert[tile], f0 = blockIdx.x * f32g::GW;
  const int8_t* w1e = w1q + (size_t)e * (PACKED ? D / 2 : D) * 2 * F;
  const float* sg = s1 + (size_t)e * 2 * F;
  const float* sd = s2 + (size_t)e * F;
  const size_t row0 = (size_t)tile * block_m;
  const QColsLdg<PACKED ? Q_INT4_ROWS : Q_INT8> w{
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
    const int Dp = PACKED ? D / 2 : D;
    const int8_t* w2e = w2q + (size_t)tile_expert[tile] * F * Dp;
    QColsLdg<PACKED ? Q_INT4_COLS : Q_INT8> w{{}, {}, (size_t)Dp, {}, D / 2};
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

extern "C" int moe_gmm_quant_launch(const void* xs, const void* w1q,
                                    const void* w2q, const void* s1,
                                    const void* s2, const void* tile_expert,
                                    const void* tile_valid, void* tile_rows,
                                    void* h, void* out, int M, int D, int F,
                                    int block_m, int E, int packed, int f32,
                                    void* stream) {
  const int Dp = packed ? D / 2 : D;
  if (D % 64 || Dp % 64 || F % 32 || block_m % 8 || block_m > 128 ||
      block_m <= 0 || M % block_m || E <= 0)
    return (int)cudaErrorInvalidValue;
  if (M / block_m > 65535) return (int)cudaErrorInvalidValue;
  if (!f32) return (int)cudaErrorNotSupported;
  return (packed ? launch_f32<true> : launch_f32<false>)(
      xs, w1q, w2q, s1, s2, tile_expert, tile_valid, tile_rows, h, out, M, D,
      F, block_m, reinterpret_cast<cudaStream_t>(stream));
}
