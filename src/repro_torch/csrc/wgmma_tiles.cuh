// Device and host code for Hopper expert kernels built on TMA and wgmma
// (moe_gmm.cu, moe_ffn.cu; moe_gmm_quant.cu takes the ring, the register-A
// wgmma_rs and the maps, with tile bodies of its own): a block owns up to
// ROWS rows of one expert's row tile by one block of output columns.  Two
// consumer warpgroups hold 64 rows each, and one producer warpgroup feeds
// them.  Its single elected thread keeps TMA loads (cp.async.bulk.tensor,
// 128-byte swizzle) in flight through a ring of stages in shared memory,
// with completion on
// mbarriers.  The consumers run wgmma.mma_async m64n128k16 (bf16 in, f32
// accumulate in registers) on each stage that has landed and release it
// to the producer.  Every weight tile is read once per row tile, whatever
// its height.
//
// Operands.  A (activation rows, K-major): boxes of 64 rows x 64 k, one
// per consumer warpgroup.  B (weights, [K, N] row major as stored, so
// MN-major): boxes of 64 k x 64 n, two side by side per 128-column B
// operand.  A stage holds CONSUMERS A boxes, then the stage's B operands
// (2 boxes each).  Out-of-bounds box elements (rows past the plane, columns
// past F, k past F) are zero-filled by TMA, so the main loop carries no
// masks; the epilogue stores only rows below the tile's height and columns
// below the matrix's width.
//
// The row-tile bodies, shared by the two kernels (up_tile, down_tile).
// Both take the block's expert ``e`` and its rows: ``rows`` (1..ROWS) rows
// from row ``row0`` of plane ``plane`` of a 3-D activation map [planes,
// M, K] (innermost last), and ``dst``, the tile's first output row
// (row r at dst + r * width).  moe_gmm.cu describes its sorted buffer as
// one plane ([1, M, D]; a tile's rows are block_m apart, the rows past a
// tile are the next tile's and are never stored); moe_ffn.cu describes
// its capacity buffers as one plane an expert ([E, C, D]; a box past C is
// zero-filled and never reads the next expert's rows).
//   up_tile:   dst[r, f0 + c] = silu(x @ w1[e] gate) * (x @ w1[e] up) for
//              128 columns from f0; w1 described as [E * D, 2, F] so a box
//              past F reads zeros, not the up columns or the next expert.
//   down_tile: dst[r, d0 + c] = h @ w2[e] for NB * 128 columns from d0;
//              w2 described as [E, F, D].
// h is rounded to bf16 between the two, as the tensor cores take it.
//
// Tensor maps are encoded on the host through the driver's
// cuTensorMapEncodeTiled, looked up once with cudaGetDriverEntryPoint*
// (no -lcuda at link time); maps of weights are cached by (pointer,
// element type, shape).
// Names live in namespace wgt.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>
#include <mutex>

namespace wgt {

typedef __nv_bfloat16 bf16;

constexpr int WG_ROWS = 64;                  // rows of one consumer warpgroup
constexpr int CONSUMERS = 2;                 // consumer warpgroups
constexpr int ROWS = WG_ROWS * CONSUMERS;    // rows a block owns
constexpr int BN = 128;                      // columns of one B operand
constexpr int BK = 64;                       // contraction step
constexpr int BOX = 64;                      // TMA box edge, elements
constexpr int BOX_BYTES = BOX * BOX * 2;     // 8 KB
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER = 128 * CONSUMERS;    // the producer's elected thread
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

__host__ __device__ constexpr int stage_bytes(int n_b) {        // A boxes, then n_b B operands
  return (CONSUMERS + 2 * n_b) * BOX_BYTES;
}
__host__ __device__ constexpr int smem_bytes(int stages, int n_b) {   // + 1 KB to align the ring
  return stages * stage_bytes(n_b) + 1024;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// arrive once and expect ``bytes`` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity ``parity`` has completed; a wait that
// outlasts any load by far (a broken pipeline) traps, so the launch fails
// with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 26)) asm volatile("trap;");
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return (uint64_t)((bytes & 0x3FFFF) >> 4);
}

// wgmma descriptor of a K-major operand with 128-byte swizzle: rows of 64
// bf16 (128 bytes), 8-row groups 1024 bytes apart; a k16 slice starts 32
// bytes further along the row
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return desc_field(smem_u32(p)) | desc_field(16) << 16 |
         desc_field(1024) << 32 | 1ull << 62;
}

// wgmma descriptor of an MN-major operand with 128-byte swizzle: k-rows of
// 64 bf16, 8-row groups 1024 bytes apart (stride offset), 64-column boxes
// BOX_BYTES apart (leading offset); a k16 slice starts 2048 bytes further
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  return desc_field(smem_u32(p)) | desc_field(BOX_BYTES) << 16 |
         desc_field(1024) << 32 | 1ull << 62;
}

// d[64] += A (64 x 16, K-major) * B (16 x 128, MN-major), bf16 in, f32
// accumulate; thread t of the warpgroup holds d[i] at row
// 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (t % 4) + i % 2
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d[N / 2] += A (64 x 16, bf16 in registers) * B (16 x N, K-major in
// shared memory), f32 accumulate.  Warp w of the warpgroup holds A rows
// 16w..16w+15 as mma.m16n8k16 holds its A: a[0] rows g, k 2q..2q+1; a[1]
// rows g + 8, the same k; a[2], a[3] the same at k + 8 (g = lane / 4, q =
// lane % 4; low half first).  d as in wgmma_m64n128k16, N columns.  The
// registers of a are read after the call returns: they must keep their
// values until the wgmma_wait that retires the group.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// consumer warpgroups of a tile of ``rows`` rows
__host__ __device__ constexpr int tile_wgs(int rows) {
  return (rows + WG_ROWS - 1) / WG_ROWS;
}

// The block's ring: the dynamic shared memory rounded up to 1024 bytes (the
// 128-byte swizzle repeats every 8 rows); full[s] completes when stage s
// has landed, empty[s] when every active consumer warp has released it.
__device__ __forceinline__ uint8_t* ring_base(uint8_t* dyn) {
  return dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023);
}

template <int STAGES>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int active_wg) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * active_wg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer's elected thread: for each of nk steps, wait for the stage
// to be free, expect ``bytes``, and let ``load(i, stage, bar)`` issue its
// TMA loads.
template <int STAGES, int STAGE_BYTES, class Load>
__device__ __forceinline__ void produce(uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int nk,
                                        uint32_t bytes, Load load) {
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);   // round 0 passes
    mbar_expect_tx(&full[s], bytes);
    load(i, ring + s * STAGE_BYTES, &full[s]);
  }
}

// A consumer warpgroup ``wg``: acc[b] = sum over the nk stages of its A
// box times B operand b.  A stage is released once the wgmma group that
// read it has completed (one group stays in flight).
template <int STAGES, int NB>
__device__ __forceinline__ void consume(float (&acc)[NB][64], uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        int nk, int wg) {
  constexpr int STAGE_BYTES = stage_bytes(NB);
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[b][i] = 0.f;
  const bool signal = threadIdx.x % 32 == 0;
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* st = ring + s * STAGE_BYTES;
    const uint8_t* sa = st + wg * BOX_BYTES;
    const uint8_t* sb = st + CONSUMERS * BOX_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = desc_k(sa + kk * 32);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        wgmma_m64n128k16(acc[b], da,
                         desc_mn(sb + b * 2 * BOX_BYTES + kk * 2048));
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0 && signal) mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  wgmma_wait<0>();
}

// ------------------------------------------------------ row-tile bodies

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.0f + __expf(-g)) * u;
}

// Row and column (from the block's first) of register pair i of a
// consumer warpgroup's m64n128 accumulator (layout at wgmma_m64n128k16).
__device__ __forceinline__ int acc_row(int wg, int i) {
  const int t = threadIdx.x % 128;
  return wg * WG_ROWS + 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4);
}

// Pass 1 on one row tile: 128 columns of SwiGLU(x; w1[e]) from f0.  Needs
// the block's dynamic shared memory ``dyn`` of smem_bytes(STAGES, 2).
template <int STAGES>
__device__ __forceinline__ void up_tile(uint8_t* dyn, const CUtensorMap* mx,
                                        const CUtensorMap* mw, int e,
                                        int plane, int row0, int rows,
                                        bf16* dst, int D, int F, int f0) {
  const int n_wg = tile_wgs(rows);
  __shared__ uint64_t full[STAGES], empty[STAGES];
  uint8_t* ring = ring_base(dyn);
  ring_init<STAGES>(full, empty, n_wg);
  if (threadIdx.x >= PRODUCER) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER)
      produce<STAGES, stage_bytes(2)>(
          ring, full, empty, D / BK, (n_wg + 4) * BOX_BYTES,
          [=](int i, uint8_t* st, uint64_t* bar) {
            const int k0 = i * BK;
            for (int a = 0; a < n_wg; ++a)
              tma_load_3d(st + a * BOX_BYTES, mx, bar, k0,
                          row0 + a * WG_ROWS, plane);
            uint8_t* sb = st + CONSUMERS * BOX_BYTES;
            for (int b = 0; b < 4; ++b)         // gate, gate, up, up
              tma_load_3d(sb + b * BOX_BYTES, mw, bar, f0 + (b % 2) * BOX,
                          b / 2, e * D + k0);
          });
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128;
    if (wg < n_wg) {
      float acc[2][64];                          // gate, up
      consume<STAGES, 2>(acc, ring, full, empty, D / BK, wg);
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = acc_row(wg, i), c = f0 + acc_col(i);
        if (r < rows && c < F)
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * F + c) =
              __floats2bfloat162_rn(silu_mul(acc[0][i], acc[1][i]),
                                    silu_mul(acc[0][i + 1], acc[1][i + 1]));
      }
    }
  }
}

// Pass 2 on one row tile: NB * 128 columns of h @ w2[e] from d0.  Needs
// the block's dynamic shared memory ``dyn`` of smem_bytes(STAGES, NB).
template <int STAGES, int NB>
__device__ __forceinline__ void down_tile(uint8_t* dyn, const CUtensorMap* mh,
                                          const CUtensorMap* mw, int e,
                                          int plane, int row0, int rows,
                                          bf16* dst, int D, int F, int d0) {
  const int n_wg = tile_wgs(rows);
  const int nk = (F + BK - 1) / BK;
  __shared__ uint64_t full[STAGES], empty[STAGES];
  uint8_t* ring = ring_base(dyn);
  ring_init<STAGES>(full, empty, n_wg);
  if (threadIdx.x >= PRODUCER) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER)
      produce<STAGES, stage_bytes(NB)>(
          ring, full, empty, nk, (n_wg + 2 * NB) * BOX_BYTES,
          [=](int i, uint8_t* st, uint64_t* bar) {
            const int k0 = i * BK;
            for (int a = 0; a < n_wg; ++a)
              tma_load_3d(st + a * BOX_BYTES, mh, bar, k0,
                          row0 + a * WG_ROWS, plane);
            uint8_t* sb = st + CONSUMERS * BOX_BYTES;
            for (int b = 0; b < 2 * NB; ++b)
              tma_load_3d(sb + b * BOX_BYTES, mw, bar, d0 + b * BOX, k0, e);
          });
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128;
    if (wg < n_wg) {
      float acc[NB][64];
      consume<STAGES, NB>(acc, ring, full, empty, nk, wg);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int r = acc_row(wg, i), c = d0 + b * BN + acc_col(i);
          if (r < rows && c < D)
            *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * D + c) =
                __floats2bfloat162_rn(acc[b][i], acc[b][i + 1]);
        }
    }
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  });
  return fn;
}

// A tensor map of elements of ``type`` over ``rank`` (2 or 3) dims,
// innermost first, with byte strides of dims 1.., a box of ``box``
// elements, 128-byte swizzle and zero fill out of bounds.  ``cache``:
// reuse the map made before for the same pointer, element type and shape
// (weights: an int8 and a bf16 map of one pointer and shape are two
// maps); returns 0 or a cudaError_t.
inline int make_map(CUtensorMap* map, const void* ptr,
                    CUtensorMapDataType type, int rank, const uint64_t* dims,
                    const uint64_t* strides, const uint32_t* box, bool cache) {
  constexpr int N = 128;
  constexpr int K = 11;
  static std::mutex mu;
  static uint64_t keys[N][K];
  static CUtensorMap maps[N];
  static int used = 0, next = 0;
  uint64_t key[K] = {reinterpret_cast<uint64_t>(ptr), (uint64_t)rank,
                     (uint64_t)type};
  for (int i = 0; i < rank; ++i) {
    key[3 + i] = dims[i];
    key[8 + i] = box[i];
  }
  for (int i = 0; i + 1 < rank; ++i) key[6 + i] = strides[i];
  std::lock_guard<std::mutex> lock(mu);
  if (cache)
    for (int i = 0; i < used; ++i)
      if (!memcmp(keys[i], key, sizeof key)) {
        *map = maps[i];
        return 0;
      }
  EncodeTiledFn fn = encoder();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint32_t estride[3] = {1, 1, 1};
  CUresult r = fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
                  estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  if (cache) {
    memcpy(keys[next], key, sizeof key);
    maps[next] = *map;
    next = (next + 1) % N;
    used = used < N ? used + 1 : N;
  }
  return 0;
}

// The 3-D map of a row-major [planes, rows, width] bf16 activation (x or
// h) in 64 x 64 boxes, encoded per call.
inline int activation_map(CUtensorMap* map, const void* ptr, uint64_t planes,
                          uint64_t rows, uint64_t width) {
  const uint64_t dims[3] = {width, rows, planes};
  const uint64_t strides[2] = {2 * width, 2 * width * rows};
  const uint32_t box[3] = {BOX, BOX, 1};
  return make_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dims,
                  strides, box, false);
}

// The cached maps of one layer's experts w1 [E, Dp, 2F] and w2 [E, F, Dp]
// of ``type``: bf16 (Dp = D), or int8 (Dp = D, or D / 2 for int4 packed
// two a byte).  w1 as [E * Dp, 2, F] in boxes of 128 bytes x 1 x 64 rows
// (gate and up apart), w2 in 128 bytes x 64 x 1: 64 x 64 bf16 or 64 x 128
// int8, 8 KB either way.
inline int weight_maps(CUtensorMap* tw1, CUtensorMap* tw2, const void* w1,
                       const void* w2, uint64_t E, uint64_t Dp, uint64_t F,
                       CUtensorMapDataType type =
                           CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const uint64_t es = type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 1;
  const uint32_t inner = 128 / es;
  const uint64_t dw1[3] = {F, 2, E * Dp}, sw1[2] = {es * F, 2 * es * F};
  const uint64_t dw2[3] = {Dp, F, E}, sw2[2] = {es * Dp, es * F * Dp};
  const uint32_t box_w1[3] = {inner, 1, BOX}, box_w2[3] = {inner, BOX, 1};
  int err = make_map(tw1, w1, type, 3, dw1, sw1, box_w1, true);
  return err ? err : make_map(tw2, w2, type, 3, dw2, sw2, box_w2, true);
}

// Let ``kernel`` use ``bytes`` of dynamic shared memory.
template <class Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace wgt
