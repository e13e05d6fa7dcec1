// flash_decode_paged_mla: one-token weight-absorbed MLA decode attention
// over a paged latent pool.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_decode_paged.py::flash_decode_paged_mla_pallas.
// Contract (identical): q_lat [B, H, R] f32 (q_nope folded through
// W_kv_b(k)); q_rope [B, H, DR] f32; ckvp [N, P, R] bf16; kropep [N, P, DR]
// bf16; posp [N, P] int32; block_tables [B, n_blk] int32 (row pitch
// bt_stride, so a truncated view table[:, :n_live] needs no copy); cur_pos
// [B] int32 -> out [B, H, R] f32, the latent attention output (the caller
// folds W_kv_b(v) in).  s = (q_lat . ckv + q_rope . krope) * scale over the
// slots with 0 <= posp <= cur_pos, softmax, out = p . ckv.  Table entries
// equal to the trash page 0 are skipped; a row with no valid slot (an idle
// batch row) gets zeros.  R = 512, DR = 64, H <= 16 (DeepSeek-V2-Lite:
// kv_lora_rank 512, qk_rope_head_dim 64, 16 heads).
//
// What bounds it on the H100.  Every head reads the same latent row (MQA
// over the latents): per live slot 576 bf16 values are read once for all
// heads, and each head does 2 * (R + DR) + 2 * R f32 operations on them.
// At B 8 with 2012 live positions on 127 pages of 16 the latents are
// 2.34 MB (0.70 us at 3.35 TB/s; about 2.9 MB and 0.87 us with q, out and
// posp) and the work 70 MFLOP of f32 FMAs (1.04 us at the 67 TFLOP/s f32
// rate): operations, narrowly.
//
// Design.  The TPU kernel walks a row's table in order on one core,
// carrying the softmax state (m, l and a [H, R] f32 accumulator) across
// grid steps.  Here the accumulator of one row is 16 x 512 f32 = 32 KB, too
// big to copy per warp as the GQA kernel does, so one block of 256 threads
// holds it: warp w owns heads 2w and 2w + 1, and lane i owns latent
// columns 8i .. 8i + 7 and 256 + 8i .. 256 + 8i + 7 of both (32 values),
// with the same query columns (and rope columns 2i, 2i + 1), scaled as the
// TPU kernel scales them, in registers.  Pass 1 splits a row's table
// columns between `splits` blocks (`per` columns each, grid (splits, B)),
// so that about two blocks per SM are in flight.  A block stages one tile
// of 16 slots of a page at a time in shared memory (18 KB, read from device
// memory once for all 16 heads: MQA over the latents).  Each lane forms
// its partial dot products for the warp's 2 heads x 16 slots from its own
// columns; a butterfly reduce-scatter over the warp (31 shuffles) leaves
// lane i with the full score of (head 2w + i / 16, slot i % 16); the
// per-head max and sum are reduced over the head's 16 lanes; the
// probabilities and the rescale factors reach the accumulator lanes by
// shuffles, so a tile needs no barrier past its load, and every latent
// value read from shared memory feeds 2 heads.  Masked slots get
// probability 0 exactly (the TPU kernel gives them exp(0) while a row has
// seen no valid slot, which only matters for a row with none).  Each block
// writes its partial state (acc, m, l); pass 2 (one block per (head,
// row), 4 columns a thread) merges the splits with the usual rescaling,
// skipping splits that saw no valid slot.  f32 FMAs on bf16-loaded
// latents, as the TPU kernel's f32 dots.  On the H100 at the check shape
// (B 8, 127 pages) this runs 0.025 ms against a first design's 0.031 (one
// score per thread against the query held in shared memory, reread for
// every slot); both are latency-bound, far from the bound (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define TRASH_PAGE 0
#define MLA_NT 256
#define MLA_HMAX 16
#define MLA_TILE 16             // slots of a page staged at once
#define MLA_NEG_INF -1e30f

// 8 bf16 packed in a uint4 -> 8 floats
__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One butterfly step of a warp's reduce-scatter of v[0 .. 2O): afterwards
// v[0 .. O) holds the sums over the lane pair (lane, lane ^ O) of the half
// that the lane's bit O selects, so after the steps 16, 8, 4, 2, 1 lane i
// holds the warp's sum of v[i].
template <int O>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32],
                                                    int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <int R, int DR>
__global__ void __launch_bounds__(MLA_NT)
mla_partial_kernel(const float* __restrict__ q_lat,
                   const float* __restrict__ q_rope,
                   const __nv_bfloat16* __restrict__ ckvp,
                   const __nv_bfloat16* __restrict__ kropep,
                   const int* __restrict__ posp,
                   const int* __restrict__ bt, int bt_stride,
                   const int* __restrict__ cur_pos,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int H, int P, int n_blk, int splits, int per, float scale) {
  static_assert(R % 256 == 0 && DR == 64, "the lanes' column layout");
  constexpr int NCH = R / 256;            // 8-column chunks a lane owns
  constexpr int CPR = R / 8;              // 16-byte chunks per latent row
  __shared__ __align__(16) __nv_bfloat16 ck[MLA_TILE * R];
  __shared__ __align__(16) __nv_bfloat16 kr[MLA_TILE * DR];
  const int split = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int h0 = 2 * warp;                // the warp's heads h0, h0 + 1
  const int cur = cur_pos[b];

  // this lane's query columns of both heads, scaled; heads >= H are zero
  float qn[2][NCH][8], qr[2][2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = h0 + hh;
    const float* ql = q_lat + ((size_t)b * H + h) * R + 8 * lane;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
      if (h < H) {
        a = reinterpret_cast<const float4*>(ql + 256 * i)[0];
        c = reinterpret_cast<const float4*>(ql + 256 * i)[1];
      }
      const float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) qn[hh][i][e] = v[e] * scale;
    }
    float2 r = make_float2(0.f, 0.f);
    if (h < H)
      r = reinterpret_cast<const float2*>(
          q_rope + ((size_t)b * H + h) * DR)[lane];
    qr[hh][0] = r.x * scale;
    qr[hh][1] = r.y * scale;
  }

  float m = MLA_NEG_INF, l = 0.f;         // head h0 + lane / 16's state
  float acc[2][NCH][8];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int i = 0; i < NCH; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[hh][i][e] = 0.f;

  const int j0 = split * per, j1 = min(n_blk, j0 + per);
  for (int j = j0; j < j1; ++j) {
    const int page = bt[(size_t)b * bt_stride + j];
    if (page == TRASH_PAGE) continue;                 // uniform in the block
    for (int p0 = 0; p0 < P; p0 += MLA_TILE) {
      const int ns = min(MLA_TILE, P - p0);
      const size_t row0 = (size_t)page * P + p0;
      __syncthreads();                    // the previous tile is consumed
      for (int c = t; c < MLA_TILE * CPR; c += MLA_NT) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);     // rows past the page: 0
        if (c / CPR < ns)
          v = reinterpret_cast<const uint4*>(ckvp + row0 * R)[c];
        reinterpret_cast<uint4*>(ck)[c] = v;
      }
      for (int c = t; c < MLA_TILE * DR / 8; c += MLA_NT) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c / (DR / 8) < ns)
          v = reinterpret_cast<const uint4*>(kropep + row0 * DR)[c];
        reinterpret_cast<uint4*>(kr)[c] = v;
      }
      __syncthreads();

      // this lane's partial scores: part[16 * hh + s]
      float part[32];
#pragma unroll
      for (int s = 0; s < MLA_TILE; ++s) {
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(
                      ck + s * R + 256 * i + 8 * lane), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            d0 += qn[0][i][e] * f[e];
            d1 += qn[1][i][e] * f[e];
          }
        }
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(kr + s * DR + 2 * lane);
        const float r0 = __uint_as_float(w << 16);
        const float r1 = __uint_as_float(w & 0xffff0000u);
        part[s] = d0 + qr[0][0] * r0 + qr[0][1] * r1;
        part[16 + s] = d1 + qr[1][0] * r0 + qr[1][1] * r1;
      }
      reduce_scatter_step<16>(part, lane);
      reduce_scatter_step<8>(part, lane);
      reduce_scatter_step<4>(part, lane);
      reduce_scatter_step<2>(part, lane);
      reduce_scatter_step<1>(part, lane);

      // lane: (head h0 + lane / 16, slot lane % 16)
      const int sl = lane % 16;
      bool valid = false;
      if (sl < ns) {
        const int pos = posp[row0 + sl];
        valid = pos >= 0 && pos <= cur;
      }
      const float sc = valid ? part[0] : MLA_NEG_INF;
      float tmax = sc;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)     // the head's 16 lanes
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m, tmax);
      const float pv = valid ? __expf(sc - m_new) : 0.f;
      const float alpha = __expf(m - m_new);
      float psum = pv;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l = l * alpha + psum;
      m = m_new;

      // acc[hh] = acc[hh] * alpha + sum_s p[hh][s] * ckv[s][lane's columns]
      const float a0 = __shfl_sync(0xffffffffu, alpha, 0);
      const float a1 = __shfl_sync(0xffffffffu, alpha, 16);
#pragma unroll
      for (int i = 0; i < NCH; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[0][i][e] *= a0;
          acc[1][i][e] *= a1;
        }
      for (int s = 0; s < ns; ++s) {
        const float p0 = __shfl_sync(0xffffffffu, pv, s);
        const float p1 = __shfl_sync(0xffffffffu, pv, 16 + s);
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(
                      ck + s * R + 256 * i + 8 * lane), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            acc[0][i][e] += p0 * f[e];
            acc[1][i][e] += p1 * f[e];
          }
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = h0 + hh;
    const float mh = __shfl_sync(0xffffffffu, m, 16 * hh);
    const float lh = __shfl_sync(0xffffffffu, l, 16 * hh);
    if (h >= H) continue;
    const size_t unit = ((size_t)b * splits + split) * H + h;
    if (lane == 0) {
      part_ml[unit * 2] = mh;
      part_ml[unit * 2 + 1] = lh;
    }
    if (lh > 0.f) {                       // pass 2 skips a split with l = 0
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        float4* dst = reinterpret_cast<float4*>(part_acc + unit * R +
                                                256 * i + 8 * lane);
        dst[0] = make_float4(acc[hh][i][0], acc[hh][i][1], acc[hh][i][2],
                             acc[hh][i][3]);
        dst[1] = make_float4(acc[hh][i][4], acc[hh][i][5], acc[hh][i][6],
                             acc[hh][i][7]);
      }
    }
  }
}

// Pass 2: merge the splits of (row b, head h); thread t owns columns
// 4t .. 4t + 3.
template <int R>
__global__ void __launch_bounds__(R / 4)
mla_merge_kernel(const float* __restrict__ part_acc,
                 const float* __restrict__ part_ml, float* __restrict__ out,
                 int H, int splits) {
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const size_t unit0 = (size_t)b * splits * H + h;   // split s: + s * H
  float mx = MLA_NEG_INF;
  for (int s = 0; s < splits; ++s) {
    const size_t u = unit0 + (size_t)s * H;
    if (part_ml[u * 2 + 1] > 0.f) mx = fmaxf(mx, part_ml[u * 2]);
  }
  float L = 0.f;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const size_t u = unit0 + (size_t)s * H;
    const float ls = part_ml[u * 2 + 1];
    if (!(ls > 0.f)) continue;
    const float w = __expf(part_ml[u * 2] - mx);
    const float4 v = reinterpret_cast<const float4*>(part_acc + u * R)[t];
    L += ls * w;
    A.x += w * v.x; A.y += w * v.y; A.z += w * v.z; A.w += w * v.w;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  reinterpret_cast<float4*>(out + ((size_t)b * H + h) * R)[t] =
      make_float4(A.x * inv, A.y * inv, A.z * inv, A.w * inv);
}

// part: B * splits * H * (R + 2) floats of scratch (the accumulators, then
// (m, l) pairs).  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape without an instantiation).
extern "C" int flash_decode_paged_mla_launch(
    const void* q_lat, const void* q_rope, const void* ckvp,
    const void* kropep, const void* posp, const void* bt, const void* cur_pos,
    void* part, void* out, int B, int H, int P, int n_blk, int bt_stride,
    int splits, int per, float scale, void* stream) {
  constexpr int R = 512, DR = 64;
  if (H < 1 || H > MLA_HMAX || P < 1 || splits < 1 || per < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(part);
  float* ml = acc + (size_t)B * splits * H * R;
  mla_partial_kernel<R, DR><<<dim3(splits, B), MLA_NT, 0, s>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const __nv_bfloat16*>(ckvp),
      static_cast<const __nv_bfloat16*>(kropep),
      static_cast<const int*>(posp), static_cast<const int*>(bt), bt_stride,
      static_cast<const int*>(cur_pos), acc, ml, H, P, n_blk, splits, per,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_merge_kernel<R><<<dim3(H, B), R / 4, 0, s>>>(
      acc, ml, static_cast<float*>(out), H, splits);
  return (int)cudaGetLastError();
}
