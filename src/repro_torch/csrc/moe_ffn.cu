// moe_ffn: per-expert SwiGLU over capacity buffers (the dense MoE path).
//
// Replaces the TPU kernel src/repro/kernels/moe_ffn.py::moe_ffn_pallas.
// Contract (identical): xe [E, C, D], w1 [E, D, 2F] (gate = first F
// columns, up = next F), w2 [E, F, D] -> out [E, C, D] in xe's dtype (bf16),
// out[e] = (silu(xe[e] @ w1[e][:, :F]) * (xe[e] @ w1[e][:, F:])) @ w2[e]
// with f32 products.  It walks every expert, empty or not, and every
// capacity row: a row no token copy filled is zero in xe, and comes out
// exactly zero (silu(0) * 0 = 0, and 0 @ w2 = 0).
//
// What bounds it on the H100: bytes.  Every expert's weights are read,
// whatever the routing: at OLMoE-1B-7B's experts (E 64, D 2048, F 1024)
// 805 MB of bf16, 0.24 ms at 3.35 TB/s, plus the [E, C, D] buffers in and
// out (C 4 at a decode step of 8 slots, 320 in a 4 x 512-token forward at
// top-8).  At C 320 the tensor-core work (258 GFLOP, 0.26 ms at 989
// TFLOP/s) is about as long as the bytes.
//
// Design.  The TPU grid (E, C/bc, F/bf) carries an f32 [bc, D] accumulator
// across its sequential F steps in VMEM (1-5 MB); that does not fit the
// 227 KB of shared memory a CUDA block may use, and CUDA blocks run in no
// order.  So it is B1's (moe_gmm.cu) two passes over a bf16 [E, C, F]
// scratch h, with wmma_tiles.cuh's block bodies:
//   pass 1 (ffn_up),   grid (E * ceil(C/64), ceil(F/64)):
//       h[e, rows, f0:f0+64] = silu(xe[e] @ w1[e] gate) * (xe[e] @ up)
//   pass 2 (ffn_down), grid (E * ceil(C/64), D/64):
//       out[e, rows, d0:d0+64] = h[e, rows] @ w2[e][:, d0:d0+64]
// A block reads its expert from blockIdx (there is no routing table: the
// buffers are in expert order) and owns a 64-row by 64-column output
// block.  Products run on the tensor cores through WMMA, bf16 in and f32
// accumulated.  h is rounded to bf16 between the passes, as the tensor
// cores take it -- the TPU kernel keeps it in f32 -- so the result differs
// from the f32 reference by about bf16's relative step on each row.
// C is a multiple of 4 but rarely of 64: rows past C in the last row block
// are zero-filled on load and never stored.  F may be any multiple of 32
// (an intra-pruned DeepSeek-V2-Lite expert has F = 1056): pass 1's last
// column block loads zeros past F and stores only the columns below it.
// At C > 64 each row block of an expert re-reads its weights (from L2 when
// the blocks of one expert run together); synchronous loads, one barrier
// a step: no double buffering, TMA or wgmma yet -- that is later work.

#include "wmma_tiles.cuh"

__global__ void __launch_bounds__(NT)
ffn_up_kernel(const bf16* __restrict__ xe, const bf16* __restrict__ w1,
              bf16* __restrict__ h, int C, int D, int F, int chunks) {
  const int e = blockIdx.x / chunks;
  const int r0 = (blockIdx.x % chunks) * BM;
  const size_t row0 = (size_t)e * C + r0;
  up_block(xe + row0 * D, w1 + (size_t)e * D * 2 * F, h + row0 * F,
           min(BM, C - r0), D, F, blockIdx.y * BN);
}

__global__ void __launch_bounds__(NT)
ffn_down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2,
                bf16* __restrict__ out, int C, int D, int F, int chunks) {
  const int e = blockIdx.x / chunks;
  const int r0 = (blockIdx.x % chunks) * BM;
  const size_t row0 = (size_t)e * C + r0;
  down_block(h + row0 * F, w2 + (size_t)e * F * D, out + row0 * D,
             min(BM, C - r0), D, F, blockIdx.y * BN);
}

// xe [E, C, D], w1 [E, D, 2F], w2 [E, F, D], out [E, C, D] bf16; h
// [E, C, F] bf16 scratch.  Needs D % 64 == 0 and F % 32 == 0.  Returns
// cudaGetLastError() after launch.
extern "C" int moe_ffn_launch(const void* xe, const void* w1, const void* w2,
                              void* h, void* out, int E, int C, int D, int F,
                              void* stream) {
  const int chunks = (C + BM - 1) / BM;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  ffn_up_kernel<<<dim3(E * chunks, (F + BN - 1) / BN), NT, 0, s>>>(
      static_cast<const bf16*>(xe), static_cast<const bf16*>(w1),
      static_cast<bf16*>(h), C, D, F, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_down_kernel<<<dim3(E * chunks, D / BN), NT, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
      static_cast<bf16*>(out), C, D, F, chunks);
  return (int)cudaGetLastError();
}
