// Device code shared by the quantized-expert kernels (moe_gmm_quant.cu,
// moe_decode_quant.cu): reading and widening the int8 storage of
// src/repro_torch/models/moe/params.py.
//
// int8: one signed value per byte.  int4: two values per byte in blocked
// halves along D -- byte i holds element i in its low nibble and element
// i + D/2 in its high nibble (not the interleaved (2i, 2i+1) pairs of most
// GPU int4 formats).  Every value, int8 in [-127, 127] or int4 in
// [-8, 7], is exact in bf16 and in f32, so a product over widened integer
// values is the TPU kernel's f32 dot up to summation order.
//
// Widening works on whole 32-bit words, several values an instruction:
// a masked nibble ORed under the exponent of 128.0 is the bf16 128 + n,
// and one bf16x2 fma takes two such pairs to their exact values (bf16
// holds every integer up to 256, so no step rounds).  To f32, a byte
// permute under the exponent of 2^23 gives 2^23 + byte, and one add the
// value.

#pragma once

#include <stdint.h>

// d = a * b + c on bf16 pairs (low half first); exact wherever it is used
// here
__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

constexpr uint32_t BF2_ONE = 0x3F803F80u;       // (1, 1)
constexpr uint32_t BF2_16 = 0x41804180u;        // (16, 16)
constexpr uint32_t BF2_M136 = 0xC308C308u;      // (-136, -136)
constexpr uint32_t BF2_M2304 = 0xC510C510u;     // (-2304, -2304)

// The nibbles at bits s..s+3 and s+16..s+19 of w, each read as a signed
// int4 (n ^ 8 is n + 8 in offset binary), as the bf16 pair (136 + n0,
// 136 + n1).
template <int S>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w) {
  return ((w >> S) & 0x000F000Fu) ^ 0x43084308u;
}

// Four int8 of a word as two exact bf16 pairs: p02 = (byte 0, byte 2),
// p13 = (byte 1, byte 3).  A byte is 16 h + l with h its signed high
// nibble and l its low one: fma(136 + h, 16, -2304) = 16 h - 128, plus
// 128 + l.
__device__ __forceinline__ void widen_i8(uint32_t w, uint32_t& p02,
                                         uint32_t& p13) {
  const uint32_t l02 = (w & 0x000F000Fu) | 0x43004300u;
  const uint32_t l13 = ((w >> 8) & 0x000F000Fu) | 0x43004300u;
  p02 = bf2_fma(l02, BF2_ONE, bf2_fma(nibble_pair<4>(w), BF2_16, BF2_M2304));
  p13 = bf2_fma(l13, BF2_ONE, bf2_fma(nibble_pair<12>(w), BF2_16, BF2_M2304));
}

// Four packed int4 bytes of a word as exact bf16 pairs: lo[0] = the low
// nibbles of bytes (0, 2), lo[1] of bytes (1, 3), hi[] the high nibbles.
__device__ __forceinline__ void widen_i4(uint32_t w, uint32_t (&lo)[2],
                                         uint32_t (&hi)[2]) {
  lo[0] = bf2_fma(nibble_pair<0>(w), BF2_ONE, BF2_M136);
  hi[0] = bf2_fma(nibble_pair<4>(w), BF2_ONE, BF2_M136);
  lo[1] = bf2_fma(nibble_pair<8>(w), BF2_ONE, BF2_M136);
  hi[1] = bf2_fma(nibble_pair<12>(w), BF2_ONE, BF2_M136);
}

// The two halves of a bf16 pair as f32 (a shift and a mask).
__device__ __forceinline__ float bf2_lo(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float bf2_hi(uint32_t p) {
  return __uint_as_float(p & 0xFFFF0000u);
}

// Byte i of a word of four int8 as f32, given the word ^ 0x80808080 (the
// bytes as offset binary, v + 128): 2^23 + v + 128 by a byte permute,
// then an add.
template <int I>
__device__ __forceinline__ float i8_f32(uint32_t offset_word) {
  return __uint_as_float(__byte_perm(offset_word, 0x4B000000u, 0x7440 | I)) -
         8388736.0f;
}

// ldmatrix .trans of b16 8 x 8 matrices from shared memory: lanes 0-7 give
// the rows of matrix 0, 8-15 of matrix 1 (16-31 of matrices 2, 3); r[m]
// of lane l holds matrix m's elements (row 2 (l % 4), column l / 4) in its
// low half and (row 2 (l % 4) + 1, column l / 4) in its high half.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}
