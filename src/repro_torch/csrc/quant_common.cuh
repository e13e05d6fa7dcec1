// Device code shared by the quantized-expert kernels (moe_gmm_quant.cu,
// moe_decode_quant.cu): reading the int8 storage of
// src/repro_torch/models/moe/params.py.
//
// int8: one signed value per byte.  int4: two values per byte in blocked
// halves along D -- byte i holds element i in its low nibble and element
// i + D/2 in its high nibble (not the interleaved (2i, 2i+1) pairs of most
// GPU int4 formats).  Every value, int8 in [-127, 127] or int4 in
// [-8, 7], is exact in bf16 and in f32, so a product over dequantized
// integer values is the TPU kernel's f32 dot up to summation order.

#pragma once

#include <stdint.h>

// Byte i (0..3, in memory order) of a little-endian 32-bit word,
// sign-extended.
__device__ __forceinline__ int q_byte(uint32_t word, int i) {
  return (int)(int8_t)(word >> (8 * i));
}

// The low nibble of a sign-extended byte b as a signed int4.
__device__ __forceinline__ int q_lo(int b) { return ((b & 0xF) ^ 8) - 8; }

// The high nibble of a sign-extended byte b as a signed int4: an
// arithmetic shift of the signed value (reading the byte as unsigned and
// shifting would turn every negative weight positive).
__device__ __forceinline__ int q_hi(int b) { return b >> 4; }
