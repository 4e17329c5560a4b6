// The pieces of the f32 attention kernels on the tensor cores
// (tf32x3.cuh): the forward (flash_attention_f32.cu, K1 and K6 at f32) and
// the backward (flash_attention_bwd_f32.cu, K5 and K6's backward at f32):
// a block of 128 threads (the backward), the score clamp, and the dropout
// bits of sixteen consecutive keys of one row.
#pragma once

#include "ffma.cuh"

namespace nvt {
namespace flash_f32 {

constexpr int kThreads = 128;
constexpr float kCap = 96.f;            // the score clamp, +-96 in exp2

__device__ __forceinline__ uint32_t byte_of(const uint4& w, uint32_t j) {
  const uint32_t word =
      (j >> 2) == 0 ? w.x : ((j >> 2) == 1 ? w.y : ((j >> 2) == 2 ? w.z : w.w));
  return (word >> (8 * (j & 3))) & 0xffu;
}

// Bit j set where byte j of the Philox block w is below keep_q.
__device__ __forceinline__ uint32_t keep_bits_of(const uint4& w,
                                                 uint32_t keep_q) {
  uint32_t bits = 0;
#pragma unroll
  for (uint32_t j = 0; j < 16; ++j)
    bits |= static_cast<uint32_t>(byte_of(w, j) < keep_q) << j;
  return bits;
}

// Bit j set where element i0 + j (j < 16) of the mask's Philox stream is
// kept: one Philox block, or two where i0 is not a multiple of 16 (the
// backward's 16-key windows of a row at N = 1001).
__device__ __forceinline__ uint32_t keep_bits16(uint64_t i0, uint64_t seed,
                                                uint32_t keep_q) {
  const uint32_t off = static_cast<uint32_t>(i0 & 15);
  uint32_t bits = keep_bits_of(philox4x32_10(i0 >> 4, seed), keep_q);
  if (off)
    bits |= keep_bits_of(philox4x32_10((i0 >> 4) + 1, seed), keep_q) << 16;
  return (bits >> off) & 0xffffu;
}

}  // namespace flash_f32
}  // namespace nvt
