// The pieces of the f32 attention kernels: the forward
// (flash_attention_f32.cu, K1 and K6 at f32) and backward
// (flash_attention_bwd_f32.cu, K5 and K6's backward at f32), both on the
// tensor cores by tf32x3.cuh, and K13 at f32 (int8_attention_f32.cu): a
// block of 128 threads (the backward, K13 f32), tiles of f32 rows whose
// 16-byte chunks are permuted by the row's quad (swz) and the cp.async
// copy of a run of a head's rows into such a tile (K13 f32), the score
// clamp, and the dropout bits of four (K13 f32) or sixteen (the forward
// and the backward) consecutive keys of one row.
#pragma once

#include "ffma.cuh"

namespace nvt {
namespace flash_f32 {

constexpr int kThreads = 128;
constexpr float kCap = 96.f;            // the score clamp, +-96 in exp2

// Float offset of chunk c (4 floats) of row r in a tile of rows w floats
// wide (w % 32 == 0), its chunks permuted by the row's quad.
__device__ __forceinline__ int swz(int r, int c, int w) {
  return r * w + ((c ^ ((r >> 2) & 7)) << 2);
}

// Copy rows [r0, r0 + rows) of a head (either layout) into a tile,
// zero-filling rows past N; swizzled (kSwz) or as they lie.
template <int D, int kRows, bool kSwz, bool kBhnd>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           const HeadRows<kBhnd>& hr, int r0,
                                           int N) {
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const bool valid = r0 + r < N;
    const float* from = src + hr.base +
                        static_cast<size_t>(valid ? r0 + r : 0) * hr.stride +
                        ch * 4;
    ffma::cp_async16(dst + (kSwz ? swz(r, ch, D) : r * D + ch * 4), from,
                     valid);
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint4& w, uint32_t j) {
  const uint32_t word =
      (j >> 2) == 0 ? w.x : ((j >> 2) == 1 ? w.y : ((j >> 2) == 2 ? w.z : w.w));
  return (word >> (8 * (j & 3))) & 0xffu;
}

// Bit j set where element i0 + j (j < 4) of the mask's Philox stream is
// kept (its byte below keep_q): byte i % 16 of Philox4x32-10(i / 16,
// seed). At N = 1001 four consecutive keys may straddle two blocks.
__device__ __forceinline__ uint32_t keep_bits4(uint64_t i0, uint64_t seed,
                                               uint32_t keep_q) {
  const uint4 w0 = philox4x32_10(i0 >> 4, seed);
  const uint4 w1 = ((i0 + 3) >> 4) != (i0 >> 4)
                       ? philox4x32_10((i0 + 3) >> 4, seed)
                       : w0;
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t e = i0 + j;
    const uint32_t byte = byte_of((e >> 4) == (i0 >> 4) ? w0 : w1,
                                  static_cast<uint32_t>(e & 15));
    bits |= static_cast<uint32_t>(byte < keep_q) << j;
  }
  return bits;
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
