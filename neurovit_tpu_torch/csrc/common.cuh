// Shared device code for the package's Hopper kernels (sm_90a).
//
// The kernels compute bf16 (or int8) products with f32 (int32)
// accumulation on the tensor cores, on TMA and wgmma (hopper_gemm.cuh);
// the f32 kernels take every f32 product in 3xTF32 on the tensor cores:
// the attention forward and backward on mma.sync (tf32x3.cuh), the other
// GEMMs on wgmma (tf32x3_wgmma.cuh), their row passes on the CUDA cores
// (ffma.cuh).
//
// Host entry points have a plain C interface: each returns the
// cudaError_t of its launch (0 on success) and allocates nothing; the
// Python wrapper allocates every output with torch.empty.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nvt {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr size_t round_up(size_t x, size_t to) {
  return (x + to - 1) / to * to;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Philox4x32-10 (Salmon et al., SC'11) of the counter (ctr, 0) -- the
// 64-bit counter as words (lo, hi, 0, 0) -- under a 64-bit key.
__device__ __forceinline__ uint4 philox4x32_10(uint64_t ctr, uint64_t key) {
  uint32_t c0 = static_cast<uint32_t>(ctr);
  uint32_t c1 = static_cast<uint32_t>(ctr >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = static_cast<uint32_t>(key);
  uint32_t k1 = static_cast<uint32_t>(key >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The 32-bit stream of K16 (csrc/dropout.cu): word i % 4 of Philox(i / 4,
// seed) for element i, with the last Philox block cached, so a thread
// walking contiguous indices pays one Philox call per 4 elements. The
// generator of the dropout masks (nn.py, random_bytes), a word per element
// in place of a byte.
struct DropoutWords {
  uint64_t seed;
  uint64_t block;
  uint4 w;

  __device__ explicit DropoutWords(uint64_t s) : seed(s), block(~0ull) {}

  __device__ __forceinline__ uint32_t word(uint64_t i) {
    const uint64_t b = i >> 2;
    if (b != block) {
      block = b;
      w = philox4x32_10(b, seed);
    }
    const uint32_t j = static_cast<uint32_t>(i) & 3u;
    return j == 0 ? w.x : (j == 1 ? w.y : (j == 2 ? w.z : w.w));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Exact-erf GELU in f32 with CUDA's erff (torch nn.GELU's default). The
// TPU kernels use an Abramowitz-Stegun polynomial (fused_mlp.py:65-79);
// both are within 1.5e-7 of erf.
__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

// Eight bf16 values (one 16-byte vector) <-> floats.
__device__ __forceinline__ void unpack8(uint4 raw, float* f) {
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 raw;
  bf16* h = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(f[i]);
  return raw;
}

// Eight consecutive elements at p (16-byte aligned for bf16, 32 for f32)
// <-> floats: the row passes instanced on the element type.
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack8(f);
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// The rows of one (b, h) attention head, D wide: token t starts at element
// base + t * stride. bnhd [B, N, H, D] (K1, K5): stride H * D, base
// (b * N * H + h) * D. bhnd [B, H, N, D] (K6): stride D, base
// (b * H + h) * N * D.
template <bool kBhnd>
struct HeadRows {
  size_t base, stride;
  __device__ HeadRows(int b, int h, int N, int H, int D)
      : base(kBhnd ? (static_cast<size_t>(b) * H + h) * N * D
                   : (static_cast<size_t>(b) * N * H + h) * D),
        stride(kBhnd ? static_cast<size_t>(D) : static_cast<size_t>(H) * D) {}
};

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace nvt
