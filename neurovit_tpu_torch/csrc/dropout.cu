// Inverted dropout, generated and applied in one pass (K16), bf16 or f32.
//
// Replaces the TPU kernel neurovit_tpu/ops/dropout.py:30 (_mask_kernel,
// launched at :42 by _run; custom VJP at :55-69):
//   keep(i) = word(i) < threshold,  threshold = uint32(keep * (2^32 - 1))
//   y = (x * keep) * s,             s = 1 / keep rounded to x's dtype
// each product rounded to x's dtype, as the Pallas body computes in it (a
// product of two bf16 values is exact in f32, so one rounding to bf16 of
// the f32 product is the bf16 product). The TPU kernel draws its words
// from the core's PRNG seeded per grid block; no GPU gives those bits. Here
// word(i) of the row-major element i is word i % 4 of Philox4x32-10(i / 4,
// seed) (nvt::DropoutWords, common.cuh): a function of position, so the
// mask does not depend on the block size and the backward -- the same
// kernel on the cotangent with the same seed -- regenerates it.
//
// What bounds it on the H100: one read and one write of x (262 MB at
// [32 * 1001, 2048] bf16, 78 us at 3.35 TB/s) against one Philox call per 4
// elements (about 60 integer operations each), which the SMs' integer
// pipes hide under the memory traffic. A thread takes 8 consecutive
// elements: one 16-byte load and store in bf16 (two in f32) and two Philox
// calls. The tail of a length that is not a multiple of 8 runs scalar.
#include "common.cuh"

namespace nvt {
namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void store8(bf16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack8(f);
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

__device__ __forceinline__ float apply(float x, uint32_t word,
                                       uint32_t threshold, float scale) {
  return __fmul_rn(__fmul_rn(x, word < threshold ? 1.f : 0.f), scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   uint32_t threshold, float scale, uint64_t seed) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (i0 >= n) return;
  DropoutWords words(seed);
  if (i0 + kVec <= n) {
    float f[kVec];
    load8(x + i0, f);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      f[i] = apply(f[i], words.word(i0 + i), threshold, scale);
    store8(y + i0, f);
  } else {
    for (long long i = i0; i < n; ++i)
      put(y + i, apply(to_f32(x[i]), words.word(i), threshold, scale));
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, uint32_t threshold,
           float scale, uint64_t seed, cudaStream_t s) {
  const long long blocks = (n + kThreads * kVec - 1) / (kThreads * kVec);
  dropout_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, threshold, scale, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace nvt

// x, y: n elements, contiguous, 16-byte aligned; is_f32: 1 for f32, 0 for
// bf16. threshold: keep where the element's word is below it; scale: 1 /
// keep as x's dtype holds it.
extern "C" int nvt_dropout(const void* x, void* y, long long n, int is_f32,
                           unsigned int threshold, float scale, uint64_t seed,
                           void* stream) {
  using namespace nvt;
  if (n < 1 || n > (1ll << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch<float>(x, y, n, threshold, scale, seed, s)
                : launch<bf16>(x, y, n, threshold, scale, seed, s);
}
