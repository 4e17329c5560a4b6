// The f32 LayerNorm row passes of the block kernels at f32, one warp a
// row: the LN rows pass that K2 and K4 at f32 share (fused_qkv_f32.cu,
// fused_mlp_f32.cu), the LN of the TPU kernels neurovit_tpu/ops/
// fused_qkv.py:57 and fused_mlp.py:108 on f32 operands, before their GEMMs
// (tf32x3_wgmma.cuh); the row statistics of K7 at f32 (fused_qkv_bwd_f32.cu); and
// the dz rows of K9 at f32 (fused_mlp_bwd_f32.cu, with the LN) and K8 at
// f32 (fused_outproj_bwd_f32.cu, without). Defined here once and declared
// in ffma.cuh, so the forwards and the backwards take one LayerNorm.
//
// In f32, with nn.layer_norm's order: the mean, then the mean of the
// centred squares, rstd = rsqrt(var + eps), u = (x - mean) * rstd * gamma
// + beta (ln_stats, ln_row). The row is read again from L1/L2 for each
// statistic, so any dim % 4 == 0 is taken.
#include "ffma.cuh"

namespace nvt {
namespace ffma {
namespace {

// One warp's statistics of the row xr, (mean, rstd) to every lane.
__device__ __forceinline__ float2 ln_stats(const float4* __restrict__ xr,
                                           int n4, float eps) {
  const int lane = threadIdx.x & 31;
  const int dim = 4 * n4;
  float s = 0.f;
  for (int c = lane; c < n4; c += 32) {
    const float4 v = xr[c];
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = warp_sum(s) / static_cast<float>(dim);
  float sq = 0.f;
  for (int c = lane; c < n4; c += 32) {
    const float4 v = xr[c];
    const float a = v.x - mean, b = v.y - mean, d = v.z - mean,
                e = v.w - mean;
    sq += (a * a + b * b) + (d * d + e * e);
  }
  const float rstd =
      rsqrtf(warp_sum(sq) / static_cast<float>(dim) + eps);
  return make_float2(mean, rstd);
}

// One warp's LayerNorm of the row xr into ur; returns (mean, rstd).
__device__ __forceinline__ float2 ln_row(const float4* __restrict__ xr,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         float4* __restrict__ ur, int n4,
                                         float eps) {
  const int lane = threadIdx.x & 31;
  const float2 st = ln_stats(xr, n4, eps);
  const float mean = st.x, rstd = st.y;
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  for (int c = lane; c < n4; c += 32) {
    const float4 v = xr[c], g = g4[c], b = b4[c];
    ur[c] = make_float4((v.x - mean) * rstd * g.x + b.x,
                        (v.y - mean) * rstd * g.y + b.y,
                        (v.z - mean) * rstd * g.z + b.z,
                        (v.w - mean) * rstd * g.w + b.w);
  }
  return st;
}

__global__ void __launch_bounds__(kRowWarps * 32)
    ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ u,
                   int M, int dim, float eps) {
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t off = static_cast<size_t>(row) * dim;
  ln_row(reinterpret_cast<const float4*>(x + off), gamma, beta,
         reinterpret_cast<float4*>(u + off), dim / 4, eps);
}

__global__ void __launch_bounds__(kRowWarps * 32)
    row_stats_kernel(const float* __restrict__ x, float2* __restrict__ stats,
                     int M, int dim, float eps) {
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const float2 st = ln_stats(
      reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * dim),
      dim / 4, eps);
  if ((threadIdx.x & 31) == 0) stats[row] = st;
}

// dz = dy * mask / keep (dz non-null), with kLn also u and the row's
// statistics as ln_rows_kernel writes them.
template <bool kLn>
__global__ void __launch_bounds__(kRowWarps * 32)
    dz_rows_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ dz,
                   float* __restrict__ u, float2* __restrict__ stats, int M,
                   int dim, float eps, float inv_keep, uint32_t keep_q,
                   uint64_t seed) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t off = static_cast<size_t>(row) * dim;
  if constexpr (kLn) {
    const float2 st = ln_row(reinterpret_cast<const float4*>(x + off), gamma,
                             beta, reinterpret_cast<float4*>(u + off),
                             dim / 4, eps);
    if (lane == 0) stats[row] = st;
  }
  if (dz == nullptr) return;
  for (int c = 4 * lane; c < dim; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(dy + off + c);
    *reinterpret_cast<float4*>(dz + off + c) =
        keep_q ? mul4(v, keep4(off + c, seed, keep_q, inv_keep)) : v;
  }
}

}  // namespace

cudaError_t launch_ln_rows(const float* x, const float* gamma,
                           const float* beta, float* u, int M, int dim,
                           float eps, cudaStream_t stream) {
  ln_rows_kernel<<<(M + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                   stream>>>(x, gamma, beta, u, M, dim, eps);
  return cudaGetLastError();
}

cudaError_t launch_row_stats(const float* x, float2* stats, int M, int dim,
                             float eps, cudaStream_t stream) {
  row_stats_kernel<<<(M + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                     stream>>>(x, stats, M, dim, eps);
  return cudaGetLastError();
}

cudaError_t launch_dz_rows(const float* dy, const float* x,
                           const float* gamma, const float* beta, float* dz,
                           float* u, float2* stats, int M, int dim,
                           float eps, float inv_keep, uint32_t keep_q,
                           uint64_t seed, cudaStream_t stream) {
  const int blocks = (M + kRowWarps - 1) / kRowWarps;
  if (x != nullptr)
    dz_rows_kernel<true><<<blocks, kRowWarps * 32, 0, stream>>>(
        dy, x, gamma, beta, dz, u, stats, M, dim, eps, inv_keep, keep_q,
        seed);
  else
    dz_rows_kernel<false><<<blocks, kRowWarps * 32, 0, stream>>>(
        dy, nullptr, nullptr, nullptr, dz, nullptr, nullptr, M, dim, 0.f,
        inv_keep, keep_q, seed);
  return cudaGetLastError();
}

}  // namespace ffma
}  // namespace nvt
