// The f32 LayerNorm rows pass that K2 and K4 at f32 share
// (fused_qkv_f32.cu, fused_mlp_f32.cu): the LN of the TPU kernels
// neurovit_tpu/ops/fused_qkv.py:57 and fused_mlp.py:108 on f32 operands,
// before their GEMMs (ffma.cuh). Defined here once and declared in
// ffma.cuh, so both sources launch the same kernel.
//
// One warp a row, in f32, with nn.layer_norm's order: the mean, then the
// mean of the centred squares, rstd = rsqrt(var + eps), u = (x - mean) *
// rstd * gamma + beta. The row is read again from L1/L2 for each
// statistic, so any dim % 4 == 0 is taken.
#include "ffma.cuh"

namespace nvt {
namespace ffma {
namespace {

__global__ void __launch_bounds__(kRowWarps * 32)
    ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ u,
                   int M, int dim, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const float4* xr =
      reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * dim);
  float4* ur = reinterpret_cast<float4*>(u + static_cast<size_t>(row) * dim);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  const int n4 = dim / 4;
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
  for (int c = lane; c < n4; c += 32) {
    const float4 v = xr[c], g = g4[c], b = b4[c];
    ur[c] = make_float4((v.x - mean) * rstd * g.x + b.x,
                        (v.y - mean) * rstd * g.y + b.y,
                        (v.z - mean) * rstd * g.z + b.z,
                        (v.w - mean) * rstd * g.w + b.w);
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

}  // namespace ffma
}  // namespace nvt
