// The row passes of the LayerNorm data-grad backward that follow its du
// GEMM, instanced on the element type of x, dy and dx: bf16 behind the
// wgmma du pass of K7 and K9 (ln_bwd.cuh), f32 behind the 3xTF32 wgmma du
// pass of K7 and K9 at f32 (tf32x3_ln_bwd.cuh). Both read du [M, dim] f32,
// each row's (mean, rstd) and the du pass's partial sums from the
// caller's scratch:
//   ln_bwd: one warp a row, its two sums from the du pass's column parts
//           in part order, then one sweep over the row.
//   colsum: dgamma and dbeta from the du pass's row parts, each warp a
//           fixed share in order, the warps' sums in warp order: no
//           atomics, two calls give the same bits.
//
// Everything here has internal linkage: each including source gets its
// own instances, as every .cu links into one library.
#pragma once

#include "common.cuh"

namespace nvt {
namespace {

constexpr int kBwdRowWarps = 8;          // rows (a warp each) a block
constexpr int kSumWarps = 8;             // warps a block of colsum

// The LayerNorm backward of a row (neurovit_tpu/ops/fused_mlp.py:188-196,
// fused_qkv.py:80-96), one warp a row, with the residual dy added where
// kResidual:
//   dx = TO(rstd (du gamma - m1 - xhat m2) [+ dy]),
// m1 and m2 the row means of du gamma and du gamma xhat from the du
// pass's col_parts partials, added in part order. dim % 8 == 0. dx is of
// x's type T, or f32 (TO) where a tensor-parallel shard's partial dx is
// summed over the model group before its one rounding.
template <typename T, bool kResidual, typename TO>
__global__ void __launch_bounds__(kBwdRowWarps * 32)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ du,
                  const float* __restrict__ gamma,
                  const float2* __restrict__ stats,
                  const float* __restrict__ rowpart,
                  const T* __restrict__ dy, TO* __restrict__ dx, int M,
                  int dim, int col_parts) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kBwdRowWarps + threadIdx.x / 32;
  if (row >= M) return;
  const float2 st = stats[row];
  const float* p1 = rowpart + static_cast<size_t>(row) * col_parts;
  const float* p2 = p1 + static_cast<size_t>(M) * col_parts;
  float s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < col_parts; ++t) {
    s1 += p1[t];
    s2 += p2[t];
  }
  const float m1 = s1 / dim, m2 = s2 / dim;
  const size_t base = static_cast<size_t>(row) * dim;
  for (int c = lane * 8; c < dim; c += 256) {
    float xv[8], res[8], out[8];
    load8(x + base + c, xv);
    if constexpr (kResidual) load8(dy + base + c, res);
    const float4 d0 = *reinterpret_cast<const float4*>(du + base + c);
    const float4 d1 = *reinterpret_cast<const float4*>(du + base + c + 4);
    const float4 g0 = *reinterpret_cast<const float4*>(gamma + c);
    const float4 g1 = *reinterpret_cast<const float4*>(gamma + c + 4);
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xhat = __fmul_rn(xv[i] - st.x, st.y);
      if constexpr (kResidual)
        out[i] = st.y * (dv[i] * gm[i] - m1 - xhat * m2) + res[i];
      else
        out[i] = st.y * (dv[i] * gm[i] - m1 - xhat * m2);
    }
    store8(dx + base + c, out);
  }
}

// dgamma and dbeta from the du pass's column partials [2, row_parts, dim],
// 32 columns of the [2 dim] outputs a block: warp w adds row parts w, w +
// 8, ... in order, then the eight warps' sums are added in warp order.
__global__ void __launch_bounds__(kSumWarps * 32)
    colsum_kernel(const float* __restrict__ colpart,
                  float* __restrict__ dgamma, float* __restrict__ dbeta,
                  int row_parts, int dim) {
  __shared__ float red[kSumWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;   // 2 dim is a multiple of 32
  const int which = c / dim, col = c % dim;
  const float* p =
      colpart + static_cast<size_t>(which) * row_parts * dim + col;
  float s = 0.f;
  for (int t = warp; t < row_parts; t += kSumWarps)
    s += p[static_cast<size_t>(t) * dim];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0) return;
  float sum = 0.f;
  for (int w = 0; w < kSumWarps; ++w) sum += red[w][lane];
  (which == 0 ? dgamma : dbeta)[col] = sum;
}

// ln_bwd (residual dy unless it is null) then colsum, on the stream; dx of
// x's type or f32.
template <typename T, typename TO>
cudaError_t launch_ln_bwd_rows(const T* x, const float* du,
                               const float* gamma, const float2* stats,
                               const float* rowpart, const float* colpart,
                               const T* dy, TO* dx, float* dgamma,
                               float* dbeta, int M, int dim, int col_parts,
                               int row_parts, cudaStream_t stream) {
  const int row_blocks = (M + kBwdRowWarps - 1) / kBwdRowWarps;
  if (dy != nullptr)
    ln_bwd_kernel<T, true, TO><<<row_blocks, kBwdRowWarps * 32, 0, stream>>>(
        x, du, gamma, stats, rowpart, dy, dx, M, dim, col_parts);
  else
    ln_bwd_kernel<T, false, TO><<<row_blocks, kBwdRowWarps * 32, 0,
                                  stream>>>(x, du, gamma, stats, rowpart,
                                            nullptr, dx, M, dim, col_parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_kernel<<<2 * dim / 32, kSumWarps * 32, 0, stream>>>(
      colpart, dgamma, dbeta, row_parts, dim);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nvt
