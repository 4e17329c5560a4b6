// Fused LayerNorm + bias-free QKV projection (K2) at f32, deterministic, on
// the CUDA cores.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_qkv.py:57 (_fwd_kernel,
// launched at :108 by fused_ln_qkv) on f32 operands, where it sums f32
// products:
//   u = LN(x) * gamma + beta             f32
//   q, k, v = split(u . Wqkv^T)          f32, no bias
// Wqkv is the torch weight [3 inner, dim], rows ordered (3, heads,
// dim_head), so column c of the product is q, k or v by c / inner and
// lands in that tensor's [M, inner] rows, the [B, N, H, D] layout. In
// training u is the caller's output (the backward's dWqkv reads it); in
// serving it goes into a scratch the wrapper allocates.
//
// What bounds it on the H100: its 6 M dim inner flops. At f32 they run
// on the CUDA cores (ffma.cuh says why not yet in 3xTF32): 25.2 GFLOP
// for the flagship block at batch 8 (M = 8008, dim 1024, inner 512), 0.38
// ms at 67 TFLOP/s, above its 93 MB of x, u, Wqkv, q, k and v.
//
// The design, two launches on the caller's stream:
//   1. ln_rows: x -> u [M, dim] f32, one warp a row (ffma.cu), the row
//      read again from L1/L2 for each statistic, so any dim is taken;
//   2. qkv_gemm: ffma.cuh's GEMM over (ceil(3 inner / 128), ceil(M / 128))
//      tiles, A = u, B = Wqkv, its epilogue writing each float4 of the
//      product into q, k or v (inner % 16 == 0, so a float4 never straddles
//      two of them).
// K4's LayerNorm pass (fused_mlp_f32.cu) is the same kernel.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/torch_kernel_ab.py at
// batch 8, medians over 5 rounds, beside the first GEMM design):
// 0.7544 ms (first design 0.8318), 33.4 TFLOP/s, where torch.mm at f32
// (cuBLAS's FFMA GEMM) takes 0.5514 ms for the GEMM alone
// (scripts/torch_ffma_tile_sweep.py).
#include "ffma.cuh"

namespace nvt {
namespace {

struct QkvEpi {
  float* q;
  float* k;
  float* v;
  int inner;

  __device__ __forceinline__ void operator()(int row, int col,
                                             float4 c) const {
    const int which = col / inner;
    float* dst = which == 0 ? q : (which == 1 ? k : v);
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(row) * inner + col -
                               which * inner) = c;
  }
};

}  // namespace
}  // namespace nvt

// x [M, dim], gamma, beta [dim], w [3 inner, dim], q, k, v [M, inner], u
// [M, dim], all f32. dim % 16 == 0, inner % 16 == 0.
extern "C" int nvt_fused_ln_qkv_f32_fwd(const void* x, const void* gamma,
                                        const void* beta, const void* w,
                                        void* q, void* k, void* v, void* u,
                                        int M, int dim, int inner, float eps,
                                        void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || inner < 16 || inner % 16 != 0 ||
      u == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* uf = static_cast<float*>(u);
  cudaError_t err = ffma::launch_ln_rows(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), uf, M, dim, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const QkvEpi epi{static_cast<float*>(q), static_cast<float*>(k),
                   static_cast<float*>(v), inner};
  return static_cast<int>(ffma::launch_gemm(
      uf, static_cast<const float*>(w), M, 3 * inner, dim, epi, s));
}
