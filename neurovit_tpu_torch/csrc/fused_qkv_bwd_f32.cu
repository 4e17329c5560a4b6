// Backward of the fused LayerNorm + QKV projection (K7) at f32,
// deterministic, on the CUDA cores.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_qkv.py:71 (_bwd_kernel,
// launched at :135) on f32 operands, where nothing is rounded. From dqkv =
// [dq | dk | dv] [M, 3 inner], x [M, dim] and Wqkv [3 inner, dim] (the
// torch weight as it lies, rows ordered (3, heads, dim_head)):
//   du = dqkv . Wqkv                        f32, [M, dim]
//   xhat = (x - mean) * rstd                x's own statistics
//   dx = rstd (du gamma - m1 - xhat m2)
//   dgamma = sum_rows(du * xhat), dbeta = sum_rows(du)
// m1 and m2 the row means of du gamma and du gamma xhat. dWqkv = dqkv^T u
// is a plain product outside (ops/fused_qkv.py, FusedLnQkv.backward).
//
// What bounds it on the H100: its 6 M inner dim flops, at f32 on the
// CUDA cores (ffma.cuh says why not yet in 3xTF32): 25.2 GFLOP for the
// flagship block at batch 8 (M = 8008, dim 1024, inner 512), 0.38 ms at
// 67 TFLOP/s, above its 115 MB (dqkv, x, Wqkv, dx, du's round trip).
//
// The design, four launches on the caller's stream, K7's bf16 plan
// (fused_qkv_bwd.cu) at f32:
//   1. row_stats: each row's (mean, rstd) into the scratch, one warp a row
//      (ffma.cu, K2 f32's LayerNorm statistics bit for bit);
//   2-4. du, ln_bwd, colsum: ffma_ln_bwd.cuh's passes, K9 f32's last
//      three, with A = dqkv, B = Wqkv as it lies, K = 3 inner, and no
//      residual.
#include "ffma_ln_bwd.cuh"

// dqkv [M, 3 inner], x [M, dim], w [3 inner, dim], gamma [dim] f32.
// Outputs: dx [M, dim]; dgamma, dbeta [dim] f32. scratch:
// nvt_fused_ln_qkv_f32_bwd_scratch_bytes(M, dim) bytes, 256-byte aligned.
// dim and inner are multiples of 16.
extern "C" int nvt_fused_ln_qkv_f32_bwd(const void* dqkv, const void* x,
                                        const void* gamma, const void* w,
                                        void* dx, void* dgamma, void* dbeta,
                                        void* scratch, int M, int dim,
                                        int inner, float eps, void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || inner < 16 || inner % 16 != 0 ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const float* xf = static_cast<const float*>(x);
  cudaError_t err = ffma::launch_row_stats(
      xf, reinterpret_cast<float2*>(base + LnScratch(M, dim).stats), M, dim,
      eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ln_bwd_f32(
      static_cast<const float*>(dqkv), static_cast<const float*>(w), xf,
      static_cast<const float*>(gamma), nullptr, static_cast<float*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), base, M, dim,
      3 * inner, s));
}

// Bytes of the scratch of one call of K7 or K9 at f32 (ops/fused_mlp.py
// ln_bwd_f32_passes): du, the row statistics and the partial sums.
extern "C" long long nvt_ln_bwd_f32_scratch_bytes(int M, int dim) {
  return static_cast<long long>(nvt::LnScratch(M, dim).bytes);
}
