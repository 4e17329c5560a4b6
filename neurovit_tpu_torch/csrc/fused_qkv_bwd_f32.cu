// Backward of the fused LayerNorm + QKV projection (K7) at f32,
// deterministic, on the tensor cores by 3xTF32 on wgmma.
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
// What bounds it on the H100: its 6 M inner dim flops, 25.2 GFLOP for the
// flagship block at batch 8 (M = 8008, dim 1024, inner 512). In 3xTF32
// (tf32x3_wgmma.cuh) at 165 TFLOP/s of f32 products that is 0.153 ms; the
// CUDA cores' FFMA (67 TFLOP/s, this kernel's first design) 0.38 ms. Its
// bytes (dqkv, x, Wqkv in, dx out) are 0.12 GB, 0.036 ms at 3.35 TB/s.
//
// The design, five launches on the caller's stream, K7's bf16 plan
// (fused_qkv_bwd.cu) at f32 (ops/fused_qkv.py qkv_bwd_f32_plan):
//   1. the weight pre-pass (nvt_wsplit_f32, its own wrapper): du contracts
//      Wqkv's out dimension, so Wqkv is MN-major as it lies, and
//      split_t_kernel writes Wqkv^T [dim, 3 inner] split into big and
//      small, K-major for wgmma;
//   2. row_stats: each row's (mean, rstd) into the scratch, one warp a row
//      (ffma.cu, K2 f32's LayerNorm statistics bit for bit);
//   3-5. du, ln_bwd, colsum: tf32x3_ln_bwd.cuh's passes, K9 f32's last
//      three, with A = dqkv, K = 3 inner, and no residual.
#include "ffma.cuh"
#include "tf32x3_ln_bwd.cuh"

// dqkv [M, 3 inner], x [M, dim], gamma [dim], wt_big, wt_small [dim, 3
// inner] (Wqkv's split transpose, nvt_wsplit_f32), all f32 and 16-byte
// aligned. Outputs: dx [M, dim]; dgamma, dbeta [dim] f32. scratch:
// nvt_ln_bwd_f32_scratch_bytes(M, dim) bytes, 256-byte aligned. dim and
// inner are multiples of 16.
extern "C" int nvt_fused_ln_qkv_f32_bwd(const void* dqkv, const void* x,
                                        const void* gamma, const void* wt_big,
                                        const void* wt_small, void* dx,
                                        void* dgamma, void* dbeta,
                                        void* scratch, int M, int dim,
                                        int inner, float eps, void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || inner < 16 || inner % 16 != 0 ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const float* xf = static_cast<const float*>(x);
  CUtensorMap ta, tbig, tsmall;
  cudaError_t err = prepare_ln_du(
      &ta, &tbig, &tsmall, static_cast<const float*>(dqkv),
      static_cast<const float*>(wt_big), static_cast<const float*>(wt_small),
      M, dim, 3 * inner);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ffma::launch_row_stats(
      xf, reinterpret_cast<float2*>(base + LnScratch(M, dim).stats), M, dim,
      eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ln_bwd_f32(
      ta, tbig, tsmall, xf, static_cast<const float*>(gamma), nullptr,
      static_cast<float*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), base, M, dim, 3 * inner, s));
}

// Bytes of the scratch of one call of K7 or K9 at f32 (ops/fused_mlp.py
// ln_bwd_f32_passes): du, the row statistics and the partial sums.
extern "C" long long nvt_ln_bwd_f32_scratch_bytes(int M, int dim) {
  return static_cast<long long>(nvt::LnScratch(M, dim).bytes);
}

// Dynamic shared memory of a block of the du GEMM
// (ops/fused_qkv.py qkv_bwd_f32_plan).
extern "C" long long nvt_fused_ln_qkv_f32_bwd_smem_bytes() {
  return static_cast<long long>(nvt::BwdLoop::kSmemBytes);
}
