// Backward of the fused LayerNorm + QKV projection, bf16 in, deterministic.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_qkv.py:71 (_bwd_kernel,
// launched at :135):
//   du = [dq | dk | dv] . Wqkv              f32 accumulation, [M, dim]
//   dx = bf16(LN backward of du at x)       f32, x's statistics recomputed
//   dgamma = sum_rows(du * xhat), dbeta = sum_rows(du)      f32
// dWqkv = u^T [dq | dk | dv] is a plain matmul outside (fused_qkv.py:175-181).
//
// What bounds it on the H100: 2 * M * 3 * inner * dim flops for du, on the
// tensor cores through nvt::TileGemm in its [K, N] mode (Wqkv [3*inner,
// dim] is the torch weight, read with no transpose). A 32-row block keeps
// [dq | dk | dv] resident in shared memory (98 KB at inner 512) and streams
// Wqkv from L2; du goes to device memory as f32, then the row kernel of
// backward.cuh takes the LayerNorm backward and the dgamma / dbeta
// partials, summed over row blocks in a fixed order. Launches: du GEMM
// (grid ceil(M/32) x ceil(dim/512)), LN rows (ceil(M/32)), two column sums.
#include "backward.cuh"

// dq, dk, dv [M, inner], x [M, dim], w [3*inner, dim] bf16; gamma [dim] f32;
// du [M, dim] f32 scratch; part_g, part_b [ceil(M/32), dim] f32 scratch;
// dx [M, dim] bf16; dgamma, dbeta [dim] f32.
// inner % 128 == 0, dim % 256 == 0, dim <= 1024.
extern "C" int nvt_fused_ln_qkv_bwd(const void* dq, const void* dk,
                                    const void* dv, const void* x,
                                    const void* gamma, const void* w,
                                    void* du, void* part_g, void* part_b,
                                    void* dx, void* dgamma, void* dbeta,
                                    int M, int dim, int inner, float eps,
                                    void* stream) {
  using namespace nvt;
  if (M < 1 || inner % 128 != 0 || !ln_dim_ok(dim))
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = 3 * inner;
  const size_t smem = du_gemm_smem(K);
  cudaError_t err = allow_smem(du_gemm_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kDuBM - 1) / kDuBM, (dim + kDuChunk - 1) / kDuChunk);
  du_gemm_kernel<<<grid, DuGemm::kThreads, smem, s>>>(
      static_cast<const bf16*>(dq), static_cast<const bf16*>(dk),
      static_cast<const bf16*>(dv), inner, static_cast<const bf16*>(w),
      static_cast<float*>(du), M, K, dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ln_bwd(
      static_cast<const bf16*>(x), static_cast<const float*>(du),
      static_cast<const float*>(gamma), nullptr, nullptr,
      static_cast<bf16*>(dx), nullptr, static_cast<float*>(part_g),
      static_cast<float*>(part_b), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), M, dim, eps, s));
}
