// The pieces the f32 kernels of the ViT block share on the CUDA cores:
// the row passes of ffma.cu, one warp a row (the LayerNorm rows K2 and K4
// at f32 run before their GEMMs, the row statistics of K7 at f32, the dz
// rows of K8 and K9 at f32), the keep factors of four elements of a
// dropout site, float4 arithmetic (add4, mul4: K4 f32's epilogues,
// fused_mlp_f32.cu), and cp.async copies (the f32 attention backward,
// flash_attention_bwd_f32.cu).
//
// Every f32 GEMM of the block runs on the tensor cores in 3xTF32 (a big
// and a small TF32 part of each operand, three TF32 products a product,
// about f32's accuracy; one TF32 product keeps 10 mantissa bits, too few
// for the JAX package's f32 path, whose Pallas kernels sum f32 products
// and whose plain products run at "highest" precision,
// neurovit_tpu/nn.py:28-32): the attention forward and backward (K1, K5
// and K6 at f32) on mma.sync (tf32x3.cuh), whose fragments the threads
// load in any layout; the other GEMMs of the forwards (K4's fc1 and fc2,
// K3's out-projection as one launch of fc2, K2's QKV product) and of the
// backwards (K8's dattn, K9's hidden GEMM, the du GEMM of K7 and K9) on
// wgmma (tf32x3_wgmma.cuh, tf32x3_ln_bwd.cuh), which takes TF32 operands
// K-major only, after a pre-pass writes each weight split (W1, W2, Wqkv
// and Wout as they lie for the forwards, turned for the backwards).
//
// Dropout: element (row, col) of an [M, N] site is kept where byte
// row * N + col of the site's Philox stream is below keep_q (nn.keep_mask,
// common.cuh philox4x32_10); the four elements of a float4 (N % 4 == 0)
// lie in one 16-byte Philox block, so one Philox call gives them all
// (keep4).
#pragma once

#include "common.cuh"

namespace nvt {
namespace ffma {

constexpr int kRowWarps = 8;                // rows (a warp each) a row block

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The keep factors (inv_keep or 0) of the four elements i .. i + 3 of a
// site (i % 4 == 0).
__device__ __forceinline__ float4 keep4(uint64_t i, uint64_t seed,
                                        uint32_t keep_q, float inv_keep) {
  const uint4 w = philox4x32_10(i >> 4, seed);
  const uint32_t j = static_cast<uint32_t>(i >> 2) & 3u;
  const uint32_t b = j == 0 ? w.x : (j == 1 ? w.y : (j == 2 ? w.z : w.w));
  return make_float4((b & 0xffu) < keep_q ? inv_keep : 0.f,
                     ((b >> 8) & 0xffu) < keep_q ? inv_keep : 0.f,
                     ((b >> 16) & 0xffu) < keep_q ? inv_keep : 0.f,
                     (b >> 24) < keep_q ? inv_keep : 0.f);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// LayerNorm of x [M, dim] into u, one row a warp (ffma.cu), on the
// caller's stream; dim % 4 == 0.
cudaError_t launch_ln_rows(const float* x, const float* gamma,
                           const float* beta, float* u, int M, int dim,
                           float eps, cudaStream_t stream);

// Each row's (mean, rstd) of x [M, dim] into stats [M], as launch_ln_rows
// computes them (K7's pass 1 at f32, so its xhat has K2 f32's statistics
// bit for bit), one row a warp (ffma.cu); dim % 4 == 0.
cudaError_t launch_row_stats(const float* x, float2* stats, int M, int dim,
                             float eps, cudaStream_t stream);

// K9's pass 1 at f32, and K8's without the LayerNorm (ffma.cu), one row a
// warp: dz = dy * mask / keep for dy, dz [M, dim] (dz null: not written),
// the mask nn.keep_mask's bits at row * dim + col under seed (keep4); with
// x non-null also u = LN(x) * gamma + beta and (mean, rstd) into stats
// [M], as launch_ln_rows computes them (so u is K4 f32's bit for bit).
// dim % 4 == 0.
cudaError_t launch_dz_rows(const float* dy, const float* x,
                           const float* gamma, const float* beta, float* dz,
                           float* u, float2* stats, int M, int dim,
                           float eps, float inv_keep, uint32_t keep_q,
                           uint64_t seed, cudaStream_t stream);

}  // namespace ffma
}  // namespace nvt
