// Fused LayerNorm + bias-free QKV projection (K2) at f32, deterministic, on
// the tensor cores by 3xTF32 on wgmma.
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
// What bounds it on the H100: its 6 M dim inner flops, 25.2 GFLOP for the
// flagship block at batch 8 (M = 8008, dim 1024, inner 512): 0.153 ms in
// 3xTF32 at 165 TFLOP/s of f32 products (tf32x3_wgmma.cuh), above its 93
// MB of x, u, Wqkv, q, k and v.
//
// The design, three launches on the caller's stream:
//   1. the weight pre-pass (nvt_split_f32 of fused_mlp_f32.cu, its own
//      wrapper): Wqkv's big and small [3 inner, dim] as it lies, K-major
//      for this product;
//   2. ln_rows: x -> u [M, dim] f32, one warp a row (ffma.cu), the row
//      read again from L1/L2 for each statistic, so any dim is taken;
//   3. qkv_gemm: tf32x3_wgmma.cuh's Loop over (ceil(3 inner / 128), ceil(M
//      / 128)) tiles, K = dim, A = u, four 48 KiB stages and a fresh
//      accumulator every stage, as K4 f32's GEMMs; the epilogue writes
//      each for_each_quad group into q, k or v. inner % 16 == 0 and a
//      group is 16-column aligned, so a group never straddles two of them;
//      a 128-column tile does where 128 does not divide inner (the 2D
//      tutorial's 64).
// K4's LayerNorm pass (fused_mlp_f32.cu) is the same kernel.
#include "ffma.cuh"
#include "tf32x3_wgmma.cuh"

namespace nvt {
namespace {

using namespace tf32x3_wgmma;

constexpr int kStages = 4;
constexpr int kFreshStages = 1;
using QkvLoop = Loop<kStages, kFreshStages>;

struct QkvEpi {
  float* q;
  float* k;
  float* v;
  int inner;

  __device__ __forceinline__ void operator()(int row, int col,
                                             float4 c) const {
    const int which = col / inner;
    float* dst = which == 0 ? q : (which == 1 ? k : v);
    store_quad(dst, static_cast<size_t>(row) * inner + col - which * inner,
               c);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    qkv_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tbig,
                    const __grid_constant__ CUtensorMap tsmall, int M,
                    int dim, QkvEpi epi) {
  extern __shared__ unsigned char smem[];
  gemm_tile<QkvLoop>(&ta, &tbig, &tsmall, M, 3 * epi.inner, dim, smem, epi);
}

}  // namespace
}  // namespace nvt

// x [M, dim], gamma, beta [dim], w_big, w_small [3 inner, dim] (Wqkv split
// by nvt_split_f32), q, k, v [M, inner], u [M, dim], all f32 and 16-byte
// aligned. dim % 16 == 0, inner % 16 == 0.
extern "C" int nvt_fused_ln_qkv_f32_fwd(const void* x, const void* gamma,
                                        const void* beta, const void* w_big,
                                        const void* w_small, void* q, void* k,
                                        void* v, void* u, int M, int dim,
                                        int inner, float eps, void* stream) {
  using namespace nvt;
  using namespace nvt::tf32x3_wgmma;
  if (M < 1 || dim < 16 || dim % 16 != 0 || inner < 16 || inner % 16 != 0 ||
      u == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* uf = static_cast<float*>(u);
  // Every map is encoded, and the kernel allowed its shared memory, before
  // the first launch: a failure leaves nothing half done.
  CUtensorMap tu, tbig, tsmall;
  cudaError_t err = encode_kmajor_f32(&tu, uf, M, dim, kBM);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&tbig, static_cast<const float*>(w_big),
                            3 * inner, dim, kBN);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&tsmall, static_cast<const float*>(w_small),
                            3 * inner, dim, kBN);
  if (err == cudaSuccess)
    err = allow_smem(qkv_gemm_kernel, QkvLoop::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ffma::launch_ln_rows(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), uf, M, dim, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const QkvEpi epi{static_cast<float*>(q), static_cast<float*>(k),
                   static_cast<float*>(v), inner};
  qkv_gemm_kernel<<<dim3((3 * inner + kBN - 1) / kBN, (M + kBM - 1) / kBM),
                    kThreads, QkvLoop::kSmemBytes, s>>>(tu, tbig, tsmall, M,
                                                        dim, epi);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a block of qkv_gemm (ops/fused_qkv.py
// qkv_f32_plan).
extern "C" long long nvt_fused_ln_qkv_f32_smem_bytes() {
  return static_cast<long long>(nvt::QkvLoop::kSmemBytes);
}
