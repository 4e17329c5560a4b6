// Fused LayerNorm + bias-free QKV projection, bf16.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_qkv.py:57 (_fwd_kernel,
// launched at :108 by fused_ln_qkv):
//   u = bf16(LN(x) * gamma + beta)          f32 statistics, one rounding
//   [q | k | v] = u . Wqkv^T                 f32 accumulation, bf16 out
// Wqkv is the torch weight [3*inner, dim] whose rows are ordered
// (3, heads, dim_head), so each of q, k, v comes out [M, inner] and views
// as [B, N, H, D] for the attention kernel with no copy.
//
// What bounds it on the H100: 2*M*dim*3*inner flops against about
// 2*(M*dim + 3*M*inner) bytes of activations -- compute-bound at the
// serving shapes (M = B*1001, dim 1024, inner 512). The TPU kernel keeps
// Wqkv resident in VMEM (fused_qkv.py:14); 3 MB does not fit one block's
// shared memory, so here Wqkv streams from L2 in 128 x 32 tiles through a
// two-stage cp.async ring (nvt::TileGemm), shared by all row blocks. Each
// block computes the LN statistics of its 64 rows in f32 once and stages u
// as bf16 in shared memory: the rounding point fused_qkv.py:62-63 fixes.
// Grid: (ceil(M/64), 3), blockIdx.y picks q, k or v; each block loops over
// that output's 128-column tiles. Widths are multiples of 16: u's columns
// past dim are zeroed up to the k tile, Wqkv rows past the output's own
// inner rows are zero-filled, and the last column tile is masked. In training the blocks of blockIdx.y == 0
// also copy u to u_out [M, dim] (fused_qkv.py:57-68): the operand of the
// dWqkv product. Serving passes null and pays nothing for it.
#include "common.cuh"

namespace nvt {
namespace {

constexpr int kBM = 64, kBN = 128, kBK = 32;
using Gemm = TileGemm<kBM, kBN, kBK, 2, 4>;

__global__ void __launch_bounds__(Gemm::kThreads)
    ln_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const bf16* __restrict__ w,
                  bf16* __restrict__ q, bf16* __restrict__ k,
                  bf16* __restrict__ v, bf16* __restrict__ u_out, int M,
                  int dim, int inner, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dim_k = static_cast<int>(round_up(dim, kBK));
  const int ldu = dim_k + kPad;
  bf16* U = reinterpret_cast<bf16*>(smem);
  void* scratch = smem + round_up(static_cast<size_t>(kBM) * ldu * sizeof(bf16), 128);

  const int row0 = blockIdx.x * kBM;
  layer_norm_rows<kBM, Gemm::kThreads>(x, gamma, beta, U, ldu, row0, M, dim,
                                       eps);
  zero_cols<Gemm::kThreads>(U, ldu, kBM, dim, dim_k);
  const int which = blockIdx.y;
  if (u_out != nullptr && which == 0) {
    __syncthreads();
    for (int c = threadIdx.x; c < kBM * (dim / 8); c += Gemm::kThreads) {
      const int r = c / (dim / 8), col = (c % (dim / 8)) * 8;
      if (row0 + r < M)
        *reinterpret_cast<uint4*>(u_out + static_cast<size_t>(row0 + r) * dim +
                                  col) =
            *reinterpret_cast<const uint4*>(U + r * ldu + col);
    }
  }
  bf16* out = which == 0 ? q : (which == 1 ? k : v);
  const float* C = reinterpret_cast<const float*>(scratch);
  for (int c0 = 0; c0 < inner; c0 += kBN) {
    Gemm::run(U, ldu, w, dim, which * inner + c0, dim, scratch,
              (which + 1) * inner);
    for (int e = threadIdx.x; e < kBM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = row0 + r;
      if (row >= M || c0 + c >= inner) continue;
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * inner + c0 +
                                c) = pack8(C + r * Gemm::LDC + c);
    }
  }
}

size_t smem_bytes(int dim) {
  return round_up(static_cast<size_t>(kBM) * (round_up(dim, kBK) + kPad) *
                      sizeof(bf16),
                  128) +
         Gemm::kScratchBytes;
}

}  // namespace
}  // namespace nvt

// x [M, dim] bf16; gamma, beta [dim] f32; w [3*inner, dim] bf16;
// q, k, v [M, inner] bf16; u [M, dim] bf16 or null.
// dim % 16 == 0, inner % 16 == 0.
extern "C" int nvt_fused_ln_qkv_fwd(const void* x, const void* gamma,
                                    const void* beta, const void* w, void* q,
                                    void* k, void* v, void* u, int M, int dim,
                                    int inner, float eps, void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || inner < 16 || inner % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(dim);
  cudaError_t err = allow_smem(ln_qkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, 3);
  ln_qkv_kernel<<<grid, Gemm::kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w),
      static_cast<bf16*>(q), static_cast<bf16*>(k), static_cast<bf16*>(v),
      static_cast<bf16*>(u), M, dim, inner, eps);
  return static_cast<int>(cudaGetLastError());
}
