// Backward of the fused out-projection + dropout + residual, bf16.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_outproj.py:56 (_bwd_kernel,
// launched at :102):
//   dz    = bf16(dy * mask / keep)          the forward's mask, regenerated
//   dattn = bf16(dz . Wout)                 f32 accumulation, [M, inner]
// dx = dy, dWout = dz^T attn and db = sum(dz) stay outside
// (fused_outproj.py:131-141).
//
// What bounds it on the H100: 2 * M * dim * inner flops against reading dy
// and writing dz and dattn once: compute-bound at the training shapes. A
// 64-row block turns its dy rows into dz in shared memory (the GEMM's A
// operand, also stored for the dW product outside) and streams Wout [dim,
// inner] -- the torch weight, in nvt::TileGemm's [K, N] mode -- from L2.
// Grid: (ceil(M/64), ceil(inner/512)); each block loops over 128-column
// tiles of its chunk.
#include "backward.cuh"

namespace nvt {
namespace {

constexpr int kBM = 64, kBN = 128, kBK = 32, kChunk = 512;
using Gemm = TileGemm<kBM, kBN, kBK, 2, 4, true>;

__global__ void __launch_bounds__(Gemm::kThreads)
    outproj_bwd_kernel(const bf16* __restrict__ dy,
                       const bf16* __restrict__ w, bf16* __restrict__ dattn,
                       bf16* __restrict__ dz, int M, int inner, int dim,
                       float inv_keep, uint32_t keep_q, uint64_t seed) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = dim + kPad;
  bf16* A = reinterpret_cast<bf16*>(smem);
  void* scratch =
      smem + round_up(static_cast<size_t>(kBM) * lda * sizeof(bf16), 128);
  const int row0 = blockIdx.x * kBM;
  dropout_rows<kBM, Gemm::kThreads>(dy, A, lda,
                                    blockIdx.y == 0 ? dz : nullptr, row0, M,
                                    dim, inv_keep, keep_q, seed);

  const float* C = reinterpret_cast<const float*>(scratch);
  const int n_begin = blockIdx.y * kChunk;
  const int n_end = min(n_begin + kChunk, inner);
  for (int n0 = n_begin; n0 < n_end; n0 += kBN) {
    Gemm::run(A, lda, w, inner, n0, dim, scratch);
    for (int e = threadIdx.x; e < kBM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = row0 + r;
      if (row >= M) continue;
      *reinterpret_cast<uint4*>(dattn + static_cast<size_t>(row) * inner +
                                n0 + c) = pack8(C + r * Gemm::LDC + c);
    }
  }
}

size_t smem_bytes(int dim) {
  return round_up(static_cast<size_t>(kBM) * (dim + kPad) * sizeof(bf16),
                  128) +
         Gemm::kScratchBytes;
}

}  // namespace
}  // namespace nvt

// dy [M, dim], w [dim, inner] bf16; dattn [M, inner], dz [M, dim] bf16.
// dim % 32 == 0, inner % 128 == 0. keep_q 0 = no dropout.
extern "C" int nvt_fused_outproj_bwd(const void* dy, const void* w,
                                     void* dattn, void* dz, int M, int inner,
                                     int dim, float inv_keep, int keep_q,
                                     uint64_t seed, void* stream) {
  using namespace nvt;
  if (M < 1 || dim % kBK != 0 || inner % kBN != 0 || keep_q < 0 ||
      keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(dim);
  cudaError_t err = allow_smem(outproj_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, (inner + kChunk - 1) / kChunk);
  outproj_bwd_kernel<<<grid, Gemm::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
      static_cast<bf16*>(dattn), static_cast<bf16*>(dz), M, inner, dim,
      inv_keep, static_cast<uint32_t>(keep_q), seed);
  return static_cast<int>(cudaGetLastError());
}
