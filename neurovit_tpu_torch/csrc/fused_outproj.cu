// Fused attention out-projection + bias + residual, bf16, deterministic.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_outproj.py:44 (_fwd_kernel,
// launched at :79 by fused_outproj_residual):
//   z = a . Wout^T + b                   f32
//   z = z * (mask * (1 / keep))          training only (fused_outproj.py:50-52)
//   y = bf16(x + z)                      x added in f32, one rounding
// The mask of element (row, col) is nvt::DropoutBits at row * dim + col.
// a [M, inner] is the attention output viewed as rows (no head transpose),
// Wout the torch weight [dim, inner].
//
// What bounds it on the H100: 2*M*inner*dim flops against about
// 2*(M*inner + 2*M*dim) bytes: compute-bound at the serving shapes, with
// the residual read riding the epilogue so x makes no separate round trip
// (the point of the TPU kernel). The 64-row block of a is copied into
// shared memory once with cp.async; Wout (1 MB, resident in VMEM on the
// TPU) streams from L2 through nvt::TileGemm's two-stage ring. Grid:
// (ceil(M/64), dim/512); each block loops over its 512 output columns in
// 128-column tiles.
#include "common.cuh"

namespace nvt {
namespace {

constexpr int kBM = 64, kBN = 128, kBK = 32, kChunk = 512;
using Gemm = TileGemm<kBM, kBN, kBK, 2, 4>;

__global__ void __launch_bounds__(Gemm::kThreads)
    outproj_kernel(const bf16* __restrict__ a, const bf16* __restrict__ x,
                   const bf16* __restrict__ w, const float* __restrict__ bias,
                   bf16* __restrict__ y, int M, int inner, int dim,
                   float inv_keep, uint32_t keep_q, uint64_t seed) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = inner + kPad;
  bf16* A = reinterpret_cast<bf16*>(smem);
  void* scratch = smem + round_up(static_cast<size_t>(kBM) * lda * sizeof(bf16), 128);

  const int row0 = blockIdx.x * kBM;
  for (int c = threadIdx.x; c < kBM * (inner / 8); c += Gemm::kThreads) {
    const int r = c / (inner / 8), col = (c % (inner / 8)) * 8;
    const int row = row0 + r;
    const int safe = row < M ? row : M - 1;
    cp_async16(A + r * lda + col, a + static_cast<size_t>(safe) * inner + col,
               row < M ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();

  const float* C = reinterpret_cast<const float*>(scratch);
  const int n_begin = blockIdx.y * kChunk;
  DropoutBits bits(seed);
  for (int n0 = n_begin; n0 < n_begin + kChunk; n0 += kBN) {
    Gemm::run(A, lda, w, inner, n0, inner, scratch);
    for (int e = threadIdx.x; e < kBM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = row0 + r;
      if (row >= M) continue;
      const size_t off = static_cast<size_t>(row) * dim + n0 + c;
      float xf[8], out[8];
      unpack8(*reinterpret_cast<const uint4*>(x + off), xf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float z = C[r * Gemm::LDC + c + i] + bias[n0 + c + i];
        if (keep_q) z *= bits.keep(off + i, keep_q) ? inv_keep : 0.f;
        out[i] = z + xf[i];
      }
      *reinterpret_cast<uint4*>(y + off) = pack8(out);
    }
  }
}

size_t smem_bytes(int inner) {
  return round_up(static_cast<size_t>(kBM) * (inner + kPad) * sizeof(bf16), 128) +
         Gemm::kScratchBytes;
}

}  // namespace
}  // namespace nvt

// a [M, inner], x [M, dim], w [dim, inner] bf16; bias [dim] f32;
// y [M, dim] bf16. inner % 32 == 0, dim % 512 == 0. keep_q: dropout
// threshold (0 = none), inv_keep = 1 / keep.
extern "C" int nvt_fused_outproj_fwd(const void* a, const void* x,
                                     const void* w, const void* bias, void* y,
                                     int M, int inner, int dim, float inv_keep,
                                     int keep_q, uint64_t seed, void* stream) {
  using namespace nvt;
  if (M < 1 || inner % kBK != 0 || dim % kChunk != 0 || keep_q < 0 ||
      keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(inner);
  cudaError_t err = allow_smem(outproj_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, dim / kChunk);
  outproj_kernel<<<grid, Gemm::kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(x),
      static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(y), M, inner, dim, inv_keep,
      static_cast<uint32_t>(keep_q), seed);
  return static_cast<int>(cudaGetLastError());
}
