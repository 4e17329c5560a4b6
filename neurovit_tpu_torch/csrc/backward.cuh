// Device code of the backward of the out-projection (K8,
// fused_outproj_bwd.cu), the last backward kernel on wmma:
//
// - dropout_rows: the backward's dz = bf16(dy * mask / keep) for a row
//   block, staged in shared memory as a GEMM A operand (and stored).
//
// K7 (fused_qkv_bwd.cu) and K9 (fused_mlp_bwd.cu) run on TMA + wgmma and
// share their LayerNorm backward passes through ln_bwd.cuh; they use none
// of this.
#pragma once

#include "common.cuh"

namespace nvt {
namespace {

template <int BM, int THREADS>
__device__ void dropout_rows(const bf16* __restrict__ dy, bf16* A, int lda,
                             bf16* __restrict__ dz_out, int row0, int M,
                             int dim, float inv_keep, uint32_t keep_q,
                             uint64_t seed) {
  DropoutBits bits(seed);
  for (int c = threadIdx.x; c < BM * (dim / 8); c += THREADS) {
    const int r = c / (dim / 8), col = (c % (dim / 8)) * 8;
    const int row = row0 + r;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (row < M) {
      const size_t off = static_cast<size_t>(row) * dim + col;
      packed = *reinterpret_cast<const uint4*>(dy + off);
      if (keep_q) {
        float f[8];
        unpack8(packed, f);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          f[i] *= bits.keep(off + i, keep_q) ? inv_keep : 0.f;
        packed = pack8(f);
      }
      if (dz_out != nullptr) *reinterpret_cast<uint4*>(dz_out + off) = packed;
    }
    *reinterpret_cast<uint4*>(A + r * lda + col) = packed;
  }
}

}  // namespace
}  // namespace nvt
