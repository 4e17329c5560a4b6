// LayerNorm + per-row int8 quantization + int8 QKV projection (K10).
//
// Replaces the TPU kernel neurovit_tpu/ops/int8_serving.py:154
// (_qkv_kernel, launched at :209 by int8_ln_qkv):
//   u = LN(x) * gamma + beta                 f32, NOT rounded to bf16
//   (u8, s_row) = rowquant(u)                per-row symmetric int8
//   [q | k | v] = bf16(float(u8 . W8^T) * s_row * s_col)
// W8 is the torch-layout int8 weight [3*inner, dim] (rows ordered (3,
// heads, dim_head)) with per-output-channel scales s_col [3*inner], so q,
// k and v each come out [M, inner] and view as [B, N, H, D].
//
// What bounds it on the H100: 2*M*dim*3*inner int8 operations against
// about 2*M*dim + 6*M*inner bytes of activations and 1.5 MB of weights --
// compute-bound, on the int8 tensor cores. The TPU kernel holds W8 in VMEM;
// here it streams from L2 in 128 x 64 tiles through nvt::TileGemmI8's
// two-stage ring, shared by all row blocks. The bf16 kernel K2 cannot be
// reused as it is: it stages u as bf16 (fused_qkv.cu), and the per-row
// scale needs the amax of the f32 u before any code is written. With one
// warp per row and dim <= 1024 the f32 row fits in a lane's registers
// (32 floats), so LN, amax, scale and the int8 codes are all made there
// and only the codes (64 x dim bytes) reach shared memory.
// Grid: (ceil(M/64), 3), blockIdx.y picks q, k or v, as K2's does; each
// block loops over that output's 128-column tiles. Widths are multiples of
// 16 (dim <= 1024): u's codes past dim are 0 up to the k tile, and the last
// column tile is masked.
#include "int8.cuh"

namespace nvt {
namespace {

constexpr int kBM = 64, kBN = 128, kBK = 64;
using Gemm = TileGemmI8<kBM, kBN, kBK, 2, 4>;

__global__ void __launch_bounds__(Gemm::kThreads)
    int8_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const int8_t* __restrict__ w8,
                    const float* __restrict__ s_col, bf16* __restrict__ q,
                    bf16* __restrict__ k, bf16* __restrict__ v, int M, int dim,
                    int inner, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dim_k = static_cast<int>(round_up(dim, kBK));
  const size_t a_bytes = round_up(static_cast<size_t>(kBM) * dim_k, 128);
  int8_t* A8 = reinterpret_cast<int8_t*>(smem);
  float* s_row = reinterpret_cast<float*>(smem + a_bytes);
  void* scratch = smem + a_bytes + round_up(kBM * sizeof(float), 128);

  const int row0 = blockIdx.x * kBM;
  rowquant_rows<kBM, Gemm::kThreads, true>(x, gamma, beta, A8, s_row, row0,
                                           M, dim, dim_k, eps);
  const int which = blockIdx.y;
  bf16* out = which == 0 ? q : (which == 1 ? k : v);
  const int* C = reinterpret_cast<const int*>(scratch);
  for (int c0 = 0; c0 < inner; c0 += kBN) {
    const int n0 = which * inner + c0;
    Gemm::run(A8, w8, dim, n0, dim, scratch, (which + 1) * inner);
    for (int e = threadIdx.x; e < kBM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = row0 + r;
      if (row >= M || c0 + c >= inner) continue;
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = dequant(C[r * Gemm::LDC + c + i], s_row[r], s_col[n0 + c + i]);
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * inner + c0 +
                                c) = pack8(f);
    }
  }
}

size_t smem_bytes(int dim) {
  return round_up(static_cast<size_t>(kBM) * round_up(dim, kBK), 128) +
         round_up(kBM * sizeof(float), 128) + Gemm::kScratchBytes;
}

}  // namespace
}  // namespace nvt

// x [M, dim] bf16; gamma, beta [dim] f32; w8 [3*inner, dim] int8; s_col
// [3*inner] f32; q, k, v [M, inner] bf16. dim % 16 == 0, dim <= 1024,
// inner % 16 == 0.
extern "C" int nvt_int8_ln_qkv(const void* x, const void* gamma,
                               const void* beta, const void* w8,
                               const void* s_col, void* q, void* k, void* v,
                               int M, int dim, int inner, float eps,
                               void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || dim > 1024 || inner < 16 ||
      inner % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(dim);
  cudaError_t err = allow_smem(int8_qkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, 3);
  int8_qkv_kernel<<<grid, Gemm::kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const int8_t*>(w8),
      static_cast<const float*>(s_col), static_cast<bf16*>(q),
      static_cast<bf16*>(k), static_cast<bf16*>(v), M, dim, inner, eps);
  return static_cast<int>(cudaGetLastError());
}
