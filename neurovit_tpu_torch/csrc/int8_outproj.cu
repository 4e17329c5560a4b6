// Per-row int8 quantization + int8 out-projection + bias + residual (K11).
//
// Replaces the TPU kernel neurovit_tpu/ops/int8_serving.py:167
// (_outproj_kernel, launched at :236 by int8_outproj_residual):
//   (a8, s_row) = rowquant(float(a))         per-row symmetric int8
//   z = float(a8 . W8^T) * s_row * s_col + b  f32
//   y = bf16(z + x)                          x added in f32, one rounding
// a [M, inner] is the attention output viewed as rows (no head transpose),
// W8 the torch-layout int8 weight [dim, inner] with scales s_col [dim].
//
// What bounds it on the H100: 2*M*inner*dim int8 operations against about
// 2*(M*inner + 2*M*dim) bytes -- the smallest GEMM of the block, close to
// the line between compute and memory; the residual read rides the
// epilogue, as in the bf16 K3. Each block quantizes its 64 rows of a, one
// warp per row with the row in registers (inner <= 1024), into shared
// memory, then W8 (0.5 MB) streams from L2 through nvt::TileGemmI8's ring.
// Grid: (ceil(M/64), dim/512), K3's; each block loops over its 512 output
// columns in 128-column tiles.
#include "int8.cuh"

namespace nvt {
namespace {

constexpr int kBM = 64, kBN = 128, kBK = 64, kChunk = 512;
using Gemm = TileGemmI8<kBM, kBN, kBK, 2, 4>;

__global__ void __launch_bounds__(Gemm::kThreads)
    int8_outproj_kernel(const bf16* __restrict__ a, const bf16* __restrict__ x,
                        const int8_t* __restrict__ w8,
                        const float* __restrict__ s_col,
                        const float* __restrict__ bias, bf16* __restrict__ y,
                        int M, int inner, int dim) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t a_bytes = round_up(static_cast<size_t>(kBM) * inner, 128);
  int8_t* A8 = reinterpret_cast<int8_t*>(smem);
  float* s_row = reinterpret_cast<float*>(smem + a_bytes);
  void* scratch = smem + a_bytes + round_up(kBM * sizeof(float), 128);

  const int row0 = blockIdx.x * kBM;
  rowquant_rows<kBM, Gemm::kThreads, false>(a, nullptr, nullptr, A8, s_row,
                                            row0, M, inner, 0.f);
  const int* C = reinterpret_cast<const int*>(scratch);
  const int n_begin = blockIdx.y * kChunk;
  for (int n0 = n_begin; n0 < n_begin + kChunk; n0 += kBN) {
    Gemm::run(A8, w8, inner, n0, inner, scratch);
    for (int e = threadIdx.x; e < kBM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = row0 + r;
      if (row >= M) continue;
      const size_t off = static_cast<size_t>(row) * dim + n0 + c;
      float xf[8], out[8];
      unpack8(*reinterpret_cast<const uint4*>(x + off), xf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float z = __fadd_rn(
            dequant(C[r * Gemm::LDC + c + i], s_row[r], s_col[n0 + c + i]),
            bias[n0 + c + i]);
        out[i] = __fadd_rn(z, xf[i]);
      }
      *reinterpret_cast<uint4*>(y + off) = pack8(out);
    }
  }
}

size_t smem_bytes(int inner) {
  return round_up(static_cast<size_t>(kBM) * inner, 128) +
         round_up(kBM * sizeof(float), 128) + Gemm::kScratchBytes;
}

}  // namespace
}  // namespace nvt

// a [M, inner], x [M, dim] bf16; w8 [dim, inner] int8; s_col, bias [dim]
// f32; y [M, dim] bf16. inner % 256 == 0, inner <= 1024, dim % 512 == 0.
extern "C" int nvt_int8_outproj(const void* a, const void* x, const void* w8,
                                const void* s_col, const void* bias, void* y,
                                int M, int inner, int dim, void* stream) {
  using namespace nvt;
  if (M < 1 || inner % 256 != 0 || inner > 1024 || dim % kChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(inner);
  cudaError_t err = allow_smem(int8_outproj_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, dim / kChunk);
  int8_outproj_kernel<<<grid, Gemm::kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(x),
      static_cast<const int8_t*>(w8), static_cast<const float*>(s_col),
      static_cast<const float*>(bias), static_cast<bf16*>(y), M, inner, dim);
  return static_cast<int>(cudaGetLastError());
}
