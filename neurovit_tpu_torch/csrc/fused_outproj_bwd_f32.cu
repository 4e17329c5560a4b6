// Backward of the attention out-projection (K8) at f32, deterministic, on
// the tensor cores by 3xTF32 on wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_outproj.py:56 (_bwd_kernel,
// launched at :102) on f32 operands, where nothing is rounded:
//   dz = dy * mask / keep                training, dropout > 0
//   da = dz . Wout                       f32, [M, inner]
// The mask of element (row, col) is nn.keep_mask's bit at row * dim + col
// under seed, the forward's (fused_outproj_f32.cu). dx = dy, dWout = dz^T a
// and db = sum_rows(dz) stay outside (ops/fused_outproj.py, FusedOutproj).
//
// What bounds it on the H100: its 2 M dim inner flops, 8.4 GFLOP for the
// flagship block at batch 8 (M = 8008, dim 1024, inner 512), above its 50
// MB of dy, dz, Wout and da. In 3xTF32 (tf32x3_wgmma.cuh: three TF32
// products a product, about f32's accuracy) at the data sheet's 495 TF32
// TFLOP/s that is 165 TFLOP/s of f32 products, 0.051 ms; the CUDA cores'
// FFMA (67 TFLOP/s, this kernel's first design) 0.125 ms.
//
// The design, in three launches on the caller's stream:
//   1. the weight pre-pass (nvt_wsplit_f32, its own wrapper): Wout [dim,
//      inner] into Wt_big and Wt_small [inner, dim], its transpose split
//      (tf32x3_wgmma.cuh split_t_kernel), K-major for this product;
//   2. at dropout > 0, dz_rows (ffma.cu launch_dz_rows without the
//      LayerNorm, K9 f32's pass 1) into the caller's dz;
//   3. dattn: tf32x3_wgmma.cuh's Loop over (ceil(inner / 128), ceil(M /
//      128)) tiles, K = dim, A = dz (dy itself at dropout 0, where the
//      wrapper returns dy as dz), B = Wt_big and Wt_small; the epilogue
//      stores each thread's accumulator pairs as float2s, rows past M and
//      columns past inner skipped. A block takes 193 KiB of shared memory
//      (four stages of 48 KiB), one block an SM: the flagship's 4 x 63 =
//      252 tiles run in 1.9 waves on 132 SMs.
// Widths: dim and inner any multiples of 16, any M (TMA zero-fills the
// ragged boxes).
#include "ffma.cuh"
#include "tf32x3_wgmma.cuh"

namespace nvt {
namespace {

using namespace tf32x3_wgmma;

constexpr int kStages = 4;
constexpr int kFreshStages = 1;
using DattnLoop = Loop<kStages, kFreshStages>;

__global__ void __launch_bounds__(kThreads, 1)
    dattn_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tbig,
                 const __grid_constant__ CUtensorMap tsmall, float* da,
                 int M, int inner, int dim) {
  extern __shared__ unsigned char smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[kAccRegs];
  if (!DattnLoop::run(&ta, &tbig, &tsmall, m0, n0, dim, smem, acc)) return;
  DattnLoop::for_each_pair(acc, [&](int row, int col, float v0, float v1) {
    row += m0;
    col += n0;
    if (row < M && col < inner)
      *reinterpret_cast<float2*>(da + static_cast<size_t>(row) * inner +
                                 col) = make_float2(v0, v1);
  });
}

}  // namespace
}  // namespace nvt

// The weight pre-pass: w [rows, cols] f32 into big and small [cols, rows]
// f32 (w^T split, big + small == w^T exactly). All 16-byte aligned.
extern "C" int nvt_wsplit_f32(const void* w, void* big, void* small,
                              int rows, int cols, void* stream) {
  if (rows < 1 || cols < 1 || big == nullptr || small == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(nvt::tf32x3_wgmma::launch_split_t(
      static_cast<const float*>(w), static_cast<float*>(big),
      static_cast<float*>(small), rows, cols,
      static_cast<cudaStream_t>(stream)));
}

// dy [M, dim], wt_big and wt_small [inner, dim] (Wout's split transpose,
// nvt_wsplit_f32), da [M, inner], dz [M, dim] (null at dropout 0), all
// f32 and 16-byte aligned. dim % 16 == 0, inner % 16 == 0. keep_q: dropout
// threshold (0 = none), inv_keep = 1 / keep.
extern "C" int nvt_fused_outproj_f32_bwd(const void* dy, const void* wt_big,
                                         const void* wt_small, void* da,
                                         void* dz, int M, int inner, int dim,
                                         float inv_keep, int keep_q,
                                         uint64_t seed, void* stream) {
  using namespace nvt;
  using namespace nvt::tf32x3_wgmma;
  if (M < 1 || inner < 16 || inner % 16 != 0 || dim < 16 || dim % 16 != 0 ||
      keep_q < 0 || keep_q > 255 || (keep_q > 0) != (dz != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(keep_q ? dz : dy);
  // Every map is encoded, and the kernel allowed its shared memory, before
  // the first launch: a failure leaves nothing half done.
  CUtensorMap ta, tbig, tsmall;
  cudaError_t err = encode_kmajor_f32(&ta, a, M, dim, kBM);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&tbig, static_cast<const float*>(wt_big), inner,
                            dim, kBN);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&tsmall, static_cast<const float*>(wt_small),
                            inner, dim, kBN);
  if (err == cudaSuccess)
    err = allow_smem(dattn_kernel, DattnLoop::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (keep_q) {
    err = ffma::launch_dz_rows(static_cast<const float*>(dy), nullptr,
                               nullptr, nullptr, static_cast<float*>(dz),
                               nullptr, nullptr, M, dim, 0.f, inv_keep,
                               static_cast<uint32_t>(keep_q), seed, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dattn_kernel<<<dim3((inner + kBN - 1) / kBN, (M + kBM - 1) / kBM), kThreads,
                 DattnLoop::kSmemBytes, s>>>(ta, tbig, tsmall,
                                             static_cast<float*>(da), M,
                                             inner, dim);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a block of the dattn launch
// (ops/fused_outproj.py, outproj_bwd_f32_plan).
extern "C" long long nvt_fused_outproj_f32_bwd_smem_bytes() {
  return static_cast<long long>(nvt::DattnLoop::kSmemBytes);
}
