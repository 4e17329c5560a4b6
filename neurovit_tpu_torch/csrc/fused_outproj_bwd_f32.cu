// Backward of the attention out-projection (K8) at f32, deterministic, on
// the CUDA cores.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_outproj.py:56 (_bwd_kernel,
// launched at :102) on f32 operands, where nothing is rounded:
//   dz = dy * mask / keep                training, dropout > 0
//   da = dz . Wout                       f32, [M, inner]
// The mask of element (row, col) is nn.keep_mask's bit at row * dim + col
// under seed, the forward's (fused_outproj_f32.cu). dx = dy, dWout = dz^T a
// and db = sum_rows(dz) stay outside (ops/fused_outproj.py, FusedOutproj).
//
// What bounds it on the H100: its 2 M dim inner flops, at f32 on the
// CUDA cores (ffma.cuh says why not yet in 3xTF32): 8.4 GFLOP for the
// flagship block at batch 8 (M = 8008, dim 1024, inner 512), 0.125 ms at
// 67 TFLOP/s, above its 50 MB of dy, dz, Wout and da.
//
// The design, on the caller's stream: at dropout > 0 the dz rows pass
// (ffma.cu launch_dz_rows without the LayerNorm, K9 f32's pass 1) into
// the caller's dz; then ffma.cuh's GEMM with B = Wout [dim, inner] as it
// lies (kBKn: 16-deep slices of it are k-major, staged by 16-byte
// copies) over (ceil(inner / 128), ceil(M / 128)) tiles, A = dz, or dy
// itself at dropout 0, where the wrapper returns dy as dz.
#include "ffma.cuh"

// dy [M, dim], w [dim, inner], da [M, inner], dz [M, dim] (null at
// dropout 0), all f32. dim % 16 == 0, inner % 16 == 0. keep_q: dropout
// threshold (0 = none), inv_keep = 1 / keep.
extern "C" int nvt_fused_outproj_f32_bwd(const void* dy, const void* w,
                                         void* da, void* dz, int M,
                                         int inner, int dim, float inv_keep,
                                         int keep_q, uint64_t seed,
                                         void* stream) {
  using namespace nvt;
  if (M < 1 || inner < 16 || inner % 16 != 0 || dim < 16 || dim % 16 != 0 ||
      keep_q < 0 || keep_q > 255 || (keep_q > 0) != (dz != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(dy);
  if (keep_q) {
    const cudaError_t err = ffma::launch_dz_rows(
        a, nullptr, nullptr, nullptr, static_cast<float*>(dz), nullptr,
        nullptr, M, dim, 0.f, inv_keep, static_cast<uint32_t>(keep_q), seed,
        s);
    if (err != cudaSuccess) return static_cast<int>(err);
    a = static_cast<const float*>(dz);
  }
  const ffma::StoreEpi epi{static_cast<float*>(da), inner};
  return static_cast<int>(ffma::launch_gemm<true>(
      a, static_cast<const float*>(w), M, inner, dim, epi, s));
}
