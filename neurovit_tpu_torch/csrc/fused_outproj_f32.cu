// Fused attention out-projection + bias + dropout + residual (K3) at f32,
// deterministic, on the CUDA cores.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_outproj.py:44 (_fwd_kernel,
// launched at :79 by fused_outproj_residual) on f32 operands, where it sums
// f32 products:
//   z = a . Wout^T + b                   f32
//   z = z * (mask * (1 / keep))          training only (fused_outproj.py:50-52)
//   y = x + z                            f32
// The mask of element (row, col) is nn.keep_mask's bit at row * dim + col
// under seed, the bits the bf16 kernel (fused_outproj.cu) and the plain
// version draw. a [M, inner] is the attention output viewed as rows; Wout
// is the torch weight [dim, inner] as it lies.
//
// What bounds it on the H100: its 2 M inner dim flops. At f32 they run
// on the CUDA cores (ffma.cuh says why K3 is not in 3xTF32 yet, as K2's
// and K4's forwards are): 8.4 GFLOP for
// the flagship block at batch 8 (M = 8008, inner 512, dim 1024), 0.12 ms
// at 67 TFLOP/s, above its 67 MB of a, x, y and Wout (0.020 ms at 3.35
// TB/s).
//
// The design: one launch of ffma.cuh's GEMM (128 x 128 tiles, 8 x 8 a
// thread, operands staged by cp.async) over (ceil(dim / 128), ceil(M /
// 128)) tiles, with ResidualEpi adding b, applying the mask and adding x
// from registers.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/torch_kernel_ab.py at
// batch 8, medians over 5 rounds, beside the first GEMM design):
// 0.2678 ms (first design 0.2819), 31.4 TFLOP/s; torch.mm at f32 0.2084
// ms (scripts/torch_ffma_tile_sweep.py).
#include "ffma.cuh"

// a [M, inner], x [M, dim], w [dim, inner], bias [dim], y [M, dim], all
// f32. inner % 16 == 0, dim % 16 == 0. keep_q: dropout threshold (0 =
// none), inv_keep = 1 / keep.
extern "C" int nvt_fused_outproj_f32_fwd(const void* a, const void* x,
                                         const void* w, const void* bias,
                                         void* y, int M, int inner, int dim,
                                         float inv_keep, int keep_q,
                                         uint64_t seed, void* stream) {
  using namespace nvt;
  if (M < 1 || inner < 16 || inner % 16 != 0 || dim < 16 || dim % 16 != 0 ||
      keep_q < 0 || keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const ffma::ResidualEpi epi{static_cast<const float*>(bias),
                              static_cast<const float*>(x),
                              static_cast<float*>(y),
                              dim,
                              inv_keep,
                              static_cast<uint32_t>(keep_q),
                              seed};
  return static_cast<int>(ffma::launch_gemm(
      static_cast<const float*>(a), static_cast<const float*>(w), M, dim,
      inner, epi, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of a block of the FFMA GEMMs (ffma.cuh), the one
// count ops/fused_mlp.py f32_gemm_smem_bytes holds.
extern "C" long long nvt_ffma_gemm_smem_bytes() {
  return static_cast<long long>(nvt::ffma::kSmemBytes);
}
