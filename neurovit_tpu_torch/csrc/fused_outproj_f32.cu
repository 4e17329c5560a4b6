// Fused attention out-projection + bias + dropout + residual (K3) at f32,
// deterministic, on the tensor cores by 3xTF32 on wgmma.
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
// the torch weight [dim, inner], K-major for a . Wout^T as it lies.
//
// What bounds it on the H100: its 2 M inner dim flops, 8.4 GFLOP for the
// flagship block at batch 8 (M = 8008, inner 512, dim 1024). In 3xTF32
// (tf32x3_wgmma.cuh: three TF32 products a product, about f32's accuracy)
// at the data sheet's 495 TF32 TFLOP/s that is 165 TFLOP/s of f32
// products, 0.0509 ms, above its 84 MB of a, x, Wout and y (0.025 ms at
// 3.35 TB/s).
//
// The design is one launch of K4 f32's last pass (fused_mlp_f32.cu,
// fc2_residual, launch_fc2_residual), as the bf16 K3 is one launch of
// K4's, after the forwards' weight pre-pass (nvt_split_f32, its own
// wrapper) has split Wout as it lies into big and small: Loop<4, 1> over
// (ceil(dim / 128), ceil(M / 128)) tiles with A = a and K = inner, a
// fresh accumulator a stage (K = 512 is 192 TF32 products deep); the
// epilogue adds b, applies the mask and adds x in f32, y rounded once.
// TMA zero-fills the boxes past M, dim and inner, and the epilogue's walk
// masks rows >= M and columns >= dim, so inner and dim are any multiples
// of 16 and M any count. An all-zero row of a gives y = x + b exactly at
// dropout 0: its fresh sums are +0.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; profiler device times from
// scripts/torch_outproj_device_times.py at batch 8): 0.1224 ms, the split
// 2.8 us and fc2_residual 119.7 (0.425 of the bound; the FFMA design took
// 0.2297 in one launch), 0.672x f32 torch.mm at the GEMM alone. At K = 512
// a tile runs 16 stages, and its ring fill and epilogue (x read, y
// written), about 15 us of a tile's 30, go unhidden: fc2 at K = 2048
// reaches 0.667.
#include "tf32x3_wgmma.cuh"

// a [M, inner], x [M, dim], w_big, w_small [dim, inner] (Wout split by
// nvt_split_f32), bias [dim], y [M, dim], all f32 and 16-byte aligned.
// inner % 16 == 0, dim % 16 == 0. keep_q: dropout threshold (0 = none),
// inv_keep = 1 / keep.
extern "C" int nvt_fused_outproj_f32_fwd(const void* a, const void* x,
                                         const void* w_big,
                                         const void* w_small,
                                         const void* bias, void* y, int M,
                                         int inner, int dim, float inv_keep,
                                         int keep_q, uint64_t seed,
                                         void* stream) {
  using namespace nvt::tf32x3_wgmma;
  if (M < 1 || inner < 16 || inner % 16 != 0 || dim < 16 || dim % 16 != 0 ||
      keep_q < 0 || keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  // The three maps are encoded, and the kernel allowed its shared memory,
  // before the launch.
  CUtensorMap ta, tbig, tsmall;
  cudaError_t err =
      encode_kmajor_f32(&ta, static_cast<const float*>(a), M, inner, kBM);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&tbig, static_cast<const float*>(w_big), dim,
                            inner, kBN);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&tsmall, static_cast<const float*>(w_small), dim,
                            inner, kBN);
  if (err == cudaSuccess) err = allow_fc2_residual_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_fc2_residual(
      ta, tbig, tsmall, static_cast<const float*>(bias),
      static_cast<const float*>(x), static_cast<float*>(y), M, dim, inner,
      inv_keep, static_cast<uint32_t>(keep_q), seed,
      static_cast<cudaStream_t>(stream)));
}

// K3 f32's tensor-parallel form on a row-parallel shard (a [M, inner] the
// shard's heads, w_big, w_small [dim, inner] its columns of Wout split),
// one launch of K4 f32's fc2 in its tensor-parallel form: y [M, dim] = (a .
// w^T [+ bias]) * mask / keep [+ x]; x and bias null on all but the model
// group's first shard.
extern "C" int nvt_fused_outproj_f32_partial_fwd(
    const void* a, const void* x, const void* w_big, const void* w_small,
    const void* bias, void* y, int M, int inner, int dim, float inv_keep,
    int keep_q, uint64_t seed, void* stream) {
  using namespace nvt::tf32x3_wgmma;
  if (M < 1 || inner < 16 || inner % 16 != 0 || dim < 16 || dim % 16 != 0 ||
      keep_q < 0 || keep_q > 255 || y == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tbig, tsmall;
  cudaError_t err =
      encode_kmajor_f32(&ta, static_cast<const float*>(a), M, inner, kBM);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&tbig, static_cast<const float*>(w_big), dim,
                            inner, kBN);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&tsmall, static_cast<const float*>(w_small), dim,
                            inner, kBN);
  if (err == cudaSuccess) err = allow_fc2_partial_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_fc2_partial(
      ta, tbig, tsmall, static_cast<const float*>(bias),
      static_cast<const float*>(x), static_cast<float*>(y), M, dim, inner,
      inv_keep, static_cast<uint32_t>(keep_q), seed,
      static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of a block of K3 f32's one launch, K4 f32's
// fc2_residual (ops/fused_outproj.py outproj_f32_plan, ops/tf32x3.py SMEM).
extern "C" long long nvt_fused_outproj_f32_smem_bytes() {
  return static_cast<long long>(nvt::tf32x3_wgmma::fc2_residual_smem_bytes());
}
