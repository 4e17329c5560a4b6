// Fused attention out-projection + bias + dropout + residual (K3), bf16,
// deterministic, on TMA + wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_outproj.py:44 (_fwd_kernel,
// launched at :79 by fused_outproj_residual):
//   z = a . Wout^T + b                   f32
//   z = z * (mask * (1 / keep))          training only (fused_outproj.py:50-52)
//   y = bf16(x + z)                      x added in f32, one rounding
// The mask of element (row, col) is nn.keep_mask's bit at row * dim + col
// under seed, the site the plain version and K8 regenerate. a [M, inner] is
// the attention output viewed as rows (no head transpose), Wout the torch
// weight [dim, inner], K-major as it lies, so wgmma reads it with no
// transpose.
//
// What bounds it on the H100: the bytes of a, x, y and Wout (42.0 MB for
// the flagship block at batch 8, M = 8008, inner 512, dim 1024: 0.0126 ms
// at 3.35 TB/s) above its 2 M inner dim flops (0.0085 ms at 989 TFLOP/s).
//
// The design is one launch of K4's pass 3 (fused_mlp.cu, fc2_residual,
// launch_fc2_residual) with A = a, Bt = Wout and K = inner: fused_mlp.cuh
// Loop<BN> over (ceil(dim / BN), ceil(M / 128)) tiles, a 3-stage ring so
// two blocks share an SM; the epilogue adds b, applies the mask (QuadKeep:
// the quad's four threads draw the row's Philox blocks once), adds x in f32
// and rounds y once, stored as bf16 pairs from registers. BN is 128, or 64
// where 128-wide tiles would give the card fewer blocks than its 132 SMs
// (fused_mlp.cuh tile_n). TMA zero-fills the boxes past M, dim and inner;
// the epilogue masks rows >= M and columns >= dim. No row block of a is
// held in shared memory, so inner is any multiple of 16 (TMA's 16-byte
// rows), and Wout is read by each row tile from L2.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; profiler device times from
// scripts/torch_outproj_device_times.py, four runs): 0.0332-0.0343 ms at
// batch 8, 0.0349-0.0361 at dropout 0.1, where torch.mm with bf16 out
// takes 15.1-15.2 us for the GEMM alone and K17 bf16's GEMM kernel
// 26.9-27.0; the wmma kernel this replaces took 0.0766 and 0.0890. At K =
// 512 a tile has eight k steps, too few to hide each block's ring fill and
// its epilogue; an L2 prefetch of the block's x tile as it starts took
// 39.4-42.0 us.
#include "fused_mlp.cuh"

// a [M, inner], x [M, dim], w [dim, inner] bf16; bias [dim] f32;
// y [M, dim] bf16. inner % 16 == 0, dim % 16 == 0. keep_q: dropout
// threshold (0 = none), inv_keep = 1 / keep.
extern "C" int nvt_fused_outproj_fwd(const void* a, const void* x,
                                     const void* w, const void* bias, void* y,
                                     int M, int inner, int dim, float inv_keep,
                                     int keep_q, uint64_t seed, void* stream) {
  using namespace nvt;
  if (M < 1 || inner < 16 || inner % 16 != 0 || dim < 16 || dim % 16 != 0 ||
      keep_q < 0 || keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = mlp::tile_n(M, dim);
  // Both maps are encoded, and both instances allowed their shared memory,
  // before the launch.
  CUtensorMap ta, tw;
  cudaError_t err = hopper::encode_kmajor(&ta, a, M, inner, false, mlp::kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw, w, dim, inner, false, bn);
  if (err == cudaSuccess) err = mlp::allow_fc2_residual_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mlp::launch_fc2_residual(
      ta, tw, static_cast<const float*>(bias), static_cast<const bf16*>(x),
      static_cast<bf16*>(y), M, dim, inner, inv_keep,
      static_cast<uint32_t>(keep_q), seed, bn,
      static_cast<cudaStream_t>(stream)));
}

// K3's tensor-parallel form on a row-parallel shard (a [M, inner] the
// shard's heads, w [dim, inner] its columns of Wout), one launch of K4's
// fc2_residual in its tensor-parallel form: y [M, dim] f32 = (a . w^T [+
// bias]) * mask / keep [+ x], not rounded; x and bias null on all but the
// model group's first shard, the mask the whole projection's.
extern "C" int nvt_fused_outproj_partial_fwd(const void* a, const void* x,
                                             const void* w, const void* bias,
                                             void* y, int M, int inner,
                                             int dim, float inv_keep,
                                             int keep_q, uint64_t seed,
                                             void* stream) {
  using namespace nvt;
  if (M < 1 || inner < 16 || inner % 16 != 0 || dim < 16 || dim % 16 != 0 ||
      keep_q < 0 || keep_q > 255 || y == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = mlp::tile_n(M, dim);
  CUtensorMap ta, tw;
  cudaError_t err = hopper::encode_kmajor(&ta, a, M, inner, false, mlp::kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw, w, dim, inner, false, bn);
  if (err == cudaSuccess) err = mlp::allow_fc2_partial_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mlp::launch_fc2_partial(
      ta, tw, static_cast<const float*>(bias), static_cast<const bf16*>(x),
      static_cast<float*>(y), M, dim, inner, inv_keep,
      static_cast<uint32_t>(keep_q), seed, bn,
      static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of a block of K3's one launch for M rows at dim,
// which follows its tile's width (ops/fused_outproj.py, outproj_plan).
extern "C" long long nvt_fused_outproj_smem_bytes(int M, int dim) {
  return static_cast<long long>(nvt::mlp::gemm_smem_bytes(M, dim));
}
