// Backward of the fused LayerNorm + QKV projection (K7), bf16,
// deterministic, on TMA + wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_qkv.py:71 (_bwd_kernel,
// launched at :135). From dqkv = [dq | dk | dv] [M, 3 inner] (q, k, v in
// that order, each [M, heads * dim_head]), x [M, dim] and Wqkv [3 inner,
// dim] (the torch weight, rows ordered (3, heads, dim_head)):
//   du = dqkv . Wqkv                        f32 accumulation, [M, dim]
//   xhat = (x - mean) * rstd                x's own statistics, f32
//   dx = bf16(rstd (du gamma - m1 - xhat m2))
//   dgamma = sum_rows(du * xhat), dbeta = sum_rows(du)      f32
// m1 and m2 the row means of du gamma and du gamma xhat. dWqkv = dqkv^T u
// is a plain product outside (ops/fused_qkv.py, FusedLnQkv.backward).
//
// What bounds it on the H100: 2 M 3 inner dim flops in one GEMM (25.2
// GFLOP, 0.0255 ms at 989 TFLOP/s, for the flagship block at batch 8: M =
// 8008, dim 1024, inner 512). The TPU kernel holds a 512-row block, the
// whole Wqkv and the block's f32 du in VMEM. A block that feeds wgmma from
// a TMA ring has no room for a row block's f32 du, so du makes one f32
// round trip through device memory, as in K9: dqkv and Wqkv read once, x
// three times, du written and read as f32, dx written, about 160 MB at
// that shape (0.048 ms at 3.35 TB/s), in four launches on the caller's
// stream:
//   1. row_stats: one warp a row writes x's (mean, rstd) into the scratch
//      (ln_stats, fused_mlp.cuh: the forward LayerNorm's order of sums).
//   2-4. du, ln_bwd, colsum: ln_bwd.cuh's passes, K9's last three, with A
//      = dqkv through encode_kmajor, B = Wqkv as it lies through the
//      Mainloop's MN-major B mode, K = 3 inner (TMA zero-fills both past
//      it), and no residual: du = dqkv . Wqkv in f32 with the tile's share
//      of the LayerNorm backward's sums in its epilogue, over ceil(dim /
//      BN) x ceil(M / 128) tiles (BN 128, or 64 where 128 would give fewer
//      blocks than the 132 SMs); one warp a row for dx; dgamma / dbeta
//      summed over the row tiles in a fixed order.
// Widths are multiples of 16 (TMA's 16-byte rows) of any size. du, the
// row statistics and the partial sums live in one scratch allocation
// (ops/fused_qkv.py, qkv_bwd_plan).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W by
// scripts/torch_qkv_bwd_device_times.py at that shape: 0.097-0.099 ms of
// device time (row_stats 8 us, du 66-68 against K17 bf16's 50-51 at the
// same GEMM, ln_bwd 20, colsum 3), 3.8-3.9x the bound and 2.0x the bytes;
// the kernel it replaced took 0.47 ms. The du pass's excess over K17 is
// its epilogue's f32 stores and LayerNorm sums, as in K9.
#include "ln_bwd.cuh"

namespace nvt {
namespace {

// Pass 1: each row's (mean, rstd), one warp a row.
__global__ void __launch_bounds__(kRowWarps * 32)
    row_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats,
                     int M, int dim, float eps) {
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= M) return;
  const float2 st = ln_stats(x + static_cast<size_t>(row) * dim, dim, eps);
  if (threadIdx.x % 32 == 0) stats[row] = st;
}

template <typename TO>
cudaError_t launch_all(const bf16* dqkv, const bf16* x, const float* gamma,
                       const bf16* w, TO* dx, float* dgamma, float* dbeta,
                       unsigned char* scratch, int M, int dim, int inner,
                       float eps, cudaStream_t stream) {
  const int K = 3 * inner;
  float2* stats =
      reinterpret_cast<float2*>(scratch + Scratch(M, dim).stats);
  // Both maps are encoded, and both du instances allowed their shared
  // memory, before the first launch: a failure leaves nothing half done.
  CUtensorMap ta, tw;
  cudaError_t err = hopper::encode_kmajor(&ta, dqkv, M, K, false, kBM);
  if (err == cudaSuccess) err = hopper::encode_mnmajor(&tw, w, K, dim);
  if (err == cudaSuccess) err = allow_du_smem();
  if (err != cudaSuccess) return err;

  row_stats_kernel<<<(M + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                     stream>>>(x, stats, M, dim, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_ln_bwd(ta, tw, x, gamma, nullptr, dx, dgamma, dbeta, scratch,
                       M, dim, K, stream);
}

}  // namespace
}  // namespace nvt

// dqkv [M, 3 inner], x [M, dim], w [3 inner, dim] bf16; gamma [dim] f32.
// Outputs: dx [M, dim] bf16; dgamma, dbeta [dim] f32. scratch:
// nvt_fused_ln_qkv_bwd_scratch_bytes(M, dim, inner) bytes, 256-byte
// aligned. dim and inner are multiples of 16, of any size.
extern "C" int nvt_fused_ln_qkv_bwd(const void* dqkv, const void* x,
                                    const void* gamma, const void* w,
                                    void* dx, void* dgamma, void* dbeta,
                                    void* scratch, int M, int dim, int inner,
                                    float eps, void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || inner < 16 || inner % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all(
      static_cast<const bf16*>(dqkv), static_cast<const bf16*>(x),
      static_cast<const float*>(gamma), static_cast<const bf16*>(w),
      static_cast<bf16*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<unsigned char*>(scratch), M,
      dim, inner, eps, static_cast<cudaStream_t>(stream)));
}

// K7's tensor-parallel form on a shard (dqkv [M, 3 inner] and w [3 inner,
// dim] the shard's heads of q, k and v), every operand as
// nvt_fused_ln_qkv_bwd's but dx [M, dim] f32: the shard's partial, summed
// over the model group before its one rounding.
extern "C" int nvt_fused_ln_qkv_bwd_partial(const void* dqkv, const void* x,
                                            const void* gamma, const void* w,
                                            void* dx, void* dgamma,
                                            void* dbeta, void* scratch, int M,
                                            int dim, int inner, float eps,
                                            void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || inner < 16 || inner % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all(
      static_cast<const bf16*>(dqkv), static_cast<const bf16*>(x),
      static_cast<const float*>(gamma), static_cast<const bf16*>(w),
      static_cast<float*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<unsigned char*>(scratch), M,
      dim, inner, eps, static_cast<cudaStream_t>(stream)));
}

// Bytes of the scratch one call takes (ops/fused_qkv.py, qkv_bwd_plan).
extern "C" long long nvt_fused_ln_qkv_bwd_scratch_bytes(int M, int dim,
                                                        int /*inner*/) {
  return static_cast<long long>(nvt::Scratch(M, dim).bytes);
}

// Dynamic shared memory of a block of the du pass, whose output is
// [M, dim]; it follows the tile's width.
extern "C" long long nvt_fused_ln_qkv_bwd_smem_bytes(int M, int dim) {
  return static_cast<long long>(nvt::mlp::gemm_smem_bytes(M, dim));
}
