// Backward of the fused out-projection + dropout + residual (K8), bf16, on
// TMA + wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_outproj.py:56 (_bwd_kernel,
// launched at :102):
//   dz    = bf16(dy * mask / keep)          the forward's mask, regenerated
//   dattn = bf16(dz . Wout)                 f32 accumulation, [M, inner]
// dx = dy, dWout = dz^T attn and db = sum(dz) stay outside
// (fused_outproj.py:131-141; ops/fused_outproj.py, FusedOutproj.backward).
//
// What bounds it on the H100: bytes. For the flagship block at batch 8 (M =
// 8008, dim 1024, inner 512) the function reads dy and Wout and writes
// dattn and dz, 42 MB (0.0126 ms at 3.35 TB/s), against 2 M dim inner =
// 8.4 GFLOP (0.0085 ms at 989 TFLOP/s). The TPU kernel turns a row block
// of dy into dz in VMEM and multiplies it there. A block that feeds wgmma
// from a TMA ring has no room for a row block of dz beside it, and a
// column tile of dattn needs all of dz's row, so dz goes through device
// memory, which the caller needs anyway (dWout and db): dy read, dz
// written and read again, 58.4 MB at that shape (0.0174 ms). In up to two
// launches on the caller's stream:
//   1. dz_rows, at dropout > 0 only: K9's pass 1 without the LayerNorm
//      (fused_mlp.cu, launch_dz_rows), one warp a row; lane l takes
//      columns 512 i + 16 l .. + 15, byte e of Philox block (row * dim +
//      col) / 16 under the seed: nn.keep_mask's bits, which K3's quad draw
//      (fused_mlp.cuh QuadKeep) used in the forward.
//   2. dattn: fused_mlp.cuh Loop<BN, true> over ceil(inner / BN) x ceil(M /
//      128) tiles, K = dim, A = dz (dy itself at dropout 0, when dz is dy
//      and the wrapper returns dy), B = Wout [dim, inner] as it lies
//      (MN-major for this product: hopper_gemm.cuh's MN-major B mode, as
//      K9's hidden pass reads W2). The epilogue rounds the accumulator
//      pairs to bf16, stages the tile in the freed ring as the output
//      map's 64-column boxes and stores it by TMA (fused_mlp.cuh
//      store_tile, K2's qkv_gemm epilogue).
// Three stages (97 KiB of ring at BN = 128) let two GEMM blocks share an
// SM, so one block's epilogue runs under the other's mainloop; BN is 128,
// or 64 where 128-wide tiles would give the card fewer blocks than its 132
// SMs (fused_mlp.cuh tile_n; 8 x 8 tiles at batch 1 of the flagship). TMA
// zero-fills the boxes past M, dim and inner on loads and clips them on
// stores, so widths are multiples of 16 (TMA's 16-byte rows) of any size:
// no row of dz is held in shared memory.
#include "fused_mlp.cuh"

namespace nvt {
namespace {

using namespace mlp;

template <int BN>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
    dattn_kernel(const __grid_constant__ CUtensorMap tdz,
                 const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap tout, int dim,
                 int inner) {
  extern __shared__ unsigned char smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  float acc[Loop<BN, true>::kAccRegs];
  if (!Loop<BN, true>::run(&tdz, &tw, m0, n0, dim, smem, acc)) return;
  store_tile<BN>(&tout, smem, acc, n0, m0, inner);
}

template <int BN>
void launch_dattn(const CUtensorMap& tdz, const CUtensorMap& tw,
                  const CUtensorMap& tout, int M, int dim, int inner,
                  cudaStream_t stream) {
  dattn_kernel<BN><<<dim3((inner + BN - 1) / BN, (M + kBM - 1) / kBM),
                     kThreads, Loop<BN, true>::kSmemBytes, stream>>>(
      tdz, tw, tout, dim, inner);
}

cudaError_t launch_all(const bf16* dy, const bf16* w, bf16* dattn, bf16* dz,
                       int M, int inner, int dim, float inv_keep,
                       uint32_t keep_q, uint64_t seed, cudaStream_t stream) {
  // At dropout 0 dz is dy: the GEMM reads dy and nothing is written to dz.
  const bf16* a = keep_q ? dz : dy;
  // Every map is encoded, and both instances allowed their shared memory,
  // before the first launch: a failure leaves nothing half done. The A and
  // output maps' boxes are kBM rows by 64 columns; Wout's 64 x 64.
  CUtensorMap ta, tw, tout;
  cudaError_t err = hopper::encode_kmajor(&ta, a, M, dim, false, kBM);
  if (err == cudaSuccess) err = hopper::encode_mnmajor(&tw, w, dim, inner);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tout, dattn, M, inner, false, kBM);
  if (err == cudaSuccess)
    err = allow_smem(dattn_kernel<64>, Loop<64, true>::kSmemBytes);
  if (err == cudaSuccess)
    err = allow_smem(dattn_kernel<128>, Loop<128, true>::kSmemBytes);
  if (err != cudaSuccess) return err;

  if (keep_q &&
      (err = launch_dz_rows(dy, nullptr, nullptr, nullptr, dz, nullptr,
                            nullptr, M, dim, 0.f, inv_keep, keep_q, seed,
                            stream)) != cudaSuccess)
    return err;
  (tile_n(M, inner) == 64 ? launch_dattn<64> : launch_dattn<128>)(
      ta, tw, tout, M, dim, inner, stream);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nvt

// dy [M, dim], w [dim, inner] bf16; dattn [M, inner] bf16; dz [M, dim] bf16
// at dropout > 0, unused (and may be null) at keep_q 0, when dz is dy. All
// 16-byte aligned. dim and inner are multiples of 16 (TMA's 16-byte rows),
// of any size. keep_q: dropout threshold (0 = none).
extern "C" int nvt_fused_outproj_bwd(const void* dy, const void* w,
                                     void* dattn, void* dz, int M, int inner,
                                     int dim, float inv_keep, int keep_q,
                                     uint64_t seed, void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || inner < 16 || inner % 16 != 0 ||
      keep_q < 0 || keep_q > 255 || (keep_q && dz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
      static_cast<bf16*>(dattn), static_cast<bf16*>(dz), M, inner, dim,
      inv_keep, static_cast<uint32_t>(keep_q), seed,
      static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of a block of the dattn pass for M rows at inner,
// which follows its tile's width (ops/fused_outproj.py, outproj_bwd_plan).
extern "C" long long nvt_fused_outproj_bwd_smem_bytes(int M, int inner) {
  return static_cast<long long>(nvt::mlp::gemm_smem_bytes(M, inner));
}
