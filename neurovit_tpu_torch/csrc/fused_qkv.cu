// Fused LayerNorm + bias-free QKV projection (K2), bf16, on TMA + wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_qkv.py:57 (_fwd_kernel,
// launched at :108 by fused_ln_qkv):
//   u = bf16(LN(x) * gamma + beta)          f32 statistics, one rounding
//   [q | k | v] = bf16(u . Wqkv^T)           f32 accumulation, no bias
// Wqkv is the torch weight [3 inner, dim] whose rows are ordered (3, heads,
// dim_head), so each of q, k, v comes out [M, inner] and views as
// [B, N, H, D] for the attention kernel with no copy. Wqkv is K-major as it
// lies, so wgmma reads it with no transpose.
//
// What bounds it on the H100: 6 M dim inner flops on the tensor cores
// (0.0255 ms at 989 TFLOP/s for the flagship block at batch 8: M = 8008,
// dim 1024, inner 512). The TPU kernel holds a row block and all of Wqkv in
// VMEM and normalises each row before one [rows, dim] x [dim, 3 inner] dot.
// On the card the column tiles of a row block are different blocks, each of
// which would need the whole LayerNorm'd row, so u goes through device
// memory as bf16 (x read, u written and read, q, k, v written, Wqkv read:
// about 77 MB at that shape, 0.023 ms at 3.35 TB/s), in two launches on
// the caller's stream:
//   1. ln_rows (fused_mlp.cu, K4's pass 1, launch_ln_rows): x -> u
//      [M, dim], one warp a row (fused_mlp.cuh ln_row). In training u is
//      the caller's output, the operand of dWqkv; in serving a scratch.
//   2. qkv_gemm: hopper_gemm.cuh Mainloop<false, 128, BN, 3> over (3
//      ceil(inner / BN), ceil(M / 128)) tiles, A = u, Bt = Wqkv. Column
//      tile j serves output which = j / ceil(inner / BN) at its columns c0 =
//      (j mod ceil(inner / BN)) BN, from Wqkv's rows which inner + c0 on,
//      so a tile never straddles q, k and v and each block writes one
//      tensor (K10's column map, int8_qkv.cu). The epilogue rounds each f32
//      accumulator pair to a bf16 pair, stages the tile in the freed ring
//      as the output maps' 64-column boxes (fused_mlp.cuh staged_at, the
//      128-byte swizzle) and stores it by TMA into q, k or v, which clips
//      the rows past M and the columns past inner (where inner is not a
//      multiple of BN, the last tile of a section reads rows of the next;
//      TMA zero-fills past 3 inner).
// BN is 128, or 64 where 128-wide tiles would give the card fewer blocks
// than its 132 SMs (fused_mlp.cuh tile_n; batch 1 of the flagship). Three
// stages (97 KiB of ring at BN = 128) let two GEMM blocks share an SM, so
// one block's epilogue runs under the other's mainloop. TMA zero-fills the
// boxes past M and dim, so widths are multiples of 16 (TMA's 16-byte rows)
// of any size: no row is held whole in registers or shared memory.
//
// The stores: the bf16 pairs straight from registers (4 bytes a thread, 16
// contiguous bytes a quad), K10's epilogue, took qkv_gemm 60.9-61.3 us at
// batch 8 and 835.8-844.6 at batch 128, against 45.8-45.9 and 684.7-708.7
// staged and stored by TMA, in the same runs (K17 bf16's GEMM kernel at
// the same shape 56.2-57.0 and 846.3-853.6; PERF.md, section 6; NVIDIA
// H100 80GB HBM3, 700.00 W, scripts/torch_qkv_device_times.py).
//
// Rounding points are the JAX kernel's and the plain version's
// (fused_qkv.py:48-68): LN's mean and mean of squared deviations in f32,
// rsqrt(var + eps), xhat * gamma + beta, one rounding of u to bf16; q, k, v
// rounded once from the f32 sums.
#include "fused_mlp.cuh"

namespace nvt {
namespace {

using namespace mlp;

// The serving call's scratch: u [M, dim] bf16, on a 256-byte boundary.
size_t scratch_bytes(int M, int dim) {
  return round_up(static_cast<size_t>(M) * dim * sizeof(bf16), 256);
}

// Pass 2: [q | k | v] = bf16(u . Wqkv^T), staged in the ring and stored by
// TMA (fused_mlp.cuh store_tile). Rows past M are staged too and clipped
// by the store.
template <int BN>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
    qkv_gemm_kernel(const __grid_constant__ CUtensorMap tu,
                    const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, int dim,
                    int inner) {
  extern __shared__ unsigned char smem[];
  const int tiles = (inner + BN - 1) / BN;   // column tiles of a section
  const int which = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * BN;
  const int m0 = blockIdx.y * kBM;
  float acc[Loop<BN>::kAccRegs];
  if (!Loop<BN>::run(&tu, &tw, m0, which * inner + c0, dim, smem, acc))
    return;
  store_tile<BN>(which == 0 ? &tq : (which == 1 ? &tk : &tv), smem, acc, c0,
                 m0, inner);
}

template <int BN>
void launch_gemm(const CUtensorMap& tu, const CUtensorMap& tw,
                 const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, int M, int dim, int inner,
                 cudaStream_t stream) {
  const dim3 grid(3 * ((inner + BN - 1) / BN), (M + kBM - 1) / kBM);
  qkv_gemm_kernel<BN><<<grid, kThreads, Loop<BN>::kSmemBytes, stream>>>(
      tu, tw, tq, tk, tv, dim, inner);
}

cudaError_t launch_all(const bf16* x, const float* gamma, const float* beta,
                       const bf16* w, bf16* q, bf16* k, bf16* v, bf16* u,
                       int M, int dim, int inner, float eps,
                       cudaStream_t stream) {
  const int bn = tile_n(M, 3 * inner);
  // Every map is encoded, and both instances allowed their shared memory,
  // before the first launch: a failure leaves nothing half done. The
  // output maps' boxes are 64 columns by the tile's 128 rows.
  CUtensorMap tu, tw, tq, tk, tv;
  cudaError_t err = hopper::encode_kmajor(&tu, u, M, dim, false, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tq, q, M, inner, false, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tk, k, M, inner, false, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tv, v, M, inner, false, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw, w, 3 * inner, dim, false, bn);
  if (err == cudaSuccess)
    err = allow_smem(qkv_gemm_kernel<64>, Loop<64>::kSmemBytes);
  if (err == cudaSuccess)
    err = allow_smem(qkv_gemm_kernel<128>, Loop<128>::kSmemBytes);
  if (err != cudaSuccess) return err;

  err = launch_ln_rows(x, gamma, beta, u, M, dim, eps, stream);
  if (err != cudaSuccess) return err;
  (bn == 64 ? launch_gemm<64> : launch_gemm<128>)(tu, tw, tq, tk, tv, M,
                                                  dim, inner, stream);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nvt

// x [M, dim] bf16; gamma, beta [dim] f32; w [3*inner, dim] bf16; q, k, v
// [M, inner] bf16; u [M, dim] bf16, never null: the caller's u in
// training, else a scratch of nvt_fused_ln_qkv_fwd_scratch_bytes(M, dim,
// inner) bytes. All 16-byte aligned. dim and inner are multiples of 16
// (TMA's 16-byte rows), of any size.
extern "C" int nvt_fused_ln_qkv_fwd(const void* x, const void* gamma,
                                    const void* beta, const void* w, void* q,
                                    void* k, void* v, void* u, int M, int dim,
                                    int inner, float eps, void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || inner < 16 || inner % 16 != 0 ||
      u == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w),
      static_cast<bf16*>(q), static_cast<bf16*>(k), static_cast<bf16*>(v),
      static_cast<bf16*>(u), M, dim, inner, eps,
      static_cast<cudaStream_t>(stream)));
}

// Bytes of the scratch a serving call takes for u (ops/fused_qkv.py,
// qkv_plan); a training call passes its u output instead.
extern "C" long long nvt_fused_ln_qkv_fwd_scratch_bytes(int M, int dim,
                                                        int inner) {
  (void)inner;
  return static_cast<long long>(nvt::scratch_bytes(M, dim));
}

// Dynamic shared memory of a block of the GEMM pass for M rows at inner,
// which follows its tile's width.
extern "C" long long nvt_fused_ln_qkv_fwd_smem_bytes(int M, int inner) {
  return static_cast<long long>(nvt::mlp::gemm_smem_bytes(M, 3 * inner));
}
