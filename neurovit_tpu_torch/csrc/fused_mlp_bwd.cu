// Backward of the fused residual MLP block, bf16, deterministic.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_mlp.py:141 (_bwd_kernel,
// launched at :241). From dy, x, the forward's h and the regenerated masks:
//   dz = bf16(dy * mask2 / keep)
//   a  = bf16(GELU(h) * mask1 / keep)               the dW2 operand
//   da = dz . W2                                    f32, [M, hid]
//   dh = bf16(da * GELU'(h) * mask1 / keep)         GELU' = Phi + h phi
//   du = dh . W1                                    f32, [M, dim]
//   dx = bf16(LN backward of du at x + dy),  u = bf16(LN(x) * gamma + beta)
//   dgamma = sum_rows(du * xhat), dbeta = sum_rows(du)
// dW1 = u^T dh, dW2 = a^T dz, db1 and db2 stay outside (fused_mlp.py:285-300).
//
// What bounds it on the H100: 8 * M * dim * hid flops in two GEMMs, on the
// tensor cores through nvt::TileGemm's [K, N] mode (W2 [dim, hid] and W1
// [hid, dim] are the torch weights, read with no transpose). The TPU kernel
// runs both GEMMs per row block with the [rows, hid] da in VMEM; here that
// f32 da does not fit beside dz in shared memory, so the work splits where
// JAX writes to HBM anyway:
//   1. hidden_kernel, grid (ceil(M/64), ceil(hid/512)): dz rows into shared
//      memory (and out), da tile by tile, its epilogue writes a and dh;
//   2. du_gemm_kernel (backward.cuh): du = dh . W1 for 32-row blocks (dh
//      resident 2048 columns at a time, so ViT-L's hid 4096 takes two);
//   3. the LayerNorm backward rows (+ dy, + u) and the dgamma / dbeta sums.
// Widths are multiples of 16 with dim <= 1024 (the LayerNorm rows sit in
// one warp's registers); dz's columns past dim are zero up to the k tile
// and the last column tile is masked.
#include "backward.cuh"

namespace nvt {
namespace {

constexpr int kBM = 64, kBN = 128, kBK = 32, kChunk = 512;
using Gemm = TileGemm<kBM, kBN, kBK, 2, 4, true>;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__global__ void __launch_bounds__(Gemm::kThreads)
    mlp_bwd_hidden_kernel(const bf16* __restrict__ dy,
                          const bf16* __restrict__ h,
                          const bf16* __restrict__ w2, bf16* __restrict__ dz,
                          bf16* __restrict__ a_out, bf16* __restrict__ dh_out,
                          int M, int dim, int hid, float inv_keep,
                          uint32_t keep_q, uint64_t seed1, uint64_t seed2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dim_k = static_cast<int>(round_up(dim, kBK));
  const int lda = dim_k + kPad;
  bf16* A = reinterpret_cast<bf16*>(smem);
  void* scratch =
      smem + round_up(static_cast<size_t>(kBM) * lda * sizeof(bf16), 128);
  const int row0 = blockIdx.x * kBM;
  dropout_rows<kBM, Gemm::kThreads>(dy, A, lda,
                                    blockIdx.y == 0 ? dz : nullptr, row0, M,
                                    dim, inv_keep, keep_q, seed2);
  zero_cols<Gemm::kThreads>(A, lda, kBM, dim, dim_k);

  const float* C = reinterpret_cast<const float*>(scratch);
  DropoutBits bits(seed1);
  const int n_begin = blockIdx.y * kChunk;
  const int n_end = min(n_begin + kChunk, hid);
  for (int n0 = n_begin; n0 < n_end; n0 += kBN) {
    Gemm::run(A, lda, w2, hid, n0, dim, scratch, hid);
    for (int e = threadIdx.x; e < kBM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = row0 + r;
      if (row >= M || n0 + c >= hid) continue;
      const size_t off = static_cast<size_t>(row) * hid + n0 + c;
      float hf[8], a[8], dh[8];
      unpack8(*reinterpret_cast<const uint4*>(h + off), hf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // GELU as fused_mlp.cu computes it; GELU' = Phi(x) + x phi(x).
        const float x = hf[i];
        const float e = erff(x * kInvSqrt2);
        a[i] = 0.5f * x * (1.f + e);
        dh[i] = C[r * Gemm::LDC + c + i] *
                (0.5f * (1.f + e) + x * expf(-0.5f * x * x) * kInvSqrt2Pi);
        if (keep_q) {
          const float m = bits.keep(off + i, keep_q) ? inv_keep : 0.f;
          a[i] *= m;
          dh[i] *= m;
        }
      }
      *reinterpret_cast<uint4*>(a_out + off) = pack8(a);
      *reinterpret_cast<uint4*>(dh_out + off) = pack8(dh);
    }
  }
}

size_t hidden_smem(int dim) {
  return round_up(static_cast<size_t>(kBM) * (round_up(dim, kBK) + kPad) *
                      sizeof(bf16),
                  128) +
         Gemm::kScratchBytes;
}

}  // namespace
}  // namespace nvt

// dy, x [M, dim], h [M, hid], w1 [hid, dim], w2 [dim, hid] bf16; gamma,
// beta [dim] f32. Outputs: dx, u, dz [M, dim] and a, dh [M, hid] bf16;
// dgamma, dbeta [dim] f32. Scratch: du [M, dim] f32, part_g, part_b
// [ceil(M/32), dim] f32. dim % 16 == 0, dim <= 1024, hid % 16 == 0.
// keep_q 0 = no dropout; seed1 the hidden site, seed2 the output site.
extern "C" int nvt_fused_mlp_bwd(
    const void* dy, const void* x, const void* h, const void* gamma,
    const void* beta, const void* w1, const void* w2, void* dx, void* u,
    void* a, void* dz, void* dh, void* du, void* part_g, void* part_b,
    void* dgamma, void* dbeta, int M, int dim, int hid, float eps,
    float inv_keep, int keep_q, uint64_t seed1, uint64_t seed2,
    void* stream) {
  using namespace nvt;
  if (M < 1 || !ln_dim_ok(dim) || hid < 16 || hid % 16 != 0 || keep_q < 0 ||
      keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = hidden_smem(dim);
  cudaError_t err = allow_smem(mlp_bwd_hidden_kernel, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((M + kBM - 1) / kBM, (hid + kChunk - 1) / kChunk);
  mlp_bwd_hidden_kernel<<<grid1, Gemm::kThreads, smem1, s>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(h),
      static_cast<const bf16*>(w2), static_cast<bf16*>(dz),
      static_cast<bf16*>(a), static_cast<bf16*>(dh), M, dim, hid, inv_keep,
      static_cast<uint32_t>(keep_q), seed1, seed2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem2 = du_gemm_smem(hid);
  err = allow_smem(du_gemm_kernel, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((M + kDuBM - 1) / kDuBM, (dim + kDuChunk - 1) / kDuChunk);
  du_gemm_kernel<<<grid2, DuGemm::kThreads, smem2, s>>>(
      static_cast<const bf16*>(dh), nullptr, nullptr, hid,
      static_cast<const bf16*>(w1), static_cast<float*>(du), M, hid, dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  return static_cast<int>(launch_ln_bwd(
      static_cast<const bf16*>(x), static_cast<const float*>(du),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<bf16*>(u), static_cast<float*>(part_g),
      static_cast<float*>(part_b), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), M, dim, eps, s));
}
