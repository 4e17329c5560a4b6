// Fused residual MLP block, bf16, deterministic.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_mlp.py:108 (_fwd_kernel,
// launched at :213 by fused_mlp_block):
//   u = bf16(LN(x) * gamma + beta)
//   h = bf16(u . W1^T + b1)              rounded before GELU (fused_mlp.py:120-124)
//   g = bf16(GELU(h) * mask1 / keep)     exact-erf GELU in f32, CUDA erff
//   z = (g . W2^T + b2) * mask2 / keep   f32
//   y = bf16(x + z)                      x added in f32, one rounding
// The masks (training only, fused_mlp.py:125-133) are nvt::DropoutBits of
// two sites: mask1 at row * hid + j of the hidden, mask2 at row * dim + c
// of the output. In training h is also stored (h_out [M, hid] bf16, from
// registers), the tensor the backward reads; serving passes null.
// W1 [hid, dim] and W2 [dim, hid] are torch Linear weights.
//
// What bounds it on the H100: 4*M*dim*hid flops; the [M, hid] hidden would
// be the largest tensor of the block if it went to HBM (4 MB per 1001-token
// volume at hid 2048, written and read back). The point of the TPU kernel
// (fused_mlp.py:10-14) is that it never does, and here neither: a block owns
// 32 rows, keeps u [32, dim] and g [32, hid] as bf16 in shared memory (66 KB
// + 132 KB at dim 1024, hid 2048, with the dynamic-shared-memory opt-in), and
// runs both GEMMs out of it; W1 and W2 stream from L2 through
// nvt::TileGemm's two-stage ring. The hidden never touches HBM. GELU uses
// CUDA's erff, not the TPU kernel's Abramowitz-Stegun polynomial
// (fused_mlp.py:65-79); both are within 1.5e-7 of erf, below bf16
// resolution. Grid: ceil(M/32) blocks of eight warps.
#include "common.cuh"

namespace nvt {
namespace {

constexpr int kBM = 32, kBN = 128, kBK = 32;
using Gemm = TileGemm<kBM, kBN, kBK, 2, 4>;
constexpr float kInvSqrt2 = 0.7071067811865476f;

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * kInvSqrt2));
}

__global__ void __launch_bounds__(Gemm::kThreads)
    mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ y,
               bf16* __restrict__ h_out, int M, int dim, int hid, float eps,
               float inv_keep, uint32_t keep_q, uint64_t seed1,
               uint64_t seed2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldu = dim + kPad, ldg = hid + kPad;
  const size_t u_bytes = round_up(static_cast<size_t>(kBM) * ldu * sizeof(bf16), 128);
  const size_t g_bytes = round_up(static_cast<size_t>(kBM) * ldg * sizeof(bf16), 128);
  bf16* U = reinterpret_cast<bf16*>(smem);
  bf16* G = reinterpret_cast<bf16*>(smem + u_bytes);
  void* scratch = smem + u_bytes + g_bytes;
  const float* C = reinterpret_cast<const float*>(scratch);

  const int row0 = blockIdx.x * kBM;
  layer_norm_rows<kBM, Gemm::kThreads>(x, gamma, beta, U, ldu, row0, M, dim,
                                       eps);

  // g = bf16(GELU(bf16(u W1^T + b1)) * mask1 / keep), tile by tile, into
  // shared memory.
  DropoutBits bits1(seed1), bits2(seed2);
  for (int n0 = 0; n0 < hid; n0 += kBN) {
    Gemm::run(U, ldu, w1, dim, n0, dim, scratch);
    for (int e = threadIdx.x; e < kBM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = row0 + r;
      const size_t hoff = static_cast<size_t>(row) * hid + n0 + c;
      float h[8], g[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        h[i] = __bfloat162float(
            __float2bfloat16(C[r * Gemm::LDC + c + i] + b1[n0 + c + i]));
        g[i] = gelu_erf(h[i]);
        if (keep_q) g[i] *= bits1.keep(hoff + i, keep_q) ? inv_keep : 0.f;
      }
      *reinterpret_cast<uint4*>(G + r * ldg + n0 + c) = pack8(g);
      if (h_out != nullptr && row < M)
        *reinterpret_cast<uint4*>(h_out + hoff) = pack8(h);
    }
  }

  // y = bf16(x + (g W2^T + b2)).
  for (int n0 = 0; n0 < dim; n0 += kBN) {
    Gemm::run(G, ldg, w2, hid, n0, hid, scratch);
    for (int e = threadIdx.x; e < kBM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = row0 + r;
      if (row >= M) continue;
      const size_t off = static_cast<size_t>(row) * dim + n0 + c;
      float xf[8], out[8];
      unpack8(*reinterpret_cast<const uint4*>(x + off), xf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float z = C[r * Gemm::LDC + c + i] + b2[n0 + c + i];
        if (keep_q) z *= bits2.keep(off + i, keep_q) ? inv_keep : 0.f;
        out[i] = z + xf[i];
      }
      *reinterpret_cast<uint4*>(y + off) = pack8(out);
    }
  }
}

size_t smem_bytes(int dim, int hid) {
  return round_up(static_cast<size_t>(kBM) * (dim + kPad) * sizeof(bf16), 128) +
         round_up(static_cast<size_t>(kBM) * (hid + kPad) * sizeof(bf16), 128) +
         Gemm::kScratchBytes;
}

}  // namespace
}  // namespace nvt

// x [M, dim] bf16; gamma, beta [dim] f32; w1 [hid, dim] bf16; b1 [hid] f32;
// w2 [dim, hid] bf16; b2 [dim] f32; y [M, dim] bf16; h [M, hid] bf16 or
// null. dim % 128 == 0, hid % 128 == 0; u and g must fit in shared memory
// (the launch fails with cudaErrorInvalidValue when they do not). keep_q:
// dropout threshold (0 = none); seed1 the hidden site, seed2 the output.
extern "C" int nvt_fused_mlp_fwd(const void* x, const void* gamma,
                                 const void* beta, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* y, void* h, int M,
                                 int dim, int hid, float eps, float inv_keep,
                                 int keep_q, uint64_t seed1, uint64_t seed2,
                                 void* stream) {
  using namespace nvt;
  if (M < 1 || dim % kBN != 0 || hid % kBN != 0 || keep_q < 0 ||
      keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(dim, hid);
  cudaError_t err = allow_smem(mlp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_kernel<<<(M + kBM - 1) / kBM, Gemm::kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(y),
      static_cast<bf16*>(h), M, dim, hid, eps, inv_keep,
      static_cast<uint32_t>(keep_q), seed1, seed2);
  return static_cast<int>(cudaGetLastError());
}
