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
// BM rows, keeps u [BM, dim] and g [BM, hid] as bf16 in shared memory, and
// runs both GEMMs out of it; W1 and W2 stream from L2 through
// nvt::TileGemm's two-stage ring. The hidden never touches HBM. BM is 32
// where that fits the 227 KB a block may have (66 KB + 132 KB at dim 1024,
// hid 2048: the flagship), else 16 (ViT-B's 768 / 3072 and ViT-L's 1024 /
// 4096, 144 KB and 185 KB): the wrapper picks it (ops/fused_mlp.py,
// smem_plan) and refuses a shape that fits neither. GELU uses CUDA's erff,
// not the TPU kernel's Abramowitz-Stegun polynomial (fused_mlp.py:65-79);
// both are within 1.5e-7 of erf, below bf16 resolution. Widths are
// multiples of 16: u's and g's columns past dim and hid are zero up to the
// k tile, and the last column tile of each GEMM is masked. Grid:
// ceil(M/BM) blocks of eight warps.
#include "common.cuh"

namespace nvt {
namespace {

constexpr int kBN = 128, kBK = 32;
template <int BM>
using MlpGemm = TileGemm<BM, kBN, kBK, BM / 16, 8 / (BM / 16)>;

template <int BM>
__global__ void __launch_bounds__(256)
    mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ y,
               bf16* __restrict__ h_out, int M, int dim, int hid, float eps,
               float inv_keep, uint32_t keep_q, uint64_t seed1,
               uint64_t seed2) {
  using Gemm = MlpGemm<BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int dim_k = static_cast<int>(round_up(dim, kBK));
  const int hid_k = static_cast<int>(round_up(hid, kBK));
  const int ldu = dim_k + kPad, ldg = hid_k + kPad;
  const size_t u_bytes = round_up(static_cast<size_t>(BM) * ldu * sizeof(bf16), 128);
  const size_t g_bytes = round_up(static_cast<size_t>(BM) * ldg * sizeof(bf16), 128);
  bf16* U = reinterpret_cast<bf16*>(smem);
  bf16* G = reinterpret_cast<bf16*>(smem + u_bytes);
  void* scratch = smem + u_bytes + g_bytes;
  const float* C = reinterpret_cast<const float*>(scratch);

  const int row0 = blockIdx.x * BM;
  layer_norm_rows<BM, Gemm::kThreads>(x, gamma, beta, U, ldu, row0, M, dim,
                                      eps);
  zero_cols<Gemm::kThreads>(U, ldu, BM, dim, dim_k);

  // g = bf16(GELU(bf16(u W1^T + b1)) * mask1 / keep), tile by tile, into
  // shared memory; zeros past hid.
  DropoutBits bits1(seed1), bits2(seed2);
  for (int n0 = 0; n0 < hid; n0 += kBN) {
    Gemm::run(U, ldu, w1, dim, n0, dim, scratch, hid);
    for (int e = threadIdx.x; e < BM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int col = n0 + c;
      if (col >= hid_k) continue;
      if (col >= hid) {
        *reinterpret_cast<uint4*>(G + r * ldg + col) = make_uint4(0, 0, 0, 0);
        continue;
      }
      const int row = row0 + r;
      const size_t hoff = static_cast<size_t>(row) * hid + col;
      float h[8], g[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        h[i] = __bfloat162float(
            __float2bfloat16(C[r * Gemm::LDC + c + i] + b1[col + i]));
        g[i] = gelu_erf(h[i]);
        if (keep_q) g[i] *= bits1.keep(hoff + i, keep_q) ? inv_keep : 0.f;
      }
      *reinterpret_cast<uint4*>(G + r * ldg + col) = pack8(g);
      if (h_out != nullptr && row < M)
        *reinterpret_cast<uint4*>(h_out + hoff) = pack8(h);
    }
  }

  // y = bf16(x + (g W2^T + b2)).
  for (int n0 = 0; n0 < dim; n0 += kBN) {
    Gemm::run(G, ldg, w2, hid, n0, hid, scratch, dim);
    for (int e = threadIdx.x; e < BM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = row0 + r;
      if (row >= M || n0 + c >= dim) continue;
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

size_t smem_bytes(int rows, int dim, int hid) {
  const size_t scratch = rows == 32 ? MlpGemm<32>::kScratchBytes
                                    : MlpGemm<16>::kScratchBytes;
  return round_up(static_cast<size_t>(rows) * (round_up(dim, kBK) + kPad) *
                      sizeof(bf16),
                  128) +
         round_up(static_cast<size_t>(rows) * (round_up(hid, kBK) + kPad) *
                      sizeof(bf16),
                  128) +
         scratch;
}

template <int BM>
int launch(const void* x, const void* gamma, const void* beta, const void* w1,
           const void* b1, const void* w2, const void* b2, void* y, void* h,
           int M, int dim, int hid, float eps, float inv_keep, int keep_q,
           uint64_t seed1, uint64_t seed2, cudaStream_t stream) {
  const size_t smem = smem_bytes(BM, dim, hid);
  cudaError_t err = allow_smem(mlp_kernel<BM>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_kernel<BM><<<(M + BM - 1) / BM, 256, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(y),
      static_cast<bf16*>(h), M, dim, hid, eps, inv_keep,
      static_cast<uint32_t>(keep_q), seed1, seed2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace nvt

// Shared memory of one block of `rows` (16 or 32) rows at (dim, hid): the
// wrapper's smem_plan must agree (chip_smoke.py and the card tests check).
extern "C" long long nvt_fused_mlp_smem_bytes(int rows, int dim, int hid) {
  return static_cast<long long>(nvt::smem_bytes(rows, dim, hid));
}

// x [M, dim] bf16; gamma, beta [dim] f32; w1 [hid, dim] bf16; b1 [hid] f32;
// w2 [dim, hid] bf16; b2 [dim] f32; y [M, dim] bf16; h [M, hid] bf16 or
// null. dim % 16 == 0, hid % 16 == 0; rows (16 or 32) per block, whose u
// and g must fit in the block's shared memory (the wrapper checks; the
// launch fails otherwise). keep_q: dropout threshold (0 = none); seed1 the
// hidden site, seed2 the output.
extern "C" int nvt_fused_mlp_fwd(const void* x, const void* gamma,
                                 const void* beta, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* y, void* h, int M,
                                 int dim, int hid, int rows, float eps,
                                 float inv_keep, int keep_q, uint64_t seed1,
                                 uint64_t seed2, void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0 ||
      keep_q < 0 || keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows == 32)
    return launch<32>(x, gamma, beta, w1, b1, w2, b2, y, h, M, dim, hid, eps,
                      inv_keep, keep_q, seed1, seed2, s);
  if (rows == 16)
    return launch<16>(x, gamma, beta, w1, b1, w2, b2, y, h, M, dim, hid, eps,
                      inv_keep, keep_q, seed1, seed2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
