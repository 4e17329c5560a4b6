// int8 residual MLP block (K12), serving only.
//
// Replaces the TPU kernel neurovit_tpu/ops/int8_serving.py:173
// (_mlp_kernel, launched at :263 by int8_mlp_block):
//   u = LN(x) * gamma + beta                 f32, not rounded
//   (u8, s1_row) = rowquant(u)
//   h = float(u8 . W1^T) * s1_row * s1_col + b1     f32, not rounded
//   g = GELU(h)                              exact-erf GELU in f32
//   (g8, s2_row) = rowquant(g)               amax over the whole hid row
//   z = float(g8 . W2^T) * s2_row * s2_col + b2
//   y = bf16(z + x)
// W1 [hid, dim] and W2 [dim, hid] are torch-layout int8 weights with
// per-output-channel scales s1_col [hid] and s2_col [dim].
//
// What bounds it on the H100: 4*M*dim*hid int8 operations, compute-bound
// on the int8 tensor cores. The hard part is the second rowquant: it needs
// the amax of g over all hid (2048) columns before any column of g can be
// quantized, and the f32 g of a row block does not fit beside the GEMM
// tiles in shared memory (64 rows x 2048 x 4 bytes = 512 KB; K4 keeps g as
// bf16, which this scheme must not round to). This kernel makes one f32
// round trip of g through device memory instead, as K7 and K9 do with du:
// a block owns 32 rows; the GEMM1 epilogue writes each tile's g to the
// scratch gbuf [M, hid] and folds |g| into a per-row amax in shared memory
// (atomicMax on the bit pattern of a non-negative float, exact and
// order-free); once the last tile is done, the block reads its own rows
// back (mostly from L2), quantizes them into int8 codes in shared memory
// where u's codes were, and runs GEMM2 from there. The round trip costs 8
// bytes per hidden element against the 2*dim int8 operations that made
// it; a second pass over GEMM1 for the amax alone would cost 50 % more
// operations instead. Grid: ceil(M/32) blocks of eight warps. Widths are
// multiples of 16 (dim <= 1024; hid has no bound but shared memory's, 32 x
// hid bytes of codes: ViT-L's 4096 takes 146 KB in all): codes past dim and
// hid are 0 up to the k tile, and the last column tile of each GEMM is
// masked.
#include "int8.cuh"

namespace nvt {
namespace {

constexpr int kBM = 32, kBN = 128, kBK = 64;
using Gemm = TileGemmI8<kBM, kBN, kBK, 2, 4>;

__global__ void __launch_bounds__(Gemm::kThreads)
    int8_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const int8_t* __restrict__ w1,
                    const float* __restrict__ s1_col,
                    const float* __restrict__ b1,
                    const int8_t* __restrict__ w2,
                    const float* __restrict__ s2_col,
                    const float* __restrict__ b2, bf16* __restrict__ y,
                    float* __restrict__ gbuf, int M, int dim, int hid,
                    float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dim_k = static_cast<int>(round_up(dim, kBK));
  const int hid_k = static_cast<int>(round_up(hid, kBK));
  const int width = dim_k > hid_k ? dim_k : hid_k;
  const size_t q_bytes = round_up(static_cast<size_t>(kBM) * width, 128);
  // Q8 holds u's codes for GEMM1, then g's codes for GEMM2.
  int8_t* Q8 = reinterpret_cast<int8_t*>(smem);
  float* s1_row = reinterpret_cast<float*>(smem + q_bytes);
  float* s2_row = s1_row + kBM;
  int* amax_bits = reinterpret_cast<int*>(s2_row + kBM);
  void* scratch = smem + q_bytes + round_up(3 * kBM * sizeof(float), 128);
  const int* C = reinterpret_cast<const int*>(scratch);

  const int row0 = blockIdx.x * kBM;
  if (threadIdx.x < kBM) amax_bits[threadIdx.x] = 0;
  rowquant_rows<kBM, Gemm::kThreads, true>(x, gamma, beta, Q8, s1_row, row0,
                                           M, dim, dim_k, eps);

  // g = GELU(h), tile by tile, to gbuf; its per-row amax into amax_bits.
  for (int n0 = 0; n0 < hid; n0 += kBN) {
    Gemm::run(Q8, w1, dim, n0, dim, scratch, hid);
    for (int e = threadIdx.x; e < kBM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = row0 + r;
      if (row >= M || n0 + c >= hid) continue;
      float g[8];
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float h = __fadd_rn(
            dequant(C[r * Gemm::LDC + c + i], s1_row[r], s1_col[n0 + c + i]),
            b1[n0 + c + i]);
        g[i] = gelu_erf(h);
        m = fmaxf(m, fabsf(g[i]));
      }
      atomicMax(amax_bits + r, __float_as_int(m));
      float4* dst = reinterpret_cast<float4*>(
          gbuf + static_cast<size_t>(row) * hid + n0 + c);
      dst[0] = make_float4(g[0], g[1], g[2], g[3]);
      dst[1] = make_float4(g[4], g[5], g[6], g[7]);
    }
  }
  // The block's gbuf writes and amax are visible to all its threads.
  __syncthreads();

  // (g8, s2_row) = rowquant(g): one warp per row, reading the row back.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += Gemm::kThreads / 32) {
    const int row = row0 + r;
    const float scale = quant_scale(__int_as_float(amax_bits[r]));
    if (lane == 0) s2_row[r] = scale;
    for (int c = lane * 8; c < hid_k; c += 256) {
      int codes[8] = {};
      if (row < M && c < hid) {
        const float4* src = reinterpret_cast<const float4*>(
            gbuf + static_cast<size_t>(row) * hid + c);
        const float4 lo = src[0], hi = src[1];
        const float g[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) codes[i] = quant_code(g[i], scale, -127.f);
      }
      *reinterpret_cast<uint2*>(Q8 + chunked(r, c, kBM)) = pack_codes(codes);
    }
  }

  // y = bf16(x + (g8 . W2^T) * s2_row * s2_col + b2).
  for (int n0 = 0; n0 < dim; n0 += kBN) {
    Gemm::run(Q8, w2, hid, n0, hid, scratch, dim);
    for (int e = threadIdx.x; e < kBM * kBN / 8; e += Gemm::kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = row0 + r;
      if (row >= M || n0 + c >= dim) continue;
      const size_t off = static_cast<size_t>(row) * dim + n0 + c;
      float xf[8], out[8];
      unpack8(*reinterpret_cast<const uint4*>(x + off), xf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float z = __fadd_rn(
            dequant(C[r * Gemm::LDC + c + i], s2_row[r], s2_col[n0 + c + i]),
            b2[n0 + c + i]);
        out[i] = __fadd_rn(z, xf[i]);
      }
      *reinterpret_cast<uint4*>(y + off) = pack8(out);
    }
  }
}

size_t smem_bytes(int dim, int hid) {
  const int width = static_cast<int>(round_up(dim > hid ? dim : hid, kBK));
  return round_up(static_cast<size_t>(kBM) * width, 128) +
         round_up(3 * kBM * sizeof(float), 128) + Gemm::kScratchBytes;
}

}  // namespace
}  // namespace nvt

// x [M, dim] bf16; gamma, beta [dim] f32; w1 [hid, dim] int8; s1, b1 [hid]
// f32; w2 [dim, hid] int8; s2, b2 [dim] f32; y [M, dim] bf16; gbuf [M, hid]
// f32 scratch. dim % 16 == 0, dim <= 1024, hid % 16 == 0; the codes of a
// 32-row block must fit in shared memory (the launch fails with
// cudaErrorInvalidValue when they do not).
extern "C" int nvt_int8_mlp(const void* x, const void* gamma, const void* beta,
                            const void* w1, const void* s1, const void* b1,
                            const void* w2, const void* s2, const void* b2,
                            void* y, void* gbuf, int M, int dim, int hid,
                            float eps, void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || dim > 1024 || hid < 16 ||
      hid % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(dim, hid);
  cudaError_t err = allow_smem(int8_mlp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_mlp_kernel<<<(M + kBM - 1) / kBM, Gemm::kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<bf16*>(y),
      static_cast<float*>(gbuf), M, dim, hid, eps);
  return static_cast<int>(cudaGetLastError());
}
