// The LayerNorm data-grad backward behind a GEMM at f32, on the tensor
// cores by 3xTF32 on wgmma: the last three passes of K9 at f32
// (fused_mlp_bwd_f32.cu) and of K7 at f32 (fused_qkv_bwd_f32.cu), one
// definition launched by both, as ln_bwd.cuh is for their bf16 instances.
// From A [M, K] f32, the torch weight B [K, N = dim] f32, x [M, dim] f32
// and each row's (mean, rstd), which the caller's earlier pass writes into
// the scratch:
//   du = A . B                                      f32, [M, dim]
//   xhat = (x - mean) * rstd
//   dx = rstd (du gamma - m1 - xhat m2) [+ dy]
//   dgamma = sum_rows(du * xhat), dbeta = sum_rows(du)
// m1 and m2 the row means of du gamma and du gamma xhat. K9 adds its
// residual dy; K7 has none.
//   du:     tf32x3_wgmma.cuh's Loop over ceil(dim / 128) x ceil(M / 128)
//           tiles. The product contracts B's out dimension, so B is
//           MN-major as it lies; wgmma takes TF32 operands K-major only,
//           so the caller's weight pre-pass (split_t_kernel) has written
//           B^T [dim, K] split into big and small. K is hid (K9, 768 TF32
//           products deep at 2048) or 3 inner (K7): each stage sums into a
//           fresh accumulator (kFreshStages 1), added in f32. The epilogue
//           stores du as f32 pairs from registers and, with x's pairs and
//           the row statistics, takes the tile's share of the LayerNorm
//           backward's sums as ln_bwd.cuh's du pass takes them: per row,
//           sum(du gamma) and sum(du gamma xhat) over the tile's 128
//           columns (a thread's 32, then the quad's shuffles); per column,
//           sum(du xhat) and sum(du) over the tile's 128 rows (each
//           thread's two rows into the freed ring, then added over the 64
//           row groups in order). Each part is written once, in a fixed
//           place: no atomics.
//   ln_bwd, colsum: ln_bwd_rows.cuh's f32 instances: one warp a row for
//           dx, the column tiles' parts added in tile order; dgamma and
//           dbeta from the row tiles' parts in a fixed order.
// The LayerNorm backward needs whole rows of du (its row means), so du
// makes one f32 round trip through device memory, as in the bf16 passes.
// du, the row statistics and the partial sums live in one scratch
// allocation (LnScratch; ops/fused_mlp.py, ln_bwd_f32_passes).
//
// Everything here has internal linkage: each including source gets its
// own instances, as every .cu links into one library.
#pragma once

#include "ln_bwd_rows.cuh"
#include "tf32x3_wgmma.cuh"

namespace nvt {
namespace {

// The GEMMs of K7 and K9 at f32: four 48 KiB stages, one block an SM, a
// fresh accumulator a stage.
using BwdLoop = tf32x3_wgmma::Loop<4, 1>;

int ln_col_parts(int dim) {
  return (dim + tf32x3_wgmma::kBN - 1) / tf32x3_wgmma::kBN;
}
int ln_row_parts(int M) {
  return (M + tf32x3_wgmma::kBM - 1) / tf32x3_wgmma::kBM;
}

// Scratch of one call, one allocation, each piece on a 256-byte boundary:
// du [M, dim] f32; the rows' (mean, rstd) [M] float2; the du pass's row
// sums of du gamma then of du gamma xhat, [2, M, ln_col_parts(dim)] f32
// (one part a column tile); its column sums of du xhat (dgamma) then of
// du (dbeta), [2, ln_row_parts(M), dim] f32 (one part a row tile).
struct LnScratch {
  size_t du, stats, rowpart, colpart, bytes;
  LnScratch(int M, int dim) {
    const size_t m = static_cast<size_t>(M);
    du = 0;
    stats = round_up(m * dim * sizeof(float), 256);
    rowpart = round_up(stats + m * sizeof(float2), 256);
    colpart = round_up(rowpart + 2 * m * ln_col_parts(dim) * sizeof(float),
                       256);
    bytes = round_up(colpart + 2 * static_cast<size_t>(ln_row_parts(M)) *
                                   dim * sizeof(float),
                     256);
  }
};

// du = A . B and the tile's LayerNorm-backward parts (see above): rowpart
// [2, M, gridDim.x], colpart [2, gridDim.y, dim]. Thread t of the two
// consumer warpgroups holds rows r0 = 64 (t / 128) + 16 ((t % 128) / 32)
// + (t % 32) / 4 and r0 + 8 at columns 8 j + 2 (t % 4) and + 1, j < 16
// (the wgmma accumulator's layout, Loop::for_each_pair): the quad t / 4
// holds its two rows' 128 columns, the 64 quads the tile's rows.
__global__ void __launch_bounds__(tf32x3_wgmma::kThreads, 1)
    ln_du_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tbig,
                 const __grid_constant__ CUtensorMap tsmall,
                 float* __restrict__ du, const float* __restrict__ x,
                 const float* __restrict__ gamma,
                 const float2* __restrict__ stats,
                 float* __restrict__ rowpart, float* __restrict__ colpart,
                 int M, int dim, int K) {
  using namespace tf32x3_wgmma;
  extern __shared__ unsigned char smem[];
  constexpr int kConsumerThreads = kConsumers * 128;
  constexpr int kGroups = kConsumerThreads / 4, kLd = kBN + 8;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[kAccRegs];
  if (!BwdLoop::run(&ta, &tbig, &tsmall, m0, n0, K, smem, acc)) return;
  // [2][kGroups][kLd] f32 in the ring; the row stride's 8 extra floats put
  // a half warp's float2 stores on 16 different bank pairs.
  float* colbuf = reinterpret_cast<float*>(
      round_up(reinterpret_cast<size_t>(smem), 1024));
  const int quad = threadIdx.x % 4, group = threadIdx.x / 4;
  const int r0 = (threadIdx.x / 128) * 64 + ((threadIdx.x % 128) / 32) * 16 +
                 (threadIdx.x % 32) / 4;
  int row[2];
  float2 st[2];
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    row[half] = m0 + r0 + 8 * half;
    st[half] = row[half] < M ? stats[row[half]] : make_float2(0.f, 0.f);
  }
  hopper::named_barrier(1, kConsumerThreads);   // no wgmma reads it now
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = 8 * j + 2 * quad, col = n0 + c;
    float2 pg = make_float2(0.f, 0.f), pb = make_float2(0.f, 0.f);
    if (col < dim) {   // dim is even: col + 1 < dim too
      const float2 gm = *reinterpret_cast<const float2*>(gamma + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (row[half] >= M) continue;
        const size_t off = static_cast<size_t>(row[half]) * dim + col;
        const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        *reinterpret_cast<float2*>(du + off) = make_float2(v0, v1);
        const float2 xf = *reinterpret_cast<const float2*>(x + off);
        const float xh0 = __fmul_rn(xf.x - st[half].x, st[half].y);
        const float xh1 = __fmul_rn(xf.y - st[half].x, st[half].y);
        const float d0 = v0 * gm.x, d1 = v1 * gm.y;
        s1[half] += d0;
        s1[half] += d1;
        s2[half] += d0 * xh0;
        s2[half] += d1 * xh1;
        pg.x += v0 * xh0;
        pg.y += v1 * xh1;
        pb.x += v0;
        pb.y += v1;
      }
    }
    *reinterpret_cast<float2*>(colbuf + group * kLd + c) = pg;
    *reinterpret_cast<float2*>(colbuf + (kGroups + group) * kLd + c) = pb;
  }
  // The row parts: the quad's four threads hold the row's columns.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s1[half] += __shfl_xor_sync(0xffffffffu, s1[half], o);
      s2[half] += __shfl_xor_sync(0xffffffffu, s2[half], o);
    }
    if (quad == 0 && row[half] < M) {
      const size_t at_row =
          static_cast<size_t>(row[half]) * gridDim.x + blockIdx.x;
      rowpart[at_row] = s1[half];
      rowpart[static_cast<size_t>(M) * gridDim.x + at_row] = s2[half];
    }
  }
  hopper::named_barrier(1, kConsumerThreads);
  // The column parts: thread i adds column i % 128 of dgamma's (i < 128)
  // or dbeta's partials over the 64 row groups in order.
  for (int i = threadIdx.x; i < 2 * kBN; i += kConsumerThreads) {
    const int which = i / kBN, c = i % kBN;
    if (n0 + c >= dim) continue;
    const float* p = colbuf + which * kGroups * kLd + c;
    float sum = 0.f;
    for (int g = 0; g < kGroups; ++g) sum += p[g * kLd];
    colpart[(static_cast<size_t>(which) * gridDim.y + blockIdx.y) * dim +
            n0 + c] = sum;
  }
}

// The du pass's maps: ta of A [M, K] (kBM-row boxes), tbig and tsmall of
// B^T's big and small [dim, K] (kBN-row boxes); and ln_du_kernel allowed
// its ring. Called before a call's first launch, so that a failure leaves
// nothing half done.
cudaError_t prepare_ln_du(CUtensorMap* ta, CUtensorMap* tbig,
                          CUtensorMap* tsmall, const float* A,
                          const float* bt_big, const float* bt_small, int M,
                          int dim, int K) {
  using namespace tf32x3_wgmma;
  cudaError_t err = encode_kmajor_f32(ta, A, M, K, kBM);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(tbig, bt_big, dim, K, kBN);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(tsmall, bt_small, dim, K, kBN);
  if (err == cudaSuccess) err = allow_smem(ln_du_kernel, BwdLoop::kSmemBytes);
  return err;
}

// The three passes on `stream`, after the caller's pass has written the
// rows' statistics into the scratch (LnScratch(M, dim) bytes), with the
// maps of prepare_ln_du; dy null for no residual.
cudaError_t launch_ln_bwd_f32(const CUtensorMap& ta, const CUtensorMap& tbig,
                              const CUtensorMap& tsmall, const float* x,
                              const float* gamma, const float* dy, float* dx,
                              float* dgamma, float* dbeta,
                              unsigned char* scratch, int M, int dim, int K,
                              cudaStream_t stream) {
  using namespace tf32x3_wgmma;
  const LnScratch at(M, dim);
  float* du = reinterpret_cast<float*>(scratch + at.du);
  const float2* stats = reinterpret_cast<const float2*>(scratch + at.stats);
  float* rowpart = reinterpret_cast<float*>(scratch + at.rowpart);
  float* colpart = reinterpret_cast<float*>(scratch + at.colpart);
  ln_du_kernel<<<dim3(ln_col_parts(dim), ln_row_parts(M)), kThreads,
                 BwdLoop::kSmemBytes, stream>>>(ta, tbig, tsmall, du, x, gamma,
                                                stats, rowpart, colpart, M,
                                                dim, K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_ln_bwd_rows(x, du, gamma, stats, rowpart, colpart, dy, dx,
                            dgamma, dbeta, M, dim, ln_col_parts(dim),
                            ln_row_parts(M), stream);
}

}  // namespace
}  // namespace nvt
