// The LayerNorm data-grad backward behind a GEMM, on TMA + wgmma: the last
// three passes of the MLP backward (fused_mlp_bwd.cu, K9) and of the LN +
// QKV backward (fused_qkv_bwd.cu, K7), one definition launched by both.
// From A [M, K] bf16, the torch weight B [K, N = dim] bf16, x [M, dim] bf16
// and each row's (mean, rstd), which the caller's earlier pass writes into
// the scratch:
//   du = A . B                                      f32, [M, dim]
//   xhat = (x - mean) * rstd
//   dx = bf16(rstd (du gamma - m1 - xhat m2) [+ dy])
//   dgamma = sum_rows(du * xhat), dbeta = sum_rows(du)
// m1 and m2 the row means of du gamma and du gamma xhat. K9 adds its
// residual dy; K7 has none.
//   du:     fused_mlp.cuh Loop<BN, true> over ceil(dim / BN) x ceil(M /
//           128) tiles, B read as it lies (MN-major for this product). The
//           epilogue stores du as f32 pairs from registers (a quad writes
//           32 contiguous bytes) and, with x's pairs and the row
//           statistics, takes the tile's share of the LayerNorm backward's
//           sums: per row, sum(du gamma) and sum(du gamma xhat) over its
//           columns (a quad's shuffles); per column, sum(du xhat) and
//           sum(du) over its rows (each thread's two rows into the freed
//           ring, then added over the 64 row groups in order).
//   ln_bwd, colsum: ln_bwd_rows.cuh's bf16 instances (the f32 backwards
//           launch its f32 ones): one warp a row for dx, its two sums from
//           the du pass's column tiles in tile order; dgamma and dbeta from
//           its row tiles in a fixed order, no atomics.
// The LayerNorm backward needs whole rows of du (its row means), and a
// block that feeds wgmma from a TMA ring has no room for a row block's f32
// du, so du makes one f32 round trip through device memory. du, the row
// statistics and the partial sums live in one scratch allocation
// (Scratch; ops/fused_mlp.py, ln_bwd_passes).
//
// Everything here has internal linkage: each including source gets its
// own instances, as every .cu links into one library.
#pragma once

#include "fused_mlp.cuh"
#include "ln_bwd_rows.cuh"

namespace nvt {
namespace {

using namespace mlp;

int row_tiles(int M) { return (M + kBM - 1) / kBM; }

// Scratch of one call, one allocation, each piece on a 256-byte boundary:
// du [M, dim] f32; the rows' (mean, rstd) [M] float2; the du pass's row
// partials of sum(du gamma) then sum(du gamma xhat), [2, M, col_tiles]
// f32 (col_tiles = its grid's x); its column partials of dgamma then
// dbeta, [2, row_tiles(M), dim] f32.
struct Scratch {
  size_t du, stats, rowpart, colpart, bytes;
  Scratch(int M, int dim) {
    const size_t m = static_cast<size_t>(M);
    const int bn = tile_n(M, dim);
    du = 0;
    stats = round_up(m * dim * sizeof(float), 256);
    rowpart = round_up(stats + m * sizeof(float2), 256);
    colpart = round_up(
        rowpart + 2 * m * ((dim + bn - 1) / bn) * sizeof(float), 256);
    bytes = round_up(colpart + 2 * static_cast<size_t>(row_tiles(M)) * dim *
                                   sizeof(float),
                     256);
  }
};

// du = A . B, f32, stored from registers; from the same registers, with x
// and the row statistics, the tile's share of the LayerNorm backward's
// sums: per row, sum(du gamma) and sum(du gamma xhat) over the tile's
// columns (rowpart, [2, M, gridDim.x]); per column, sum(du xhat) and
// sum(du) over the tile's rows (colpart, [2, gridDim.y, dim]), through the
// freed ring: thread t's two rows are row group t / 4, whose column
// partials the threads add over the 64 groups in order.
template <int BN>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
    du_kernel(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb, float* __restrict__ du,
              const bf16* __restrict__ x, const float* __restrict__ gamma,
              const float2* __restrict__ stats, float* __restrict__ rowpart,
              float* __restrict__ colpart, int M, int dim, int K) {
  extern __shared__ unsigned char smem[];
  constexpr int kGroups = kConsumerThreads / 4, kLd = BN + 8;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  float acc[Loop<BN, true>::kAccRegs];
  if (!Loop<BN, true>::run(&ta, &tb, m0, n0, K, smem, acc)) return;
  const Place at;
  // [2][kGroups][kLd] f32 in the ring; the row stride's 8 extra floats put
  // a half warp's float2 stores on 16 different bank pairs.
  float* colbuf = reinterpret_cast<float*>(
      round_up(reinterpret_cast<size_t>(smem), 1024));
  const int group = threadIdx.x / 4;
  int row[2];
  float2 st[2];
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    row[half] = m0 + at.r0 + 8 * half;
    st[half] = row[half] < M ? stats[row[half]] : make_float2(0.f, 0.f);
  }
  hopper::named_barrier(1, kConsumerThreads);   // no wgmma reads it now
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * at.quad, col = n0 + c;
    float2 pg = make_float2(0.f, 0.f), pb = make_float2(0.f, 0.f);
    if (col < dim) {   // dim is even: col + 1 < dim too
      const float2 gm = *reinterpret_cast<const float2*>(gamma + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (row[half] >= M) continue;
        const size_t off = static_cast<size_t>(row[half]) * dim + col;
        const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        *reinterpret_cast<float2*>(du + off) = make_float2(v0, v1);
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + off));
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
  // The row partials: the quad's four threads hold the row's columns.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s1[half] += __shfl_xor_sync(0xffffffffu, s1[half], o);
      s2[half] += __shfl_xor_sync(0xffffffffu, s2[half], o);
    }
    if (at.quad == 0 && row[half] < M) {
      const size_t at_row =
          static_cast<size_t>(row[half]) * gridDim.x + blockIdx.x;
      rowpart[at_row] = s1[half];
      rowpart[static_cast<size_t>(M) * gridDim.x + at_row] = s2[half];
    }
  }
  hopper::named_barrier(1, kConsumerThreads);
  for (int i = threadIdx.x; i < 2 * BN; i += kConsumerThreads) {
    const int which = i / BN, c = i % BN;
    if (n0 + c >= dim) continue;
    const float* p = colbuf + which * kGroups * kLd + c;
    float sum = 0.f;
    for (int g = 0; g < kGroups; ++g) sum += p[g * kLd];
    colpart[(static_cast<size_t>(which) * gridDim.y + blockIdx.y) * dim +
            n0 + c] = sum;
  }
}

// Let both du instances take their ring: called, with every tensor map
// encoded, before a call's first launch.
cudaError_t allow_du_smem() {
  cudaError_t err = allow_smem(du_kernel<64>, Loop<64, true>::kSmemBytes);
  return err == cudaSuccess
             ? allow_smem(du_kernel<128>, Loop<128, true>::kSmemBytes)
             : err;
}

template <int BN>
void launch_du(const CUtensorMap& ta, const CUtensorMap& tb, float* du,
               const bf16* x, const float* gamma, const float2* stats,
               float* rowpart, float* colpart, int M, int dim, int K,
               cudaStream_t stream) {
  du_kernel<BN><<<dim3((dim + BN - 1) / BN, row_tiles(M)), kThreads,
                  Loop<BN, true>::kSmemBytes, stream>>>(
      ta, tb, du, x, gamma, stats, rowpart, colpart, M, dim, K);
}

// The three passes on `stream`, after the caller's pass has written the
// rows' statistics into the scratch: ta the map of A [M, K]
// (hopper::encode_kmajor, kBM-row boxes), tb that of B [K, dim]
// (hopper::encode_mnmajor); dy null for no residual; dx bf16, or f32 for a
// tensor-parallel shard's partial.
template <typename TO>
cudaError_t launch_ln_bwd(const CUtensorMap& ta, const CUtensorMap& tb,
                          const bf16* x, const float* gamma, const bf16* dy,
                          TO* dx, float* dgamma, float* dbeta,
                          unsigned char* scratch, int M, int dim, int K,
                          cudaStream_t stream) {
  const Scratch at(M, dim);
  float* du = reinterpret_cast<float*>(scratch + at.du);
  const float2* stats = reinterpret_cast<const float2*>(scratch + at.stats);
  float* rowpart = reinterpret_cast<float*>(scratch + at.rowpart);
  float* colpart = reinterpret_cast<float*>(scratch + at.colpart);
  const int bn = tile_n(M, dim);
  (bn == 64 ? launch_du<64> : launch_du<128>)(ta, tb, du, x, gamma, stats,
                                              rowpart, colpart, M, dim, K,
                                              stream);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_ln_bwd_rows(x, du, gamma, stats, rowpart, colpart, dy, dx,
                            dgamma, dbeta, M, dim, (dim + bn - 1) / bn,
                            row_tiles(M), stream);
}

}  // namespace
}  // namespace nvt
