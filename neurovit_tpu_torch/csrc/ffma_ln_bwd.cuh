// The LayerNorm data-grad backward behind a GEMM at f32, on the CUDA cores:
// the last three passes of K9 at f32 (fused_mlp_bwd_f32.cu) and of K7 at
// f32 (fused_qkv_bwd_f32.cu), one definition launched by both, as
// ln_bwd.cuh is for their bf16 instances. From A [M, K] f32, the torch
// weight B [K, N = dim] f32 as it lies, x [M, dim] f32 and each row's
// (mean, rstd), which the caller's earlier pass writes into the scratch:
//   du = A . B                                      f32, [M, dim]
//   xhat = (x - mean) * rstd
//   dx = rstd (du gamma - m1 - xhat m2) [+ dy]
//   dgamma = sum_rows(du * xhat), dbeta = sum_rows(du)
// m1 and m2 the row means of du gamma and du gamma xhat. K9 adds its
// residual dy; K7 has none.
//   du:     ffma.cuh's mainloop (tile_products<true>: B [K, N] staged as it
//           lies) over ceil(dim / 128) x ceil(M / 128) tiles. The epilogue
//           stores du as float4s from registers and, with x and the row
//           statistics, takes the tile's share of the LayerNorm backward's
//           sums in two sweeps over the accumulators: per row, sum(du
//           gamma) and sum(du gamma xhat) over a warp's 64 columns (a
//           thread's 8, then the 8 lanes of the row by shuffles), one
//           column part per half tile; per column, sum(du xhat) and
//           sum(du) over a warp's 32 rows (a thread's 8, then the 4 lanes
//           of the column), one row part per quarter tile. Each part is
//           written once, in a fixed place: no atomics.
//   ln_bwd, colsum: ln_bwd_rows.cuh's f32 instances: one warp a row for
//           dx, the column parts added in part order; dgamma and dbeta
//           from the row parts in a fixed order.
// The LayerNorm backward needs whole rows of du (its row means), so du
// makes one f32 round trip through device memory, as in the bf16 passes.
// du, the row statistics and the partial sums live in one scratch
// allocation (LnScratch; ops/fused_mlp.py, ln_bwd_f32_passes).
//
// Everything here has internal linkage: each including source gets its
// own instances, as every .cu links into one library.
#pragma once

#include "ffma.cuh"
#include "ln_bwd_rows.cuh"

namespace nvt {
namespace {

// The du pass's parts: two column parts a column tile (a warp's 64
// columns each), four row parts a row tile (a warp's 32 rows each).
int ln_col_parts(int dim) { return 2 * ((dim + ffma::kTile - 1) / ffma::kTile); }
int ln_row_parts(int M) { return 4 * ((M + ffma::kTile - 1) / ffma::kTile); }

// Scratch of one call, one allocation, each piece on a 256-byte boundary:
// du [M, dim] f32; the rows' (mean, rstd) [M] float2; the du pass's row
// sums of du gamma then of du gamma xhat, [2, M, ln_col_parts(dim)] f32;
// its column sums of du xhat (dgamma) then of du (dbeta), [2,
// ln_row_parts(M), dim] f32.
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

// du = A . B and the tile's LayerNorm-backward parts (see above). rowpart
// [2, M, 2 gridDim.x], colpart [2, 4 gridDim.y, dim].
__global__ void __launch_bounds__(ffma::kThreads, 2)
    ln_du_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ du, const float* __restrict__ x,
                 const float* __restrict__ gamma,
                 const float2* __restrict__ stats,
                 float* __restrict__ rowpart, float* __restrict__ colpart,
                 int M, int dim, int K) {
  using namespace ffma;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int2 o = warp_tile_origin();
  const int rb = o.x, cb = o.y;
  float acc[kTM][kTN];
  tile_products<true>(A, B, M, dim, K, m0, n0, rb, cb, smem, acc);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  // Sweep 1: du stored; per row, the sums over the warp's 64 columns.
  const int col_parts = 2 * gridDim.x;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + rb + (i & 3) + 16 * (i >> 2);
    float s1 = 0.f, s2 = 0.f;
    if (row < M) {
      const float2 st = stats[row];
#pragma unroll
      for (int j4 = 0; j4 < kTN / 4; ++j4) {
        const int col = n0 + cb + 32 * j4;
        if (col >= dim) continue;
        const size_t at = static_cast<size_t>(row) * dim + col;
        const float4 v = make_float4(acc[i][4 * j4], acc[i][4 * j4 + 1],
                                     acc[i][4 * j4 + 2], acc[i][4 * j4 + 3]);
        *reinterpret_cast<float4*>(du + at) = v;
        const float4 xv = *reinterpret_cast<const float4*>(x + at);
        const float4 g = *reinterpret_cast<const float4*>(gamma + col);
        const float vs[4] = {v.x, v.y, v.z, v.w};
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
        const float gs[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = vs[e] * gs[e];
          s1 += d;
          s2 += d * __fmul_rn(xs[e] - st.x, st.y);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {   // the row's 8 lanes
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if ((l & 7) == 0 && row < M) {
      const size_t at =
          static_cast<size_t>(row) * col_parts + 2 * blockIdx.x + (w >> 2);
      rowpart[at] = s1;
      rowpart[static_cast<size_t>(M) * col_parts + at] = s2;
    }
  }
  // Sweep 2: per column, the sums over the warp's 32 rows.
  const int row_parts = 4 * gridDim.y;
  const size_t part = 4 * blockIdx.y + (w & 3);
#pragma unroll
  for (int j4 = 0; j4 < kTN / 4; ++j4) {
    const int col = n0 + cb + 32 * j4;
    float pg[4] = {0.f, 0.f, 0.f, 0.f}, pb[4] = {0.f, 0.f, 0.f, 0.f};
    if (col < dim) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int row = m0 + rb + (i & 3) + 16 * (i >> 2);
        if (row >= M) continue;
        const float2 st = stats[row];
        const float4 xv = *reinterpret_cast<const float4*>(
            x + static_cast<size_t>(row) * dim + col);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = acc[i][4 * j4 + e];
          pg[e] += v * __fmul_rn(xs[e] - st.x, st.y);
          pb[e] += v;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int off = 8; off < 32; off <<= 1) {   // the column's 4 lanes
        pg[e] += __shfl_xor_sync(0xffffffffu, pg[e], off);
        pb[e] += __shfl_xor_sync(0xffffffffu, pb[e], off);
      }
    if (l < 8 && col < dim) {
      float* g = colpart + part * dim + col;
      float* b = colpart + (row_parts + part) * dim + col;
      *reinterpret_cast<float4*>(g) = make_float4(pg[0], pg[1], pg[2], pg[3]);
      *reinterpret_cast<float4*>(b) = make_float4(pb[0], pb[1], pb[2], pb[3]);
    }
  }
}

// The three passes on `stream`, after the caller's pass has written the
// rows' statistics into the scratch (LnScratch(M, dim) bytes): A [M, K], B
// [K, dim] f32; dy null for no residual.
cudaError_t launch_ln_bwd_f32(const float* A, const float* B, const float* x,
                              const float* gamma, const float* dy, float* dx,
                              float* dgamma, float* dbeta,
                              unsigned char* scratch, int M, int dim, int K,
                              cudaStream_t stream) {
  const LnScratch at(M, dim);
  float* du = reinterpret_cast<float*>(scratch + at.du);
  const float2* stats = reinterpret_cast<const float2*>(scratch + at.stats);
  float* rowpart = reinterpret_cast<float*>(scratch + at.rowpart);
  float* colpart = reinterpret_cast<float*>(scratch + at.colpart);
  cudaError_t err = allow_smem(ln_du_kernel, ffma::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((dim + ffma::kTile - 1) / ffma::kTile,
                  (M + ffma::kTile - 1) / ffma::kTile);
  ln_du_kernel<<<grid, ffma::kThreads, ffma::kSmemBytes, stream>>>(
      A, B, du, x, gamma, stats, rowpart, colpart, M, dim, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_ln_bwd_rows(x, du, gamma, stats, rowpart, colpart, dy, dx,
                            dgamma, dbeta, M, dim, ln_col_parts(dim),
                            ln_row_parts(M), stream);
}

}  // namespace
}  // namespace nvt
