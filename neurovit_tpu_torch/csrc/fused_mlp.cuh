// Pieces the bf16 residual MLP's forward (fused_mlp.cu, K4) and its
// data-grad backward (fused_mlp_bwd.cu, K9) share on TMA + wgmma: the GEMM
// passes' tile and ring (hopper_gemm.cuh Mainloop), the rule that picks a
// pass's tile width, a LayerNorm row and its statistics in one warp, a
// thread's place in the accumulator tile, the quad's shared dropout bits in
// that layout, and the swizzled staging of a bf16 output tile in the freed
// ring (store_tile). The LN + QKV forward (fused_qkv.cu, K2) launches K4's
// LN rows pass (launch_ln_rows) and uses its GEMM tiles; the out-projection
// (K3, fused_outproj.cu) is K4's last pass (launch_fc2_residual); the LN +
// QKV backward (fused_qkv_bwd.cu, K7) shares the statistics and, through
// ln_bwd.cuh, K9's last three passes; the out-projection backward
// (fused_outproj_bwd.cu, K8) launches K9's dz rows pass without the
// LayerNorm (launch_dz_rows) and its GEMM on K9's MN-major B tiles.
#pragma once

#include "hopper_gemm.cuh"

namespace nvt {
namespace mlp {

constexpr int kRowWarps = 8;             // rows a block of a row pass
constexpr int kBM = 128;                 // the GEMMs' output tile rows
constexpr int kStages = 3;
// kBMn: B MN-major, the torch weight as it lies in K9's products.
template <int BN, bool kBMn = false>
using Loop = hopper::Mainloop<false, kBM, BN, kStages, kBMn>;
constexpr int kThreads = Loop<128>::kThreads;   // either width: 288
constexpr int kConsumerThreads = kThreads - 32;
// Two GEMM blocks an SM: at most 65536 / (2 * 288) registers a thread.
constexpr int kGemmBlocksPerSm = 2;
constexpr int kSms = 132;                // the H100 SXM's

// The output tile's columns in the GEMM pass with an [M, N] output: 128,
// or 64 where 128-wide tiles would give the card fewer blocks than SMs.
inline int tile_n(int M, int N) {
  return ((N + 127) / 128) * ((M + kBM - 1) / kBM) < kSms ? 64 : 128;
}

// Dynamic shared memory of a GEMM block of that pass (either B mode).
inline size_t gemm_smem_bytes(int M, int N) {
  return tile_n(M, N) == 64 ? Loop<64>::kSmemBytes : Loop<128>::kSmemBytes;
}

// One warp's LayerNorm statistics of the row xr, (mean, rstd) to every
// lane, with the JAX kernels' order of operations
// (neurovit_tpu/ops/fused_qkv.py:48-63): the mean, then the mean of
// squared deviations, rsqrt(var + eps). Lane l takes columns 256 i + 8 l
// .. + 7, and the row is read again from L1 / L2 for the second statistic,
// so any dim that is a multiple of 8 is taken. K2's and K4's u and K9's
// rows (ln_row) and K7's row_stats pass share it, so K7's xhat has the
// forward's statistics bit for bit.
__device__ __forceinline__ float2 ln_stats(const bf16* __restrict__ xr,
                                           int dim, float eps) {
  const int lane = threadIdx.x % 32;
  float f[8];
  float s = 0.f;
  for (int c = lane * 8; c < dim; c += 256) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mean = warp_sum(s) / dim;
  float ss = 0.f;
  for (int c = lane * 8; c < dim; c += 256) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = f[i] - mean;
      ss += d * d;
    }
  }
  return make_float2(mean, rsqrtf(warp_sum(ss) / dim + eps));
}

// One warp's LayerNorm of the row xr: ur = bf16(LN(xr) * gamma + beta),
// the statistics by ln_stats, then a third sweep over the row. Returns
// (mean, rstd) to every lane.
__device__ __forceinline__ float2 ln_row(const bf16* __restrict__ xr,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         bf16* __restrict__ ur, int dim,
                                         float eps) {
  const int lane = threadIdx.x % 32;
  const float2 st = ln_stats(xr, dim, eps);
  const float mean = st.x, rstd = st.y;
  float f[8];
  for (int c = lane * 8; c < dim; c += 256) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
    const float4 g0 = *reinterpret_cast<const float4*>(gamma + c);
    const float4 g1 = *reinterpret_cast<const float4*>(gamma + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(beta + c);
    const float4 b1 = *reinterpret_cast<const float4*>(beta + c + 4);
    const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xhat = __fmul_rn(f[i] - mean, rstd);
      f[i] = __fadd_rn(__fmul_rn(xhat, gm[i]), bt[i]);
    }
    *reinterpret_cast<uint4*>(ur + c) = pack8(f);
  }
  return st;
}

// K4's pass 1, which K2 launches too (fused_mlp.cu): u = bf16(LN(x) *
// gamma + beta) for x [M, dim], one warp (ln_row) a row, kRowWarps rows a
// block, on the stream. Returns the launch's error.
cudaError_t launch_ln_rows(const bf16* x, const float* gamma,
                           const float* beta, bf16* u, int M, int dim,
                           float eps, cudaStream_t stream);

// K9's pass 1, which K8 launches too (fused_mlp.cu), one warp a row,
// kRowWarps rows a block, on the stream:
//   dz = bf16(dy * mask / keep)         dy, dz [M, dim] bf16
// the mask nn.keep_mask's bits at row * dim + col under seed (keep_q 0:
// none). Lane l takes columns 512 i + 16 l .. + 15 of the row, byte e of
// Philox block (row * dim + col) / 16. With x non-null (K9) the row's
// LayerNorm too, as ln_row: u = bf16(LN(x) * gamma + beta) and (mean,
// rstd) into stats [M]; with x null (K8) gamma, beta, u and stats are not
// touched. Returns the launch's error.
cudaError_t launch_dz_rows(const bf16* dy, const bf16* x, const float* gamma,
                           const float* beta, bf16* dz, bf16* u,
                           float2* stats, int M, int dim, float eps,
                           float inv_keep, uint32_t keep_q, uint64_t seed,
                           cudaStream_t stream);

// K4's pass 3, which K3 launches too (fused_mlp.cu):
//   y = bf16(x + (g . Bt^T + b) * mask / keep)
// for g [M, K] and Bt [N, K] bf16 through the maps tg (boxes of kBM rows)
// and tb (boxes of bn rows, bn 64 or 128); b [N] f32; x and y [M, N] bf16,
// N a multiple of 16. The mask of element (row, col) is nn.keep_mask's bit
// at row * N + col under seed (QuadKeep); keep_q 0 turns it off. Loop<bn>
// over (ceil(N / bn), ceil(M / kBM)) tiles on the stream; the epilogue
// stores bf16 pairs from registers. allow_fc2_residual_smem() opts both
// instances into their shared memory; call it before the first launch of
// a call. Each returns the CUDA error.
cudaError_t allow_fc2_residual_smem();
cudaError_t launch_fc2_residual(const CUtensorMap& tg, const CUtensorMap& tb,
                                const float* b, const bf16* x, bf16* y, int M,
                                int N, int K, float inv_keep, uint32_t keep_q,
                                uint64_t seed, int bn, cudaStream_t stream);

// The same pass's tensor-parallel form, for a row-parallel shard of the
// product (K = the shard's share of the contraction):
//   y = (g . Bt^T [+ b]) * mask / keep [+ x]      f32, not rounded
// with b and x null on every shard but the model group's first, so that
// the f32 sum of the shards' y is the whole pass before its rounding. The
// mask is the whole pass's, at the same (row, col): one key across the
// model group. allow_fc2_partial_smem() opts both instances in.
cudaError_t allow_fc2_partial_smem();
cudaError_t launch_fc2_partial(const CUtensorMap& tg, const CUtensorMap& tb,
                               const float* b, const bf16* x, float* y, int M,
                               int N, int K, float inv_keep, uint32_t keep_q,
                               uint64_t seed, int bn, cudaStream_t stream);

// The keep bits of one row of a 128-column tile, shared within the quad.
// Thread o (= t % 4) draws Philox blocks blk0 + 2 o + k, k = 0, 1, and packs
// the keep decision of byte p of word w of block k at bit 8 p + 4 k + w.
// After one shuffle from each thread, word[o] holds thread o's bits shifted
// so that the thread's own column 8 j + 2 (t % 4) + e, j = 4 o + 2 k + jj,
// is at bit 8 e + 4 k + 2 jj: that column is byte 2 (t % 2) + e of word 2 jj
// + (t % 4) / 2 of block 2 o + k. A 64-column tile uses the first four
// blocks (threads 2 and 3 draw two past it).
struct QuadKeep {
  uint32_t word[4];

  __device__ __forceinline__ void draw(uint64_t blk0, int quad,
                                       uint32_t keep_q, uint64_t seed) {
    const uint32_t q4 = keep_q * 0x01010101u;
    uint32_t mine = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint4 w = philox4x32_10(blk0 + 2 * quad + k, seed);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mine |= (__vcmpltu4(ws[i], q4) & 0x01010101u) << (4 * k + i);
    }
    const int shift = 16 * (quad % 2) + quad / 2;
    const int base = (threadIdx.x % 32) & ~3;
#pragma unroll
    for (int o = 0; o < 4; ++o)
      word[o] = __shfl_sync(0xffffffffu, mine, base + o) >> shift;
  }

  // Whether the thread's element e (0, 1) of column group j is kept.
  __device__ __forceinline__ bool keep(int j, int e) const {
    return (word[j / 4] >> (8 * e + 4 * ((j / 2) % 2) + 2 * (j % 2))) & 1u;
  }
};

// The thread's place in the tile (hopper_gemm.cuh, Mainloop::for_each_pair):
// rows r0 and r0 + 8, columns 8 j + c0 and + 1 of every j < BN / 8.
struct Place {
  int r0, quad;
  __device__ Place()
      : r0((threadIdx.x / 128) * 64 + ((threadIdx.x % 128) / 32) * 16 +
           (threadIdx.x % 32) / 4),
        quad(threadIdx.x % 4) {}
};

// An output tile staged in the block's ring: kBM x BN bf16 as BN / 64
// boxes of kBM rows x 128 bytes, laid out as the maps' 64-column boxes
// with the 128-byte swizzle (the 16-byte chunk c of row r at chunk c ^ (r
// % 8)), so a warp's pair stores hit 32 different banks and one TMA store
// writes each box. This is the byte offset of the pair at row r, columns
// 8 j + 2 quad and + 1.
__device__ __forceinline__ int staged_at(int r, int j, int quad) {
  return (j / 8) * (kBM * 128) + r * 128 + (((j % 8) ^ (r % 8)) * 16) +
         4 * quad;
}

// Store the staged tiles t0 (and t1, unless its map is null) at (n0, m0)
// of their maps (columns past n_end skipped, rows past M clipped by TMA),
// once every consumer thread has written its pairs, and wait until TMA has
// read them. Every consumer thread calls it; thread 0 stores.
template <int BN>
__device__ __forceinline__ void store_staged(const CUtensorMap* map0,
                                             const unsigned char* t0,
                                             const CUtensorMap* map1,
                                             const unsigned char* t1, int n0,
                                             int m0, int n_end) {
  hopper::fence_proxy_async();
  hopper::named_barrier(1, kConsumerThreads);
  if (threadIdx.x != 0) return;
  for (int b = 0; b < BN / 64 && n0 + 64 * b < n_end; ++b) {
    hopper::tma_store_2d(map0, t0 + b * kBM * 128, n0 + 64 * b, m0);
    if (map1 != nullptr)
      hopper::tma_store_2d(map1, t1 + b * kBM * 128, n0 + 64 * b, m0);
  }
  hopper::tma_store_wait();
}

// The epilogue of a GEMM pass whose output is the plain bf16 product (K2's
// qkv_gemm, K8's dattn): once no wgmma reads the ring, each consumer
// thread rounds its f32 accumulator pairs to bf16 pairs and stages them
// (staged_at); then store_staged writes the tile at (n0, m0) of map,
// columns past n_end skipped and rows past the map's clipped by TMA. Every
// consumer thread calls it with the block's dynamic shared memory.
template <int BN>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           unsigned char* smem,
                                           const float (&acc)[BN / 2], int n0,
                                           int m0, int n_end) {
  const Place at;
  unsigned char* os = reinterpret_cast<unsigned char*>(
      round_up(reinterpret_cast<size_t>(smem), 1024));   // the ring
  hopper::named_barrier(1, kConsumerThreads);   // no wgmma reads it now
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = at.r0 + 8 * half;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(os + staged_at(r, j, at.quad)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                acc[4 * j + 2 * half + 1]);
  }
  store_staged<BN>(map, os, nullptr, nullptr, n0, m0, n_end);
}

}  // namespace mlp
}  // namespace nvt
