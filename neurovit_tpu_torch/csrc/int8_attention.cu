// Attention with the P V product in int8 (K13), [B, N, H, D] layout, bf16,
// on TMA and wgmma: head dims 64 and 128 (a template parameter; the wrapper
// zero-pads any other D from 8 to 128 to one of these, as K1's does).
//
// Replaces the TPU kernel neurovit_tpu/ops/int8_serving.py:286
// (_attn_pv_kernel, launched at :356 by int8_flash_attention). Per (b, h):
//   s_v = amax_k |v[k, :]| / 127 over the keys k < n_valid  (per channel)
//   v8 = clamp(rint(v / s_v), +-127), 0 for keys at or past n_valid
//   s = q . k^T * (scale * log2 e)            bf16 in, f32 accumulation
//   p = exp2(clamp(s, -96, 96)) * (key < n_valid)
//   denom = sum(p),  s_p = rowmax(p) / 127    from the f32 p
//   p8 = clamp(rint(p / s_p), 0, 127)
//   o = bf16(float(p8 . v8) * (s_p / denom * s_v))
// QK^T and the softmax stay in bf16 / f32, as on the TPU: only the
// probabilities and V are quantized. The int32 sums of p8 . v8 are exact.
//
// What bounds it on the H100: the tensor cores and the exp2 units. The
// function's work is one bf16 QK^T and one s8 P V (4 N^2 D operations per
// (b, h) against 4 N D * 2 bytes: about 500 a byte at N = 1001), and N^2
// exponentials on 16 MUFU lanes an SM. This design does QK^T twice (below),
// so its floor is two bf16 QK^T at 989 TFLOP/s plus one s8 P V at 1,979
// TOP/s: 0.0207 ms at the flagship's batch 8, against 0.0166 for K1.
//
// Why two sweeps. The TPU kernel holds a whole [block_q, N] row of p in
// VMEM, so it knows the row max before it quantizes. A block here walks K
// and v8 in 64-key tiles and cannot hold a row (64 rows x 1001 keys x f32
// is 256 KB), so it walks the keys twice per query block: sweep 0 runs S =
// Q K^T and keeps each row's max of the masked, scaled scores; exp2 and the
// clamp are monotone, so rowmax(p) = exp2(clamp(rowmax s)), one exponential
// a row where p's max would take N. Sweep 1 recomputes S with the same
// tensor-core sums, so the same p, adds p to the row sum, quantizes it
// against the known max in registers and accumulates O += P8 . V8 in int32.
//
// The design follows K1's forward (flash_attention.cu): a block of 64 or
// 128 query rows (kConsumers = 1 or 2 consumer warpgroups of 64 rows plus
// one producer warp; one at D = 64, attn_consumers) on the one-dimensional
// grid of flash::GridTile. The producer loads each consumer's Q tile once
// and, for
// 2 * n_tiles ring steps, the K tiles of sweep 0 and then the K and v8
// tiles of sweep 1 through a kStages ring with full/empty mbarriers. Q and
// K come through rank-4 [B, N, H, D] maps (TMA zero-fills keys and queries
// past N), 128-byte swizzled in 64-column panels; S is wgmma.m64n64k16 with
// both operands K-major, as K1's. In sweep 1 each thread computes p where
// the accumulator holds it, rounds p / s_p to codes, and packs them as the
// register A operand of wgmma.m64nDk32.s32.s8.s8 (WgmmaRegAS8): P never
// touches shared memory. The next tile's QK^T is issued with this tile's
// P V, and its exponentials run while P V is on the tensor cores. O is
// scaled once, staged as bf16 into the warpgroup's freed Q slot and stored
// by TMA, which writes no row past N.
//
// The v8 layout. s8 wgmma reads both operands K-major only (it has no
// transpose for 8-bit types), so V, MN-major as it lies, is transposed: a
// prologue writes v8 as [B * H, D, n_pad] int8 (n_pad = N rounded up to
// 64), a channel's keys contiguous, loaded as 64-key boxes with the 64-byte
// swizzle. Thread t of a warpgroup holds the S accumulator's row r = 16 (t
// / 32) + (t % 32) / 4 (and r + 8) at keys 8 j + 2 (t % 4) + {0, 1}, j =
// 0..7, while the s8 A fragment wants of row r the k 4 (t % 4) .. + 3 in
// its first register and 16 + 4 (t % 4) .. + 3 in its third. So within
// each group of 32 keys, stored position k = 16 half + 4 q + i holds the
// code of key 16 half + 2 q + 8 (i / 2) + i % 2: the thread's codes of a
// 32-key chunk, c0 .. c15 in accumulator order, pack as (c0, c1, c4, c5),
// (c2, c3, c6, c7), (c8, c9, c12, c13), (c10, c11, c14, c15) into the four
// A registers, with no shuffle. P and V share the permutation, so the
// int32 sums are those of p8 . v8 bit for bit
// (tests/test_torch_int8_attention_plan.py models it).
//
// The prologue runs over (B * H, key tiles) blocks in two launches: each
// block takes the per-channel amax of its 64 keys into a partial; then
// each block reduces its head's partials to s_v and writes its tile's
// codes, transposed and permuted (the partials and s_v share the wrapper's
// f32 scratch). Keys at or past n_valid give code 0 and no amax; v8 past
// the last key tile that n_valid reaches is not written and never read.
// The prologue has an f32 instance on the element type of V
// (launch_v_prologue, int8.cuh), which K13 at f32 (int8_attention_f32.cu)
// launches before its own attention kernel: the same codes and scales of
// f32 V, in the same layout.
#include <cfloat>

#include "flash_attention.cuh"
#include "int8.cuh"

namespace nvt {
namespace {

using hopper::fence_operand;
using namespace flash;

constexpr int kPrologueThreads = 256;

// Shared memory of one block of the main kernel: the consumers' Q tiles,
// the K and v8 rings, the barriers, and 1 KiB of slack to align the tiles
// to the swizzle's 1024 bytes.
template <int D, int kConsumers>
struct AttnPlan {
  static_assert(D == 64 || D == 128, "head dim instance");
  static constexpr int kStages = 4;              // K / v8 ring depth
  static constexpr int kMinBlocks = D == 64 ? 3 : 1;   // blocks an SM
  static constexpr int kPanels = D / 64;
  static constexpr int BQ = 64 * kConsumers;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kQBytes = BQ * D * 2;
  static constexpr int kKBytes = kBKV * D * 2;   // one K stage
  static constexpr int kVBytes = D * kBKV;       // one v8 stage
  static constexpr int kBarriers = 2 * kStages + 1;
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + kStages * (kKBytes + kVBytes) + kBarriers * 8;
};

// Prologue pass 1: amax[bh, t, :] = the per-channel amax of |v| over the
// keys of tile t below n_valid. D / 8 threads a key, 8 channels each; V's
// elements of type T (bf16 or float).
template <typename T, int D>
__global__ void __launch_bounds__(kPrologueThreads)
    v_amax_kernel(const T* __restrict__ v, float* __restrict__ amax, int N,
                  int H, int n_valid, int n_tiles) {
  constexpr int kLanes = D / 8, kKeys = kPrologueThreads / kLanes;
  __shared__ float part[kKeys][D + 1];
  const int bh = blockIdx.x, t = blockIdx.y, b = bh / H, h = bh - b * H;
  const size_t stride = static_cast<size_t>(H) * D;
  const T* vh = v + (static_cast<size_t>(b) * N * H + h) * D;
  const int kr = threadIdx.x / kLanes, c0 = (threadIdx.x % kLanes) * 8;
  const int key_end = min(kBKV * (t + 1), n_valid);
  float m[8] = {};
#pragma unroll
  for (int key = kBKV * t + kr; key < key_end; key += kKeys) {
    float f[8];
    load8(vh + key * stride + c0, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = fmaxf(m[i], fabsf(f[i]));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[kr][c0 + i] = m[i];
  __syncthreads();
  if (threadIdx.x < D) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) a = fmaxf(a, part[r][threadIdx.x]);
    amax[(static_cast<size_t>(bh) * n_tiles + t) * D + threadIdx.x] = a;
  }
}

// Prologue pass 2: s_v[bh, :] from the head's partials, and the codes of
// key tile t into v8[bh, d, 64 t .. 64 t + 63] in the permuted order. A
// thread moves 8 channels of a key: one 16-byte vector of bf16, two of f32.
template <typename T, int D>
__global__ void __launch_bounds__(kPrologueThreads)
    v_quant_kernel(const T* __restrict__ v, const float* __restrict__ amax,
                   float* __restrict__ s_v, int8_t* __restrict__ v8, int N,
                   int H, int n_valid, int n_tiles, int n_pad) {
  constexpr int kLanes = D / 8, kKeys = kPrologueThreads / kLanes;
  constexpr int kVecs = sizeof(T) / 2;                // 16-byte vectors
  __shared__ __align__(16) T tile[kBKV][D + 8];       // keys x channels
  __shared__ float scale[D];
  const int bh = blockIdx.x, t = blockIdx.y, b = bh / H, h = bh - b * H;
  // The tile's keys into registers, zero at and past n_valid (so their
  // codes are 0), in flight while the channel scales are reduced.
  constexpr int kLoads = kBKV / kKeys;
  const size_t stride = static_cast<size_t>(H) * D;
  const T* vh = v + (static_cast<size_t>(b) * N * H + h) * D;
  const int kr = threadIdx.x / kLanes, c0 = (threadIdx.x % kLanes) * 8;
  uint4 raw[kLoads][kVecs];
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int key = kBKV * t + kr + l * kKeys;
#pragma unroll
    for (int w = 0; w < kVecs; ++w)
      raw[l][w] = key < n_valid ? reinterpret_cast<const uint4*>(
                                      vh + key * stride + c0)[w]
                                : make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x < D) {
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_tiles; ++i)
      a = fmaxf(a, amax[(static_cast<size_t>(bh) * n_tiles + i) * D +
                        threadIdx.x]);
    const float sc = quant_scale(a);
    scale[threadIdx.x] = sc;
    if (t == 0) s_v[static_cast<size_t>(bh) * D + threadIdx.x] = sc;
  }
#pragma unroll
  for (int l = 0; l < kLoads; ++l)
#pragma unroll
    for (int w = 0; w < kVecs; ++w)
      reinterpret_cast<uint4*>(&tile[kr + l * kKeys][c0])[w] = raw[l][w];
  __syncthreads();
  // Thread w: stored positions 16 u .. 16 u + 15 of channel d; position
  // 16 u + 4 q + i holds key 16 u + 2 q + 8 (i / 2) + i % 2 of the tile.
  for (int w = threadIdx.x; w < 4 * D; w += kPrologueThreads) {
    const int d = w % D, u = w / D;
    const float sc = scale[d];
    uint32_t word[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t packed = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * u + 2 * q + 8 * (i / 2) + i % 2;
        const int c = quant_code(to_float(tile[r][d]), sc, -127.f);
        packed |= (static_cast<uint32_t>(c) & 0xFFu) << (8 * i);
      }
      word[q] = packed;
    }
    *reinterpret_cast<uint4*>(v8 + (static_cast<size_t>(bh) * D + d) * n_pad +
                              kBKV * t + 16 * u) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// Sweep 0: m[R] = max(m[R], sign s) over the thread's keys of rows r0 + 8
// R below n_valid (kRagged: the tile crosses n_valid), sign -1 where
// scale_log2e < 0 (kNeg); the row max of s * scale_log2e is then
// (sign m) * scale_log2e, exactly, as rounding is monotone. acc[4 j + i]
// is row r0 + 8 (i / 2), key key0 + 8 j + i % 2, key0 = 64 t + 2 (lane % 4)
// for key tile t.
template <bool kRagged, bool kNeg>
__device__ __forceinline__ void row_max(const float (&acc)[32], float (&m)[2],
                                        int key0, int n_valid) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kRagged && key0 + 8 * j + i % 2 >= n_valid) continue;
      const float a = acc[4 * j + i];
      m[i / 2] = fmaxf(m[i / 2], kNeg ? -a : a);
    }
}

// Sweep 1, in place: p = exp2(clamp(s * scale_log2e)), zero at keys at or
// past n_valid, summed into rowsum; acc becomes p / s_p as p * inv_sp.
template <bool kRagged>
__device__ __forceinline__ void probs_tile(float (&acc)[32],
                                           float (&rowsum)[2],
                                           const float (&inv_sp)[2],
                                           float scale_log2e, int key0,
                                           int n_valid) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int R = i / 2;
      float p = capped_exp2(acc[4 * j + i], scale_log2e);
      if (kRagged && key0 + 8 * j + i % 2 >= n_valid) p = 0.f;
      rowsum[R] += p;
      acc[4 * j + i] = p * inv_sp[R];
    }
}

// The codes of acc as the s8 A operands of the tile's two k32 chunks:
// pa[4 c .. 4 c + 3] from acc[16 c .. 16 c + 15] as (0, 1, 4, 5), (2, 3,
// 6, 7), (8, 9, 12, 13), (10, 11, 14, 15), the first in the lowest byte.
__device__ __forceinline__ void pack_p8(const float (&acc)[32],
                                        uint32_t (&pa)[8]) {
  constexpr int kOrder[4][4] = {
      {0, 1, 4, 5}, {2, 3, 6, 7}, {8, 9, 12, 13}, {10, 11, 14, 15}};
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* a = acc + 16 * c;
      pa[4 * c + r] = pack_s8x4(a[kOrder[r][0]], a[kOrder[r][1]],
                                a[kOrder[r][2]], a[kOrder[r][3]]);
    }
}

template <int D, int kConsumers>
__global__ void __launch_bounds__(AttnPlan<D, kConsumers>::kThreads,
                                  AttnPlan<D, kConsumers>::kMinBlocks)
    int8_attn_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to,
                     const float* __restrict__ s_v, int N, int H, int n_valid,
                     float scale_log2e) {
  using P = AttnPlan<D, kConsumers>;
  constexpr int kPanels = P::kPanels, kStages = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      round_up(reinterpret_cast<size_t>(smem_raw), 1024));
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + P::kQBytes;
  unsigned char* Vs = Ks + kStages * P::kKBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * P::kVBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;

  const GridTile g((N + P::BQ - 1) / P::BQ, H);
  const int bh = g.bh, b = g.b, h = g.h;
  const int q0 = g.tile * P::BQ;
  const int n_tiles = (n_valid + kBKV - 1) / kBKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {   // the producer warp: one thread issues
    if (threadIdx.x % 32 == 0) {
      hopper::tma_prefetch_map(&tq);
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tv);
      hopper::mbar_expect_tx(qfull, P::kQBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int p = 0; p < kPanels; ++p)
          load_box<false>(Qs + (c * kPanels + p) * kPanelBytes, &tq, qfull,
                          64 * p, q0 + 64 * c, h, b);
      // Ring step it: K tile it of sweep 0, then K and v8 tile it - n_tiles
      // of sweep 1.
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int s = it % kStages;
        const bool pv = it >= n_tiles;
        const int t = pv ? it - n_tiles : it;
        if (it >= kStages)
          hopper::mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        hopper::mbar_expect_tx(&full[s], P::kKBytes + (pv ? P::kVBytes : 0));
        for (int p = 0; p < kPanels; ++p)
          load_box<false>(Ks + s * P::kKBytes + p * kPanelBytes, &tk,
                          &full[s], 64 * p, t * kBKV, h, b);
        if (pv)
          hopper::tma_load_2d(Vs + s * P::kVBytes, &tv, &full[s], t * kBKV,
                              bh * D);
      }
    }
    return;
  }

  // A consumer warpgroup: rows q0 + 64 wg .. + 63. This thread holds rows
  // r0 and r0 + 8 of them.
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32, quad = lane % 4;
  const int r0 = 16 * (t128 / 32) + lane / 4;
  const int qw = q0 + 64 * wg;
  unsigned char* Qw = Qs + wg * kPanels * kPanelBytes;

  float sacc[32];
  // acc = S = Q K^T of ring step it.
  auto issue_s = [&](float (&acc)[32], int it) {
    const int s = it % kStages;
    hopper::mbar_wait(&full[s], (it / kStages) & 1);
    const unsigned char* Kt = Ks + s * P::kKBytes;
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4;
      const uint64_t step = (kk % 4) * hopper::kDescStepK;
      const uint64_t da = hopper::smem_desc(Qw + p * kPanelBytes) + step;
      const uint64_t db = hopper::smem_desc(Kt + p * kPanelBytes) + step;
      if (kk == 0)   // the first k step overwrites the last tile's S
        hopper::Wgmma<false, 64>::mma<0>(acc, da, db);
      else
        hopper::Wgmma<false, 64>::mma(acc, da, db);
    }
    hopper::wgmma_commit();
  };
  auto fence_s = [&] {
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(sacc[i]);
  };
  auto release = [&](int it) {
    if (t128 == 0) hopper::mbar_arrive(&empty[it % kStages]);
  };

  hopper::mbar_wait(qfull, 0);

  // Sweep 0: each row's max of the scaled scores over its valid keys. Tile
  // t's S is copied out of the accumulator so that S_{t+1} runs on the
  // tensor cores while the thread takes tile t's max; the last tile, the
  // only one that can cross n_valid, is peeled off the loop.
  const bool neg = scale_log2e < 0.f;
  float smax[2] = {-FLT_MAX, -FLT_MAX};
  float scopy[32];
  auto tile_max = [&](const float (&acc)[32], int t) {
    const int key0 = t * kBKV + 2 * quad;
    const bool ragged = (t + 1) * kBKV > n_valid;
    if (ragged)
      neg ? row_max<true, true>(acc, smax, key0, n_valid)
          : row_max<true, false>(acc, smax, key0, n_valid);
    else
      neg ? row_max<false, true>(acc, smax, key0, n_valid)
          : row_max<false, false>(acc, smax, key0, n_valid);
  };
  issue_s(sacc, 0);
  for (int t = 0; t + 1 < n_tiles; ++t) {
    hopper::wgmma_wait<0>();
    fence_s();
    release(t);
#pragma unroll
    for (int i = 0; i < 32; ++i) scopy[i] = sacc[i];
    issue_s(sacc, t + 1);
    tile_max(scopy, t);
  }
  hopper::wgmma_wait<0>();
  fence_s();
  release(n_tiles - 1);
  tile_max(sacc, n_tiles - 1);
  // s_p = rowmax(p) / 127 with rowmax(p) = exp2(clamp(rowmax s)): the same
  // exponential of the same f32 value as the max element's p in sweep 1.
  float s_p[2], inv_sp[2];
#pragma unroll
  for (int R = 0; R < 2; ++R) {
    smax[R] = fmaxf(smax[R], __shfl_xor_sync(0xffffffffu, smax[R], 1));
    smax[R] = fmaxf(smax[R], __shfl_xor_sync(0xffffffffu, smax[R], 2));
    const float m = (neg ? -smax[R] : smax[R]) * scale_log2e;
    s_p[R] = quant_scale(exp2_ftz(fminf(fmaxf(m, -kScoreCap), kScoreCap)));
    inv_sp[R] = __fdiv_rn(1.f, s_p[R]);
  }

  // Sweep 1, software-pipelined within the warpgroup as K1's: step t issues
  // S_{t+1} and then O += P8_t V8_t, waits for S_{t+1} alone, and runs tile
  // t + 1's exponentials while P8_t V8_t is on the tensor cores; then it
  // waits for P8_t V8_t, releases tile t's stage and packs P8_{t+1} into
  // the registers P8_t V8_t read.
  int oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    oacc[i] = 0;
    fence_operand(oacc[i]);
  }
  float rowsum[2] = {0.f, 0.f};
  uint32_t pa[8];
  auto probs = [&](int t) {
    const int key0 = t * kBKV + 2 * quad;
    if ((t + 1) * kBKV > n_valid)
      probs_tile<true>(sacc, rowsum, inv_sp, scale_log2e, key0, n_valid);
    else
      probs_tile<false>(sacc, rowsum, inv_sp, scale_log2e, key0, n_valid);
  };
  // O += P8 V8 of ring step it: two k32 chunks, 32 bytes apart in the
  // swizzled 64-byte rows of the v8 tile.
  auto issue_pv = [&](int it) {
    const unsigned char* Vt = Vs + (it % kStages) * P::kVBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBKV / 32; ++c) {
      const uint32_t a[4] = {pa[4 * c], pa[4 * c + 1], pa[4 * c + 2],
                             pa[4 * c + 3]};
      hopper::WgmmaRegAS8<D>::mma(
          oacc, a, hopper::smem_desc_sw64(Vt) + c * hopper::kDescStepK);
    }
    hopper::wgmma_commit();
  };
  auto retire_pv = [&](int it) {
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 8; ++i) fence_operand(pa[i]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_operand(oacc[i]);
    release(it);
  };

  issue_s(sacc, n_tiles);
  hopper::wgmma_wait<0>();
  fence_s();
  probs(0);
  pack_p8(sacc, pa);
  for (int t = 0; t + 1 < n_tiles; ++t) {
    issue_s(sacc, n_tiles + t + 1);
    issue_pv(n_tiles + t);
    hopper::wgmma_wait<1>();   // S_{t+1}; P8_t V8_t may still run
    fence_s();
    probs(t + 1);
    retire_pv(n_tiles + t);
    pack_p8(sacc, pa);
  }
  issue_pv(2 * n_tiles - 1);
  retire_pv(2 * n_tiles - 1);

  // Row sums over the quad; o = float(acc) * (s_p / denom * s_v), bf16,
  // staged into the Q slot (128-byte swizzled panels) and stored by TMA.
  float ratio[2];
#pragma unroll
  for (int R = 0; R < 2; ++R) {
    rowsum[R] += __shfl_xor_sync(0xffffffffu, rowsum[R], 1);
    rowsum[R] += __shfl_xor_sync(0xffffffffu, rowsum[R], 2);
    ratio[R] = __fdiv_rn(s_p[R], rowsum[R]);
  }
  const float* sv = s_v + static_cast<size_t>(bh) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const float2 s2 =
        *reinterpret_cast<const float2*>(sv + 8 * j + 2 * quad);
#pragma unroll
    for (int R = 0; R < 2; ++R) {
      const int r = r0 + 8 * R;
      const float o0 = __fmul_rn(__int2float_rn(oacc[4 * j + 2 * R]),
                                 __fmul_rn(ratio[R], s2.x));
      const float o1 = __fmul_rn(__int2float_rn(oacc[4 * j + 2 * R + 1]),
                                 __fmul_rn(ratio[R], s2.y));
      *reinterpret_cast<uint32_t*>(Qw + (j / 8) * kPanelBytes +
                                   r * kRowBytes + (((j % 8) ^ (r % 8)) * 16) +
                                   4 * quad) = pack_bf16x2(o0, o1);
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + wg, 128);
  if (t128 == 0 && qw < N) {
    for (int p = 0; p < kPanels; ++p)
      store_box<false>(&to, Qw + p * kPanelBytes, 64 * p, qw, h, b);
    hopper::tma_store_wait();
  }
}

// Consumer warpgroups a block of the main kernel: one at D = 64, three
// blocks an SM, each block on its own ring (two consumers on one ring move
// in step and ran 4-5 % slower on the H100), K1's choice at D = 128, where
// a one-consumer block's ring leaves room for one block an SM.
int attn_consumers(int B, int N, int H, int D) {
  return D == 64 ? 1 : consumers(B, N, H);
}

template <int D, int kConsumers>
cudaError_t launch_main(const void* q, const void* k, const void* v8,
                        void* o, const float* s_v, int B, int N, int H,
                        int n_valid, int n_pad, float scale_log2e,
                        cudaStream_t stream) {
  using P = AttnPlan<D, kConsumers>;
  const cuuint64_t e = 2;   // bytes of a bf16
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(N),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {D * e, dims[1] * D * e,
                                 dims[2] * dims[1] * D * e};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  CUtensorMap maps[4];
  const void* ptrs[3] = {q, k, o};
  const int slots[3] = {0, 1, 3};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = hopper::encode_bf16_4d(&maps[slots[i]], ptrs[i],
                                                   dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = hopper::encode_kmajor(&maps[2], v8, B * H * D, n_pad,
                                          true, D, 64);
  if (err != cudaSuccess) return err;
  const auto kernel = int8_attn_kernel<D, kConsumers>;
  err = allow_smem(kernel, P::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((N + P::BQ - 1) / P::BQ) * B * H);
  kernel<<<grid, P::kThreads, P::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], s_v, N, H, n_valid, scale_log2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* v8, void* stats, int B, int N, int H, int n_valid,
                   float scale_log2e, cudaStream_t s) {
  const int n_pad = (N + kBKV - 1) / kBKV * kBKV;
  float* s_v = static_cast<float*>(stats);
  const cudaError_t err = launch_v_prologue<bf16, D>(
      static_cast<const bf16*>(v), s_v, static_cast<int8_t*>(v8), B, N, H,
      n_valid, s);
  if (err != cudaSuccess) return err;
  if constexpr (D == 64)
    return launch_main<64, 1>(q, k, v8, o, s_v, B, N, H, n_valid, n_pad,
                              scale_log2e, s);
  else
    return attn_consumers(B, N, H, D) == 2
               ? launch_main<D, 2>(q, k, v8, o, s_v, B, N, H, n_valid, n_pad,
                                   scale_log2e, s)
               : launch_main<D, 1>(q, k, v8, o, s_v, B, N, H, n_valid, n_pad,
                                   scale_log2e, s);
}

}  // namespace

template <typename T, int D>
cudaError_t launch_v_prologue(const T* v, float* stats, int8_t* v8, int B,
                              int N, int H, int n_valid, cudaStream_t s) {
  using flash::kBKV;
  const int n_pad = (N + kBKV - 1) / kBKV * kBKV;
  const int n_tiles = (n_valid + kBKV - 1) / kBKV;
  float* amax = stats + static_cast<size_t>(B) * H * D;   // after s_v
  const dim3 grid(B * H, n_tiles);
  v_amax_kernel<T, D><<<grid, kPrologueThreads, 0, s>>>(v, amax, N, H,
                                                        n_valid, n_tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  v_quant_kernel<T, D><<<grid, kPrologueThreads, 0, s>>>(
      v, amax, stats, v8, N, H, n_valid, n_tiles, n_pad);
  return cudaGetLastError();
}

template cudaError_t launch_v_prologue<bf16, 64>(const bf16*, float*,
                                                 int8_t*, int, int, int, int,
                                                 cudaStream_t);
template cudaError_t launch_v_prologue<bf16, 128>(const bf16*, float*,
                                                  int8_t*, int, int, int, int,
                                                  cudaStream_t);
template cudaError_t launch_v_prologue<float, 64>(const float*, float*,
                                                  int8_t*, int, int, int, int,
                                                  cudaStream_t);
template cudaError_t launch_v_prologue<float, 128>(const float*, float*,
                                                   int8_t*, int, int, int,
                                                   int, cudaStream_t);

bool int8_attn_takes(int B, int N, int H, int D) {
  return B >= 1 && N >= 1 && H >= 1 && (D == 64 || D == 128) &&
         static_cast<long long>(B) * H * ((N + 63) / 64) <= 0x7FFFFFFF &&
         static_cast<long long>(B) * H * D <= 0x7FFFFFFF;
}

}  // namespace nvt

// q, k, v, o: [B, N, H, D] bf16, contiguous, D in {64, 128} (the wrapper
// zero-pads other head dims). 1 <= n_valid <= N; B * H * ceil(N / 64) and
// B * H * D below 2^31 (the grid's x and v8's rows). Scratch: v8, the
// codes, [B * H, D, n_pad] int8 with n_pad = N rounded up to 64
// (nvt_int8_attn_v8_bytes), and stats, f32: s_v [B * H, D] followed by the
// partial amax [B * H, ceil(n_valid / 64), D] (nvt_int8_attn_stats_bytes
// counts them at n_valid = N). Four launches on `stream`, no allocation.
extern "C" int nvt_int8_attention(const void* q, const void* k, const void* v,
                                  void* o, void* v8, void* stats, int B, int N,
                                  int H, int D, int n_valid, float scale_log2e,
                                  void* stream) {
  using namespace nvt;
  if (!int8_attn_takes(B, N, H, D) || n_valid < 1 || n_valid > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D == 64 ? launch<64>(q, k, v, o, v8, stats, B, N, H, n_valid,
                           scale_log2e, s)
              : launch<128>(q, k, v, o, v8, stats, B, N, H, n_valid,
                            scale_log2e, s));
}

// Query rows per block of the main kernel at (B, N, H) and head dim D (64
// or 128): 128 or 64.
extern "C" int nvt_int8_attn_block_rows(int B, int N, int H, int D) {
  return 64 * nvt::attn_consumers(B, N, H, D);
}

// Dynamic shared memory of one block of the main kernel at head dim d (64
// or 128) and bq query rows (64 or 128), or -1 for an instance there is not.
extern "C" long long nvt_int8_attn_smem_bytes(int d, int bq) {
  using nvt::AttnPlan;
  if (d == 64 && bq == 64) return AttnPlan<64, 1>::kSmemBytes;
  if (d == 128 && bq == 64) return AttnPlan<128, 1>::kSmemBytes;
  if (d == 128 && bq == 128) return AttnPlan<128, 2>::kSmemBytes;
  return -1;
}

// Bytes of the v8 scratch at (B, N, H, D), or -1 for a shape the kernel
// does not take.
extern "C" long long nvt_int8_attn_v8_bytes(int B, int N, int H, int D) {
  if (!nvt::int8_attn_takes(B, N, H, D)) return -1;
  const long long n_pad = (N + nvt::flash::kBKV - 1) / nvt::flash::kBKV *
                          nvt::flash::kBKV;
  return static_cast<long long>(B) * H * D * n_pad;
}

// Bytes of the f32 stats scratch at (B, N, H, D): s_v and the partial amax
// of every key tile, or -1 for a shape the kernel does not take.
extern "C" long long nvt_int8_attn_stats_bytes(int B, int N, int H, int D) {
  if (!nvt::int8_attn_takes(B, N, H, D)) return -1;
  const long long tiles = (N + nvt::flash::kBKV - 1) / nvt::flash::kBKV;
  return static_cast<long long>(B) * H * D * (1 + tiles) * 4;
}
