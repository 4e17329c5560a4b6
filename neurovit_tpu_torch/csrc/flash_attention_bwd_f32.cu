// Flash attention backward at f32 on the tensor cores (3xTF32), in two
// layouts:
//   bnhd [B, N, H, D] (K5): replaces the TPU kernel
//     neurovit_tpu/ops/flash_attention.py:269 (_bwd_kernel_allheads,
//     launched at :420);
//   bhnd [B, H, N, D] (K6's backward): replaces :152 (_bwd_kernel, launched
//     at :420 by the Grad-CAM probe's gradient).
// Both are instances of the same two passes, templated on the layout
// (common.cuh HeadRows). On f32 operands nothing is rounded
// (ds.astype(q.dtype) at :314, and :208 for bhnd, is the identity). Per
// (b, h),
// with P and the dropout mask regenerated from q, k and the seed:
//   p     = exp2(clamp(q.k^T * scale log2 e, +-96)) * (key < n_valid) / l
//   delta = keep * sum_d(dO * O)                 per query row
//   dp_m  = (dO . v^T) * mask
//   ds    = p * (dp_m - delta) * (scale / keep)
//   dq    = ds . k       dk = ds^T . q       dv = (p * mask)^T . dO / keep
// l is the forward's f32 row sum (K1 f32 writes it when a graph is
// recorded); delta comes from the output as in the bf16 K5
// (flash_attention_bwd.cu says why), and the plain backward
// (ops/flash_attention.py) takes the same formula. The mask of element
// (b, h, q, k) is byte i % 16 of Philox4x32-10(i / 16, seed) at i = ((b H
// + h) N + q) N + k, the forward's bits (flash_f32.cuh keep_bits16).
//
// What bounds it on the H100: 8 B H N n_valid D flops for the five
// products; this design recomputes S and dP in both passes, seven
// products, 57.4 GFLOP for the flagship block at batch 8 (B H = 64, N =
// n_valid = 1001, D = 64). Each runs in 3xTF32 on mma.sync (tf32x3.cuh:
// three TF32 MMAs a product, about f32's accuracy): 165 TFLOP/s of f32
// products at the data sheet's 495 TF32 TFLOP/s, a 0.35 ms bound for the
// seven, but mma.sync's TF32 form reaches 322 TFLOP/s on the H100
// (scripts/torch_mma_tf32_peak.py), 107 of f32 products, 0.54 ms; FFMA on
// the CUDA cores' 67 TFLOP/s, this kernel's first design, 0.86 ms. Beside
// the MMAs the threads split each operand they load into big and small
// parts, take the exp2 and, with dropout, draw the Philox mask
// (scripts/torch_attention_bwd_f32_variants.py times the splits).
//
// The design, the bf16 K5's two passes with no atomics (deterministic:
// two calls and the two layouts are bit-equal), each a block of four warps
// that each own 16 rows, tiles of f32 rows D + 4 floats apart (tf32x3.cuh:
// every fragment load conflict-free), copies by 16-byte cp.async through
// rings of two stages, one-dimensional grids with a head's tiles adjacent:
//   dq_f32_kernel   a block owns 64 query rows; it first takes delta of its
//                   rows from dO and O (and writes it for pass 2) and each
//                   row's 1 / l, then walks the key tiles of 32 below
//                   n_valid: a warp takes S = Q K^T and dP = dO V^T of its
//                   16 rows (A from the Q or dO tile, B K-major from the K
//                   or V tile, both by ldmatrix), forms dS in the
//                   accumulators' registers, and adds dQ += dS K with dS
//                   as the A fragment as it lies and K read MN-major from
//                   the same tile.
//   dkv_f32_kernel  a block owns 64 keys and every column of dK and dV (64
//                   of them at D = 128, kCols); it walks every query tile
//                   of 32, the tile's l and delta staged beside Q and dO
//                   (the [B, H, N] statistics' rows are not 16-byte
//                   aligned: 4-byte copies): a warp takes S^T = K Q^T and
//                   dP^T = V dO^T of its 16 keys, forms (P m)^T and dS^T in
//                   their registers, and adds dV += (P m)^T dO, then dK +=
//                   dS^T Q, dO and Q read MN-major. Key blocks at or past
//                   n_valid write zeros.
// The sums: S and dP (S^T and dP^T) run kSteps steps of k into fresh
// accumulators, dQ, dK and dV a tile's four (tf32x3.cuh says why). The
// mask: in pass 1 lane l draws the 16 keys 16 (l % 2) .. of the tile's row
// l / 2 of its warp (keep_bits16, one or two Philox blocks), and a thread
// gathers its two rows' 32 bits by four shuffles; in pass 2 lane l draws
// the warp's 16 keys of the tile's query l, and a thread takes its 8
// queries' words by eight shuffles. Head dims are instances at 32, 64 and
// 128 (ops/flash_attention.py pads the others), as K1 f32's; the layout
// changes only where a head's rows lie, so both layouts share the grids
// and the shared memory.
#include "flash_f32.cuh"
#include "tf32x3.cuh"

namespace nvt {
namespace {

using flash_f32::kCap;
using flash_f32::kThreads;
using flash_f32::keep_bits16;
using tf32x3::FragA;
using tf32x3::FragB;

constexpr int kRows = 64;    // rows a block: query rows (pass 1), keys (2)
constexpr int kTile = 32;    // keys a tile (pass 1), queries a tile (2)
constexpr int kWarpRows = 16;
constexpr int kNT = kTile / 8;   // 8-column MMA tiles across a tile
static_assert(kRows == kWarpRows * kThreads / 32, "a warp owns 16 rows");

// Floats between two rows of a tile: 4 (mod 32), see tf32x3.cuh.
template <int D>
constexpr int kLd = D + 4;

// k steps of S and dP (or S^T and dP^T) a fresh accumulator takes before
// it is added to their sums.
constexpr int kSteps = 2;

// Pass 2's columns of dK and dV a block: all of them, but D = 128 in two
// blocks of 64, each taking S^T and dP^T whole: a thread's 128
// accumulators of dK and dV at D = 128 left too few of 255 registers
// (ptxas spilled).
template <int D>
constexpr int kCols = D < 64 ? D : 64;

// Blocks an SM that ptxas fits a thread's registers to: pass 1 at D = 64
// in 168 (three blocks, as its shared memory allows), D = 32 and pass 2 in
// 255 / 2, pass 1 at D = 128 in 255 (one block, as its shared memory
// allows).
template <int D, int kPass>
constexpr int kMinBlocks =
    D == 64 && kPass == 1 ? 3 : (D == 128 && kPass == 1 ? 1 : 2);

template <int D>
struct DqLayout {
  static constexpr int kQ = kRows * kLd<D>;     // floats of the Q or dO tile
  static constexpr int kKV = kTile * kLd<D>;    // of a K or V stage
  static constexpr size_t kBytes =
      static_cast<size_t>(2 * kQ + 4 * kKV) * sizeof(float);
};

template <int D>
struct DkvLayout {
  static constexpr int kK = kRows * kLd<D>;     // floats of the K or V tile
  static constexpr int kQ = kTile * kLd<D>;     // of a Q or dO stage
  static constexpr int kStat = 2 * kTile;       // of a stage's l and delta
  static constexpr size_t kBytes =
      static_cast<size_t>(2 * kK + 4 * kQ + 2 * kStat) * sizeof(float);
};

// Copy rows [r0, r0 + kN) of a head (either layout) into a tile of rows
// kLd<D> apart, zero-filling rows past N.
template <int D, int kN, bool kBhnd>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      const HeadRows<kBhnd>& hr, int r0,
                                      int N) {
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < kN * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const bool valid = r0 + r < N;
    const float* from = src + hr.base +
                        static_cast<size_t>(valid ? r0 + r : 0) * hr.stride +
                        ch * 4;
    ffma::cp_async16(dst + r * kLd<D> + ch * 4, from, valid);
  }
}

// Copy a query tile's l and delta ([B, H, N] rows at bh, from q0) into
// st[0 .. 31] and st[32 .. 63], zeros past N.
__device__ __forceinline__ void stage_stats(float* st, const float* lsum,
                                            const float* delta, size_t row0,
                                            int q0, int N) {
  const int t = threadIdx.x;
  if (t >= 2 * kTile) return;
  const int q = q0 + (t % kTile);
  const bool valid = q < N;
  const float* src = (t < kTile ? lsum : delta) + row0 + (valid ? q : 0);
  ffma::cp_async4(st + t, src, valid);
}

// The 8-column tile j's element e of a 16 x 32 accumulator: its row (0 or
// 8 past the lane's g) and its column in the tile.
__device__ __forceinline__ int acc_row(int e) { return 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int j, int e) {
  return 8 * j + 2 * tf32x3::lane_t() + (e & 1);
}

// s = A B^T and dp = A2 B2^T of the warp's 16 rows wr .. of a and a2
// against the kTile rows of b and b2, all D wide (S and dP in pass 1, S^T
// and dP^T in pass 2), kSteps steps of k at a time into fresh
// accumulators.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kNT][4],
                                       float (&dp)[kNT][4], const float* a,
                                       const float* a2, const float* b,
                                       const float* b2, int wr) {
  constexpr int ld = kLd<D>;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    tf32x3::zero(s[j]);
    tf32x3::zero(dp[j]);
  }
#pragma unroll 1
  for (int k0 = 0; k0 < D; k0 += 8 * kSteps) {
    float ts[kNT][4], tdp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      tf32x3::zero(ts[j]);
      tf32x3::zero(tdp[j]);
    }
#pragma unroll
    for (int kk = k0; kk < k0 + 8 * kSteps; kk += 8) {
      FragA fa, fa2;
      tf32x3::load_a(fa, a, ld, wr, kk);
      tf32x3::load_a(fa2, a2, ld, wr, kk);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        FragB fb[2], fb2[2];
        tf32x3::load_b_nk2(fb, b, ld, 8 * j, kk);
        tf32x3::load_b_nk2(fb2, b2, ld, 8 * j, kk);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tf32x3::mma3_rz(ts[j + h], fa, fb[h]);
          tf32x3::mma3_rz(tdp[j + h], fa2, fb2[h]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      tf32x3::add_to(s[j], ts[j]);
      tf32x3::add_to(dp[j], tdp[j]);
    }
  }
}

// acc += x . B over the tile: x the warp's 16 x kTile accumulators (dS, or
// (P m)^T, dS^T) as A fragments, B the tile's kTile rows of b, columns c0
// .. c0 + kC - 1, read MN-major; each 8 columns' tile sum taken apart,
// then added to acc.
template <int kC>
__device__ __forceinline__ void product_acc(float (&acc)[kC / 8][4],
                                            const float (&x)[kNT][4],
                                            const float* b, int ld, int c0) {
  FragA xa[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) tf32x3::a_from_acc(xa[j], x[j]);
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    float d[4];
    tf32x3::zero(d);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      FragB fb;
      tf32x3::load_b_kn(fb, b, ld, 8 * j, c0 + 8 * n);
      tf32x3::mma3_rz(d, xa[j], fb);
    }
    tf32x3::add_to(acc[n], d);
  }
}

// Pass 1: delta and dQ of 64 query rows.
template <int D, bool kBhnd>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D, 1>)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lsum, float* __restrict__ delta,
                  float* __restrict__ dq, int N, int H, int q_tiles,
                  int n_valid, float scale_log2, float ds_scale, float keep,
                  uint32_t keep_q, uint64_t seed) {
  using L = DqLayout<D>;
  constexpr int ld = kLd<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + L::kQ;
  float* ks = dos + L::kQ;       // two stages
  float* vs = ks + 2 * L::kKV;   // two stages

  const int qt = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const HeadRows<kBhnd> hr(bh / H, bh % H, N, H, D);
  const int lane = threadIdx.x & 31;
  const int g = tf32x3::lane_g(), t = tf32x3::lane_t();
  const int wr = (threadIdx.x >> 5) * kWarpRows;   // the warp's rows
  const int q0 = qt * kRows;
  const size_t row0 = static_cast<size_t>(bh) * N;
  const int n_tiles = (n_valid + kTile - 1) / kTile;

  stage<D, kRows>(qs, q, hr, q0, N);
  stage<D, kRows>(dos, dout, hr, q0, N);
  stage<D, kTile>(ks, k, hr, 0, N);
  stage<D, kTile>(vs, v, hr, 0, N);
  ffma::cp_async_commit();

  // delta of the warp's row lane / 2, while the copies land: lanes 2r and
  // 2r + 1 sum the two halves of row r.
  float dl;
  {
    const int row = q0 + wr + (lane >> 1);
    float d = 0.f;
    if (row < N) {
      const size_t at = hr.base + static_cast<size_t>(row) * hr.stride +
                        (lane & 1) * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(o + at + 4 * c);
        const float4 b = *reinterpret_cast<const float4*>(dout + at + 4 * c);
        d += (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    dl = keep * d;
    if (!(lane & 1) && row < N) delta[row0 + row] = dl;
  }
  // 1 / l and delta of the thread's rows g and g + 8.
  float il[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    dlt[i] = __shfl_sync(0xffffffffu, dl, 2 * (g + 8 * i));
    il[i] = row < N ? 1.f / lsum[row0 + row] : 1.f;
  }

  float acc[D / 8][4];   // dQ: rows g, g + 8; columns 8 n + 2t, + 1
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      stage<D, kTile>(ks + (st ^ 1) * L::kKV, k, hr, (kt + 1) * kTile, N);
      stage<D, kTile>(vs + (st ^ 1) * L::kKV, v, hr, (kt + 1) * kTile, N);
      ffma::cp_async_commit();
      ffma::cp_async_wait<1>();
    } else {
      ffma::cp_async_wait<0>();
    }
    __syncthreads();

    const float* kst = ks + st * L::kKV;
    const float* vst = vs + st * L::kKV;
    float s[kNT][4], dp[kNT][4];
    scores<D>(s, dp, qs, dos, kst, vst, wr);

    // Keep bits of keys key0 + c (bit c) of the thread's rows.
    const int key0 = kt * kTile;
    uint32_t kept[2] = {0xffffffffu, 0xffffffffu};
    if (keep_q) {
      const int row = q0 + wr + (lane >> 1);
      const uint32_t mine =
          row < N ? keep_bits16((row0 + row) * N + key0 + 16 * (lane & 1),
                                seed, keep_q)
                  : 0u;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = g + 8 * i;
        kept[i] = __shfl_sync(0xffffffffu, mine, 2 * r) |
                  __shfl_sync(0xffffffffu, mine, 2 * r + 1) << 16;
      }
    }

    // dS in place of S.
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = acc_col(j, e);
        const float ex =
            exp2f(fminf(fmaxf(s[j][e] * scale_log2, -kCap), kCap));
        const float p = key0 + c < n_valid ? ex * il[i] : 0.f;
        const float dpm = (kept[i] >> c) & 1u ? dp[j][e] : 0.f;
        s[j][e] = p * (dpm - dlt[i]) * ds_scale;
      }

    // dQ += dS . K over the tile's keys.
    product_acc<D>(acc, s, kst, ld, 0);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    if (row >= N) continue;
    float* out = dq + hr.base + static_cast<size_t>(row) * hr.stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// Pass 2: dK and dV of 64 keys, columns c0 .. c0 + kCols - 1.
template <int D, bool kBhnd>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D, 2>)
    dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lsum,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int N, int H, int k_tiles,
                   int n_valid, float scale_log2, float ds_scale,
                   float inv_keep, uint32_t keep_q, uint64_t seed) {
  using L = DkvLayout<D>;
  constexpr int ld = kLd<D>, kC = kCols<D>, kParts = D / kC;
  extern __shared__ __align__(16) float smem[];
  float* kts = smem;
  float* vts = kts + L::kK;
  float* qs = vts + L::kK;        // two stages
  float* dos = qs + 2 * L::kQ;    // two stages
  float* stat = dos + 2 * L::kQ;  // two stages of [l, delta]

  const int kt = blockIdx.x % k_tiles;
  const int rest = blockIdx.x / k_tiles;
  const int c0 = rest % kParts * kC, bh = rest / kParts;
  const HeadRows<kBhnd> hr(bh / H, bh % H, N, H, D);
  const int lane = threadIdx.x & 31;
  const int g = tf32x3::lane_g(), t = tf32x3::lane_t();
  const int wr = (threadIdx.x >> 5) * kWarpRows;   // the warp's keys
  const int k0 = kt * kRows, kw = k0 + wr;
  const size_t row0 = static_cast<size_t>(bh) * N;

  if (k0 >= n_valid) {   // keys at or past n_valid have no gradient
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = threadIdx.x; c < kRows * kC / 4; c += kThreads) {
      const int row = k0 + c / (kC / 4);
      if (row >= N) continue;
      const size_t at = hr.base + static_cast<size_t>(row) * hr.stride +
                        c0 + (c % (kC / 4)) * 4;
      *reinterpret_cast<float4*>(dk + at) = zero;
      *reinterpret_cast<float4*>(dv + at) = zero;
    }
    return;
  }

  const int q_tiles = (N + kTile - 1) / kTile;
  stage<D, kRows>(kts, k, hr, k0, N);
  stage<D, kRows>(vts, v, hr, k0, N);
  stage<D, kTile>(qs, q, hr, 0, N);
  stage<D, kTile>(dos, dout, hr, 0, N);
  stage_stats(stat, lsum, delta, row0, 0, N);
  ffma::cp_async_commit();

  float adk[kC / 8][4], adv[kC / 8][4];  // rows g, g + 8; columns c0 + 8 n + 2t
#pragma unroll
  for (int n = 0; n < kC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int qt = 0; qt < q_tiles; ++qt) {
    const int st = qt & 1;
    if (qt + 1 < q_tiles) {
      const int nq = (qt + 1) * kTile;
      stage<D, kTile>(qs + (st ^ 1) * L::kQ, q, hr, nq, N);
      stage<D, kTile>(dos + (st ^ 1) * L::kQ, dout, hr, nq, N);
      stage_stats(stat + (st ^ 1) * L::kStat, lsum, delta, row0, nq, N);
      ffma::cp_async_commit();
      ffma::cp_async_wait<1>();
    } else {
      ffma::cp_async_wait<0>();
    }
    __syncthreads();

    const float* qst = qs + st * L::kQ;
    const float* dost = dos + st * L::kQ;
    const float* lst = stat + st * L::kStat;
    // S^T and dP^T: rows the warp's keys g, g + 8; columns queries.
    float s[kNT][4], dp[kNT][4];
    scores<D>(s, dp, kts, vts, qst, dost, wr);

    // Lane l's keep bits of the warp's 16 keys for query q0 + l; a thread
    // takes those of its queries 8 j + 2t + h.
    const int q0 = qt * kTile;
    uint32_t kept[kNT][2];
    {
      uint32_t mine = 0xffffu;
      if (keep_q)
        mine = q0 + lane < N
                   ? keep_bits16((row0 + q0 + lane) * N + kw, seed, keep_q)
                   : 0u;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          kept[j][h] =
              keep_q ? __shfl_sync(0xffffffffu, mine, acc_col(j, h)) : mine;
    }

    // (P m)^T in place of S^T, dS^T in place of dP^T.
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = acc_col(j, e), key = g + acc_row(e);
        const float lj = lst[qi], dj = lst[kTile + qi];
        const float ex =
            exp2f(fminf(fmaxf(s[j][e] * scale_log2, -kCap), kCap));
        const float p =
            kw + key < n_valid && q0 + qi < N ? ex / lj : 0.f;
        const bool m = (kept[j][e & 1] >> key) & 1u;
        s[j][e] = m ? p : 0.f;
        dp[j][e] = p * ((m ? dp[j][e] : 0.f) - dj) * ds_scale;
      }

    // dV += (P m)^T . dO, then dK += dS^T . Q, over the tile's queries.
    product_acc<kC>(adv, s, dost, ld, c0);
    product_acc<kC>(adk, dp, qst, ld, c0);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kw + g + 8 * i;
    if (row >= N) continue;
    const size_t at =
        hr.base + static_cast<size_t>(row) * hr.stride + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kC / 8; ++n) {
      *reinterpret_cast<float2*>(dk + at + 8 * n) =
          make_float2(adk[n][2 * i], adk[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * n) =
          make_float2(adv[n][2 * i] * inv_keep, adv[n][2 * i + 1] * inv_keep);
    }
  }
}

template <int D, bool kBhnd>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lsum,
                   float* delta, float* dq, float* dk, float* dv, int B,
                   int N, int H, int n_valid, float scale_log2,
                   float ds_scale, float keep, float inv_keep,
                   uint32_t keep_q, uint64_t seed, cudaStream_t stream) {
  const auto dq_kernel = dq_f32_kernel<D, kBhnd>;
  const auto dkv_kernel = dkv_f32_kernel<D, kBhnd>;
  cudaError_t err = allow_smem(dq_kernel, DqLayout<D>::kBytes);
  if (err == cudaSuccess) err = allow_smem(dkv_kernel, DkvLayout<D>::kBytes);
  if (err != cudaSuccess) return err;
  const unsigned tiles = (N + kRows - 1) / kRows;
  dq_kernel<<<tiles * B * H, kThreads, DqLayout<D>::kBytes, stream>>>(
      q, k, v, o, dout, lsum, delta, dq, N, H, tiles, n_valid, scale_log2,
      ds_scale, keep, keep_q, seed);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<<<tiles * (D / kCols<D>) * B * H, kThreads,
               DkvLayout<D>::kBytes, stream>>>(
      q, k, v, dout, lsum, delta, dk, dv, N, H, tiles, n_valid, scale_log2,
      ds_scale, inv_keep, keep_q, seed);
  return cudaGetLastError();
}

template <bool kBhnd>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lsum, void* delta, void* dq,
               void* dk, void* dv, int B, int N, int H, int D, int n_valid,
               float scale_log2e, float ds_scale, float keep, float inv_keep,
               int keep_q, uint64_t seed, void* stream) {
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N || keep_q < 0 ||
      keep_q > 255 ||
      2LL * ((N + kRows - 1) / kRows) * B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lsum);
  float* dl = static_cast<float*>(delta);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  const uint32_t kq = static_cast<uint32_t>(keep_q);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch<32, kBhnd>(qf, kf, vf, of, df, lf, dl, dqf, dkf, dvf, B, N,
                              H, n_valid, scale_log2e, ds_scale, keep,
                              inv_keep, kq, seed, s);
      break;
    case 64:
      err = launch<64, kBhnd>(qf, kf, vf, of, df, lf, dl, dqf, dkf, dvf, B, N,
                              H, n_valid, scale_log2e, ds_scale, keep,
                              inv_keep, kq, seed, s);
      break;
    case 128:
      err = launch<128, kBhnd>(qf, kf, vf, of, df, lf, dl, dqf, dkf, dvf, B,
                               N, H, n_valid, scale_log2e, ds_scale, keep,
                               inv_keep, kq, seed, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace nvt

// K5 at f32. q, k, v, o, dout, dq, dk, dv [B, N, H, D] f32, D in {32, 64,
// 128} (the wrapper zero-pads other head dims); lsum, delta [B, H, N] f32
// (delta is written by pass 1 and read by pass 2). scale_log2e = scale
// log2(e), ds_scale = scale / keep, keep = q / 256 and inv_keep = 1 / keep
// (1 without dropout), keep_q the dropout threshold (0 = none).
extern "C" int nvt_flash_attention_f32_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lsum, void* delta, void* dq, void* dk,
    void* dv, int B, int N, int H, int D, int n_valid, float scale_log2e,
    float ds_scale, float keep, float inv_keep, int keep_q, uint64_t seed,
    void* stream) {
  return nvt::launch_bwd<false>(q, k, v, o, dout, lsum, delta, dq, dk, dv, B,
                                N, H, D, n_valid, scale_log2e, ds_scale, keep,
                                inv_keep, keep_q, seed, stream);
}

// K6's backward at f32: the same with every [.., D] operand in
// [B, H, N, D].
extern "C" int nvt_flash_attention_bhnd_f32_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lsum, void* delta, void* dq, void* dk,
    void* dv, int B, int N, int H, int D, int n_valid, float scale_log2e,
    float ds_scale, float keep, float inv_keep, int keep_q, uint64_t seed,
    void* stream) {
  return nvt::launch_bwd<true>(q, k, v, o, dout, lsum, delta, dq, dk, dv, B,
                               N, H, D, n_valid, scale_log2e, ds_scale, keep,
                               inv_keep, keep_q, seed, stream);
}

// Dynamic shared memory of a block of pass 1 (dQ) or 2 (dK, dV) of the
// instance at head dim D, either layout (ops/flash_attention.py
// flash_f32_bwd_plan), or -1.
extern "C" long long nvt_flash_attention_f32_bwd_smem_bytes(int D,
                                                            int pass) {
  using namespace nvt;
  if (pass != 1 && pass != 2) return -1;
  switch (D) {
    case 32:
      return static_cast<long long>(pass == 1 ? DqLayout<32>::kBytes
                                              : DkvLayout<32>::kBytes);
    case 64:
      return static_cast<long long>(pass == 1 ? DqLayout<64>::kBytes
                                              : DkvLayout<64>::kBytes);
    case 128:
      return static_cast<long long>(pass == 1 ? DqLayout<128>::kBytes
                                              : DkvLayout<128>::kBytes);
    default:
      return -1;
  }
}
