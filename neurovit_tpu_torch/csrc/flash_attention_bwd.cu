// Flash attention backward, bf16, on TMA and wgmma, in two layouts:
//   bnhd [B, N, H, D] (K5): replaces the TPU kernel
//     neurovit_tpu/ops/flash_attention.py:269 (_bwd_kernel_allheads,
//     launched at :420);
//   bhnd [B, H, N, D] (K6's backward): replaces :152 (_bwd_kernel, launched
//     at :420 under the custom VJP at :467-493), the Grad-CAM probe's.
// The layout is a template parameter of both kernels below: it only changes
// the order of the tensor maps' dims. Per (b, h), with P and the dropout
// mask regenerated from q, k and the seed:
//   p     = exp2(clamp(q.k^T * scale log2 e, +-96)) * (key < n_valid) / l
//   delta = keep * sum_d(dO * O)                 per query row, f32
//   dp_m  = (dO . v^T) * mask
//   ds    = bf16(p * (dp_m - delta) * (scale / keep))
//   dq    = ds . k           dk = ds^T . q        dv = bf16(p * mask)^T . dO / keep
// l is the forward's f32 row sum (K1 or K6 write it when a graph is
// recorded). The TPU kernels hold the whole key row in VMEM and take delta =
// sum(p * dp_m) over it (:297-313, and :207 for bhnd); a GPU block holds 64
// keys, so delta comes from the row's output instead: sum_k p_k m_k (dO .
// v_k) = keep * (dO . O). Both are the same sum; this one rounds through the
// bf16 O, and the plain backward (ops/flash_attention.py) uses the same
// formula. The mask of element (b, h, q, k) is byte i % 16 of Philox4x32-10(i
// / 16, seed) at i = ((b H + h) N + q) N + k, the forward's bits.
//
// What bounds it on the H100: 7 N^2 D flops per (b, h) on the tensor cores,
// two products more than the minimum (S and dP are recomputed by each pass:
// the price of a deterministic dQ with no atomics), plus an exp2 per score
// in each pass and, in training, the Philox mask.
//
// The design, for the tensor cores (wgmma, their only path to full rate) and
// against trips through shared memory. Two kernels, each a producer warp
// that loads by TMA (rank-4 maps ordered by the layout, 128-byte swizzle,
// 64-column panels, zeros past N) and one or two consumer warpgroups of 64
// rows (flash::consumers: 128-row blocks where they fill the card's SMs);
// one-dimensional grids, a head's tiles adjacent (flash::GridTile).
//   dq_kernel   a block owns 64 or 128 query rows. The producer loads Q and
//               dO once and K and V through a kStages ring; key tiles wholly
//               past n_valid are not visited. A consumer first takes delta
//               and 1 / l for its rows (and writes delta for the second
//               pass), then per key tile: S = Q K^T and dP = dO V^T, each
//               wgmma.m64n64k16 with both operands K-major in shared memory;
//               dS formed in place on the accumulators (the forward's row
//               layout and its quad Philox window, flash::QuadWindows); dS
//               rounded to bf16 pairs is the register A operand of dQ += dS
//               K with K the MN-major B operand, as V is in the forward's P V.
//               The next tile's S and dP are issued before this tile's dQ
//               product and dS runs while it is on the tensor cores; the last
//               tile is peeled (with a wgmma issue under a condition ptxas
//               serialises the wgmmas, C7514). dQ is staged into the Q slot
//               and stored by TMA.
//   dkdv_kernel a block owns 64 or 128 keys. The producer loads K and V once
//               and, through a ring over query tiles, Q and dO by TMA and
//               the tile's 1 / l and delta by its 32 lanes (the [B, H, N]
//               statistics' rows are not 16-byte aligned for TMA).
//               Per query sub-tile of kNQ columns: S^T = K Q^T and dP^T = V
//               dO^T by wgmma.m64nNQk16, both K-major in shared memory; P^T m
//               and dS^T formed in registers (rows are keys, so a thread's
//               validity is fixed and l, delta are per column); each rounded
//               to bf16 pairs is the register A operand of dV += (P^T m) dO
//               and dK += dS^T Q, dO and Q MN-major B operands. dV is scaled
//               by 1 / keep once; dK and dV are staged into the K and V
//               slots and stored by TMA. Blocks wholly past n_valid store
//               zeros and return. The dropout bytes do not fit a quad here
//               (a thread's 32 bytes lie in 16 query rows): each warpgroup
//               fills a byte tile, for each query row the window of five
//               16-byte Philox blocks that covers its 64 keys (NQ x 5 calls
//               over 128 threads, 2.5 a thread at NQ = 64), double-buffered
//               and fenced by one named barrier a sub-tile, while the
//               previous sub-tile's products run; each thread reads its
//               bytes by position.
// Registers: pass 2 at D = 128 holds dK and dV (128 f32 a thread) besides
// S^T, dP^T and their pairs, so its sub-tiles are 32 queries (kNQ = 32,
// wgmma.m64n32k16; 176 accumulator registers); at D = 64 they are 64. With
// two consumer warpgroups the producer is a warpgroup that hands its
// registers to them (kProducerThreads below).
// Rows past N: TMA zero-fills Q and dO, and their l is taken as 1 and their
// delta as 0 (pass 1's consumers and pass 2's producer guard q < N), so
// they contribute exact zeros; TMA stores no row past N. No atomics: two
// calls on the same inputs give the same bits.
//
// D = 16 and 32 reach these kernels zero-padded to 64 by the wrapper, other
// D from 8 to 128 to 64 or 128 (flash_bwd_plan, ops/flash_attention.py).
#include "flash_attention.cuh"

namespace nvt {
namespace {

using hopper::fence_operand;
using namespace flash;

constexpr int kStages = 3;              // ring depth of both passes
constexpr int kStatBytes = 64 * 4;      // 1 / l or delta of 64 queries

// Registers. A block of 288 threads (two consumer warpgroups and a producer
// warp) gets at most 168 a thread: three warps share each of the SM's four
// 16K-register files. Both passes need more in their consumers (243 and 237
// with one consumer), so with two consumers the producer is a whole
// warpgroup that gives all but 40 of its registers to them (setmaxnreg):
// 2 x 232 + 40 of 512 a sub-partition (the kernels declare one block an
// SM, without which ptxas ignores setmaxnreg, C7508). With one consumer
// (160 threads) a thread may have 255 and the producer stays one warp.
template <int kConsumers>
constexpr int kProducerThreads = kConsumers == 2 ? 128 : 32;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared memory of a dQ block: the consumers' Q and dO tiles, the K and V
// rings, the dropout windows, the barriers, and 1 KiB of slack to align the
// tiles to the swizzle's 1024 bytes.
template <int D, int kConsumers>
struct DqPlan {
  static_assert(D == 64 || D == 128, "head dim instance");
  static constexpr int kPanels = D / 64;
  static constexpr int BQ = 64 * kConsumers;
  static constexpr int kThreads =
      128 * kConsumers + kProducerThreads<kConsumers>;
  static constexpr int kQBytes = BQ * D * 2;      // Q (or dO) of the block
  static constexpr int kKVBytes = kBKV * D * 2;   // one K or V stage
  static constexpr int kXBytes = BQ * kWindowBytes;
  static constexpr int kBarriers = 2 * kStages + 1;
  static constexpr size_t kSmemBytes =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + kXBytes + kBarriers * 8;
};

// Shared memory of a dK/dV block: the consumers' K and V tiles, the Q and
// dO rings, the statistics ring (1 / l then delta, 64 f32 each, a stage),
// the double-buffered dropout byte tiles of each consumer, the barriers.
template <int D, int kConsumers>
struct DkvPlan {
  static_assert(D == 64 || D == 128, "head dim instance");
  static constexpr int kPanels = D / 64;
  static constexpr int BK = 64 * kConsumers;
  static constexpr int kThreads =
      128 * kConsumers + kProducerThreads<kConsumers>;
  static constexpr int kNQ = D == 64 ? 64 : 32;   // queries of a sub-tile
  static constexpr int kSub = 64 / kNQ;           // sub-tiles of a stage
  static constexpr int kKBytes = BK * D * 2;      // K (or V) of the block
  static constexpr int kTileBytes = 64 * D * 2;   // one Q or dO stage
  static constexpr int kXTileBytes = kNQ * kWindowBytes;
  static constexpr int kXBytes = kConsumers * 2 * kXTileBytes;
  static constexpr int kBarriers = 2 * kStages + 1;
  static constexpr size_t kSmemBytes =
      1024 + 2 * kKBytes + 2 * kStages * kTileBytes +
      kStages * 2 * kStatBytes + kXBytes + kBarriers * 8;
};

// dS of one thread's 32 scores of a key tile, in place on the S
// accumulator s (dp: the dP accumulator), with keys at or past n_valid
// zeroed (kRagged: the tile crosses n_valid) and dP dropped where the rows'
// windows say (kDrop). acc[4 j + i] is row r + 8 (i / 2), key 8 j + 2 (t %
// 4) + i % 2 of the tile, as in the forward's softmax_tile.
template <bool kRagged, bool kDrop>
__device__ __forceinline__ void ds_tile(
    float (&s)[32], const float (&dp)[32], const float (&inv_l)[2],
    const float (&delta)[2], float scale_log2e, float ds_scale, int key0,
    int n_valid, const unsigned char* const* win, uint32_t keep_q) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int R = i / 2, e = i % 2;
      float p = capped_exp2(s[4 * j + i], scale_log2e);
      if (kRagged && key0 + 8 * j + e >= n_valid) p = 0.f;
      p *= inv_l[R];
      float d = dp[4 * j + i];
      if (kDrop && win[R][8 * j + e] >= keep_q) d = 0.f;
      s[4 * j + i] = p * (d - delta[R]) * ds_scale;
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 1: dQ and delta.
// ---------------------------------------------------------------------------
template <int D, int kConsumers, bool kBhnd>
__global__ void __launch_bounds__(DqPlan<D, kConsumers>::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tdq,
                        const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lsum,
                        float* __restrict__ delta_out, int N, int H,
                        int n_valid, float scale_log2e, float ds_scale,
                        float keep, uint32_t keep_q, uint64_t seed) {
  using P = DqPlan<D, kConsumers>;
  constexpr int kPanels = P::kPanels;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      round_up(reinterpret_cast<size_t>(smem_raw), 1024));
  unsigned char* Qs = smem;
  unsigned char* dOs = Qs + P::kQBytes;
  unsigned char* Ks = dOs + P::kQBytes;
  unsigned char* Vs = Ks + kStages * P::kKVBytes;
  unsigned char* Xs = Vs + kStages * P::kKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Xs + P::kXBytes);
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

  if (wg == kConsumers) {   // the producer: one thread issues
    if constexpr (kConsumers == 2) hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      hopper::tma_prefetch_map(&tq);
      hopper::tma_prefetch_map(&tdo);
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tv);
      hopper::mbar_expect_tx(qfull, 2 * P::kQBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int p = 0; p < kPanels; ++p) {
          const int at = (c * kPanels + p) * kPanelBytes;
          load_box<kBhnd>(Qs + at, &tq, qfull, 64 * p, q0 + 64 * c, h, b);
          load_box<kBhnd>(dOs + at, &tdo, qfull, 64 * p, q0 + 64 * c, h, b);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * P::kKVBytes);
        for (int p = 0; p < kPanels; ++p) {
          load_box<kBhnd>(Ks + s * P::kKVBytes + p * kPanelBytes, &tk,
                          &full[s], 64 * p, t * kBKV, h, b);
          load_box<kBhnd>(Vs + s * P::kKVBytes + p * kPanelBytes, &tv,
                          &full[s], 64 * p, t * kBKV, h, b);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows q0 + 64 wg .. + 63. This thread holds rows
  // r0 and r0 + 8 of them.
  if constexpr (kConsumers == 2) hopper::setmaxnreg_inc<kConsumerRegs>();
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32, quad = lane % 4;
  const int r0 = 16 * (t128 / 32) + lane / 4;
  const int qw = q0 + 64 * wg;
  unsigned char* Qw = Qs + wg * kPanels * kPanelBytes;
  const unsigned char* dOw = dOs + wg * kPanels * kPanelBytes;

  // delta = keep * (dO . O) and 1 / l of the thread's two rows: the quad
  // reads a quarter of each row, and rows past N take l = 1, delta = 0.
  const HeadRows<kBhnd> rows(b, h, N, H, D);
  float inv_l[2], delta[2];
#pragma unroll
  for (int R = 0; R < 2; ++R) {
    const int qi = qw + r0 + 8 * R;
    float s = 0.f;
    if (qi < N) {
      const size_t at = rows.base + qi * rows.stride + quad * (D / 4);
#pragma unroll
      for (int c = 0; c < D / 4; c += 8) {
        float fo[8], fd[8];
        unpack8(*reinterpret_cast<const uint4*>(o + at + c), fo);
        unpack8(*reinterpret_cast<const uint4*>(dout + at + c), fd);
#pragma unroll
        for (int i = 0; i < 8; ++i) s += fd[i] * fo[i];
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    delta[R] = s * keep;
    const size_t stat = static_cast<size_t>(bh) * N + qi;
    if (quad == 0 && qi < N) delta_out[stat] = delta[R];
    inv_l[R] = qi < N ? __fdividef(1.f, lsum[stat]) : 1.f;
  }

  const bool drop = keep_q != 0;
  QuadWindows xw(Xs + 64 * wg * kWindowBytes,
                 static_cast<uint64_t>(bh) * N + qw, N, r0, quad, drop, seed);

  float dqacc[kPanels][32];
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dqacc[p][i] = 0.f;
      fence_operand(dqacc[p][i]);
    }

  // The tile loop, software-pipelined within the warpgroup: step t issues
  // S_{t+1} and dP_{t+1} and then dQ += dS_t K_t, waits for the first two
  // alone and forms dS_{t+1} in place while dS_t K_t is on the tensor cores;
  // then it waits for that, releases tile t's stage and rounds dS_{t+1} into
  // the registers dS_t K_t read.
  float sacc[32], pacc[32];
  uint32_t pa[16];
  auto issue_sdp = [&](int t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const unsigned char* Kt = Ks + s * P::kKVBytes;
    const unsigned char* Vt = Vs + s * P::kKVBytes;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = 0.f;
      pacc[i] = 0.f;
      fence_operand(sacc[i]);
      fence_operand(pacc[i]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4;
      const uint64_t step = (kk % 4) * hopper::kDescStepK;
      hopper::Wgmma<false, 64>::mma(
          sacc, hopper::smem_desc(Qw + p * kPanelBytes) + step,
          hopper::smem_desc(Kt + p * kPanelBytes) + step);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4;
      const uint64_t step = (kk % 4) * hopper::kDescStepK;
      hopper::Wgmma<false, 64>::mma(
          pacc, hopper::smem_desc(dOw + p * kPanelBytes) + step,
          hopper::smem_desc(Vt + p * kPanelBytes) + step);
    }
    hopper::wgmma_commit();
  };
  auto wait_sdp = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_operand(sacc[i]);
      fence_operand(pacc[i]);
    }
  };
  auto form_ds = [&](int t) {
    if (drop) xw.fill(t, seed);   // this tile's windows
    const int key0 = t * kBKV + 2 * quad;
    if ((t + 1) * kBKV > n_valid) {
      if (drop)
        ds_tile<true, true>(sacc, pacc, inv_l, delta, scale_log2e, ds_scale,
                            key0, n_valid, xw.win, keep_q);
      else
        ds_tile<true, false>(sacc, pacc, inv_l, delta, scale_log2e, ds_scale,
                             key0, n_valid, xw.win, keep_q);
    } else {
      if (drop)
        ds_tile<false, true>(sacc, pacc, inv_l, delta, scale_log2e, ds_scale,
                             key0, n_valid, xw.win, keep_q);
      else
        ds_tile<false, false>(sacc, pacc, inv_l, delta, scale_log2e,
                              ds_scale, key0, n_valid, xw.win, keep_q);
    }
  };
  // dQ += dS_t K_t, dS from registers, K MN-major.
  auto issue_dq = [&](int t) {
    const unsigned char* Kt = Ks + (t % kStages) * P::kKVBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBKV / 16; ++c) {
      const uint32_t a[4] = {pa[4 * c], pa[4 * c + 1], pa[4 * c + 2],
                             pa[4 * c + 3]};
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        hopper::WgmmaRegA64::mma(
            dqacc[p], a,
            hopper::smem_desc_mn64(Kt + p * kPanelBytes + c * kKStepBytes));
    }
    hopper::wgmma_commit();
  };
  auto retire_dq = [&](int t) {
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_operand(pa[i]);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(dqacc[p][i]);
    if (t128 == 0) hopper::mbar_arrive(&empty[t % kStages]);
  };

  hopper::mbar_wait(qfull, 0);
  issue_sdp(0);
  hopper::wgmma_wait<0>();
  wait_sdp();
  form_ds(0);
  pack_pairs(sacc, pa);
  for (int t = 0; t + 1 < n_tiles; ++t) {
    issue_sdp(t + 1);
    issue_dq(t);
    hopper::wgmma_wait<1>();   // S_{t+1}, dP_{t+1}; dS_t K_t may still run
    wait_sdp();
    form_ds(t + 1);
    retire_dq(t);
    pack_pairs(sacc, pa);
  }
  issue_dq(n_tiles - 1);
  retire_dq(n_tiles - 1);

  // bf16 dQ into the Q slot (free after the last S), stored by TMA.
  stage_rows(Qw, dqacc, r0, quad, [](float x, int) { return x; });
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + wg, 128);
  if (t128 == 0 && qw < N) {
    for (int p = 0; p < kPanels; ++p)
      store_box<kBhnd>(&tdq, Qw + p * kPanelBytes, 64 * p, qw, h, b);
    hopper::tma_store_wait();
  }
}

// ---------------------------------------------------------------------------
// Pass 2: dK and dV.
// ---------------------------------------------------------------------------
template <int D, int kConsumers, bool kBhnd>
__global__ void __launch_bounds__(DkvPlan<D, kConsumers>::kThreads, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdk,
                          const __grid_constant__ CUtensorMap tdv,
                          const float* __restrict__ lsum,
                          const float* __restrict__ delta, int N, int H,
                          int n_valid, float scale_log2e,
                          float ds_scale, float inv_keep, uint32_t keep_q,
                          uint64_t seed) {
  using P = DkvPlan<D, kConsumers>;
  constexpr int kPanels = P::kPanels, kNQ = P::kNQ, kSub = P::kSub;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      round_up(reinterpret_cast<size_t>(smem_raw), 1024));
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + P::kKBytes;
  unsigned char* Qr = Vs + P::kKBytes;
  unsigned char* dOr = Qr + kStages * P::kTileBytes;
  unsigned char* Sr = dOr + kStages * P::kTileBytes;
  unsigned char* Xs = Sr + kStages * 2 * kStatBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Xs + P::kXBytes);
  uint64_t* empty = full + kStages;
  uint64_t* kvfull = empty + kStages;

  const GridTile g((N + P::BK - 1) / P::BK, H);
  const int bh = g.bh, b = g.b, h = g.h;
  const int k0 = g.tile * P::BK;
  const int n_qtiles = (N + 63) / 64;
  const int wg = threadIdx.x / 128;
  const bool past = k0 >= n_valid;   // every key of the block is masked

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA bytes with one arrival, then one arrival a producer lane
      // once its statistics are in place
      hopper::mbar_init(&full[s], 1 + 32);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_init(kvfull, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {   // the producer: its first warp
    if constexpr (kConsumers == 2) hopper::setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x % 128;   // < 32: the first warp's lanes
    if (lane < 32 && !past) {
      if (lane == 0) {
        hopper::tma_prefetch_map(&tk);
        hopper::tma_prefetch_map(&tv);
        hopper::tma_prefetch_map(&tq);
        hopper::tma_prefetch_map(&tdo);
        hopper::mbar_expect_tx(kvfull, 2 * P::kKBytes);
        for (int c = 0; c < kConsumers; ++c)
          for (int p = 0; p < kPanels; ++p) {
            const int at = (c * kPanels + p) * kPanelBytes;
            load_box<kBhnd>(Ks + at, &tk, kvfull, 64 * p, k0 + 64 * c, h, b);
            load_box<kBhnd>(Vs + at, &tv, kvfull, 64 * p, k0 + 64 * c, h, b);
          }
      }
      const size_t stat0 = static_cast<size_t>(bh) * N;
      for (int t = 0; t < n_qtiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[s], 2 * P::kTileBytes);
          for (int p = 0; p < kPanels; ++p) {
            load_box<kBhnd>(Qr + s * P::kTileBytes + p * kPanelBytes, &tq,
                            &full[s], 64 * p, 64 * t, h, b);
            load_box<kBhnd>(dOr + s * P::kTileBytes + p * kPanelBytes, &tdo,
                            &full[s], 64 * p, 64 * t, h, b);
          }
        }
        // The tile's 1 / l and delta (one reciprocal a query here, not
        // one a column in every consumer); rows past N take l = 1 and
        // delta = 0.
        float* st = reinterpret_cast<float*>(Sr + s * 2 * kStatBytes);
        for (int r = lane; r < 64; r += 32) {
          const int q = 64 * t + r;
          st[r] = q < N ? __fdividef(1.f, lsum[stat0 + q]) : 1.f;
          st[64 + r] = q < N ? delta[stat0 + q] : 0.f;
        }
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // A consumer warpgroup: keys kw .. kw + 63. This thread holds keys kw +
  // r0 and kw + r0 + 8, query columns 8 j + 2 (t % 4) + {0, 1} of each
  // sub-tile.
  if constexpr (kConsumers == 2) hopper::setmaxnreg_inc<kConsumerRegs>();
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32, quad = lane % 4;
  const int r0 = 16 * (t128 / 32) + lane / 4;
  const int kw = k0 + 64 * wg;
  unsigned char* Kw = Ks + wg * kPanels * kPanelBytes;
  unsigned char* Vw = Vs + wg * kPanels * kPanelBytes;
  unsigned char* Xw = Xs + wg * 2 * P::kXTileBytes;

  float dkacc[kPanels][32], dvacc[kPanels][32];
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dkacc[p][i] = 0.f;
      dvacc[p][i] = 0.f;
      fence_operand(dkacc[p][i]);
      fence_operand(dvacc[p][i]);
    }
  // bf16 dK and dV / keep into the K and V slots (free after the last
  // product), stored by TMA.
  const CUtensorMap* map_dk = &tdk;
  const CUtensorMap* map_dv = &tdv;
  auto store = [&]() {
    stage_rows(Kw, dkacc, r0, quad, [](float x, int) { return x; });
    stage_rows(Vw, dvacc, r0, quad,
               [inv_keep](float x, int) { return x * inv_keep; });
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
    if (t128 == 0 && kw < N) {
      for (int p = 0; p < kPanels; ++p) {
        store_box<kBhnd>(map_dk, Kw + p * kPanelBytes, 64 * p, kw, h, b);
        store_box<kBhnd>(map_dv, Vw + p * kPanelBytes, 64 * p, kw, h, b);
      }
      hopper::tma_store_wait();
    }
  };
  if (past) {   // keys past n_valid have p = 0 in every row
    store();
    return;
  }

  const bool valid[2] = {kw + r0 < n_valid, kw + r0 + 8 < n_valid};
  const bool drop = keep_q != 0;
  const uint64_t row0 = static_cast<uint64_t>(bh) * N;   // query 0's row

  // Sub-tile u: query tile u / kSub, columns (u % kSub) kNQ .. + kNQ - 1.
  float sacc[kNQ / 2], pacc[kNQ / 2];
  uint32_t pm[kNQ / 4], pd[kNQ / 4];
  auto issue_sdp = [&](int u) {
    const int t = u / kSub, s = t % kStages;
    const int sub = (u % kSub) * kNQ * kRowBytes;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const unsigned char* Qt = Qr + s * P::kTileBytes + sub;
    const unsigned char* dOt = dOr + s * P::kTileBytes + sub;
#pragma unroll
    for (int i = 0; i < kNQ / 2; ++i) {
      sacc[i] = 0.f;
      pacc[i] = 0.f;
      fence_operand(sacc[i]);
      fence_operand(pacc[i]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4;
      const uint64_t step = (kk % 4) * hopper::kDescStepK;
      hopper::Wgmma<false, kNQ>::mma(
          sacc, hopper::smem_desc(Kw + p * kPanelBytes) + step,
          hopper::smem_desc(Qt + p * kPanelBytes) + step);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4;
      const uint64_t step = (kk % 4) * hopper::kDescStepK;
      hopper::Wgmma<false, kNQ>::mma(
          pacc, hopper::smem_desc(Vw + p * kPanelBytes) + step,
          hopper::smem_desc(dOt + p * kPanelBytes) + step);
    }
    hopper::wgmma_commit();
  };
  auto wait_sdp = [&]() {
#pragma unroll
    for (int i = 0; i < kNQ / 2; ++i) {
      fence_operand(sacc[i]);
      fence_operand(pacc[i]);
    }
  };
  // The byte tile of sub-tile u, into buffer u % 2: for each query row c,
  // the five Philox blocks from the one that holds key kw's byte. Block n
  // of the tile is row n / 5, slot n % 5; thread t computes blocks t, t +
  // 128, ...
  auto fill_bytes = [&](int u) {
    unsigned char* xt = Xw + (u & 1) * P::kXTileBytes;
    const uint64_t q = row0 + (u / kSub) * 64 + (u % kSub) * kNQ;
    for (int n = t128; n < kNQ * 5; n += 128) {
      const int c = n / 5, slot = n - 5 * c;
      const uint64_t i0 = (q + c) * static_cast<uint64_t>(N) + kw;
      *reinterpret_cast<uint4*>(xt + c * kWindowBytes + 16 * slot) =
          philox4x32_10((i0 >> 4) + slot, seed);
    }
  };
  // P^T m into pacc and dS^T into sacc, in place: acc[4 j + i] is key row
  // r0 + 8 (i / 2), query column 8 j + 2 (t % 4) + i % 2 of the sub-tile.
  auto form_ds = [&](int u) {
    const int t = u / kSub, s = t % kStages;
    const int cq = (u % kSub) * kNQ;     // the sub-tile's first column
    const float* inv_lt =
        reinterpret_cast<const float*>(Sr + s * 2 * kStatBytes) + cq;
    const float* dlt = inv_lt + 64;
    const unsigned char* xt = Xw + (u & 1) * P::kXTileBytes + r0;
    const int q0 = 64 * t + cq;
    const uint32_t row_lo = static_cast<uint32_t>(row0 + q0);
#pragma unroll
    for (int j = 0; j < kNQ / 8; ++j) {
      const int c0 = 8 * j + 2 * quad;
      const float2 inv2 = *reinterpret_cast<const float2*>(inv_lt + c0);
      const float2 dl2 = *reinterpret_cast<const float2*>(dlt + c0);
      const float inv[2] = {inv2.x, inv2.y}, dl[2] = {dl2.x, dl2.y};
      uint32_t keep[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + e;
        if (drop) {
          // the row's byte offset: i0 mod 16, from i0's low word
          const uint32_t off =
              ((row_lo + c) * static_cast<uint32_t>(N) +
               static_cast<uint32_t>(kw)) & 15u;
          const unsigned char* w = xt + c * kWindowBytes + off;
          keep[0][e] = w[0] < keep_q;
          keep[1][e] = w[8] < keep_q;
        } else {
          keep[0][e] = keep[1][e] = 1u;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int R = i / 2, e = i % 2;
        const float p =
            valid[R] ? capped_exp2(sacc[4 * j + i], scale_log2e) * inv[e]
                     : 0.f;
        const float d = keep[R][e] ? pacc[4 * j + i] : 0.f;
        sacc[4 * j + i] = p * (d - dl[e]) * ds_scale;
        pacc[4 * j + i] = keep[R][e] ? p : 0.f;
      }
    }
  };
  // dV += (P^T m) dO and dK += dS^T Q, A from registers, dO and Q MN-major.
  auto issue_dkdv = [&](int u) {
    const int s = (u / kSub) % kStages;
    const int sub = (u % kSub) * kNQ * kRowBytes;
    const unsigned char* Qt = Qr + s * P::kTileBytes + sub;
    const unsigned char* dOt = dOr + s * P::kTileBytes + sub;
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kNQ / 16; ++c) {
      const uint32_t am[4] = {pm[4 * c], pm[4 * c + 1], pm[4 * c + 2],
                              pm[4 * c + 3]};
      const uint32_t as[4] = {pd[4 * c], pd[4 * c + 1], pd[4 * c + 2],
                              pd[4 * c + 3]};
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        hopper::WgmmaRegA64::mma(
            dvacc[p], am,
            hopper::smem_desc_mn64(dOt + p * kPanelBytes + c * kKStepBytes));
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        hopper::WgmmaRegA64::mma(
            dkacc[p], as,
            hopper::smem_desc_mn64(Qt + p * kPanelBytes + c * kKStepBytes));
    }
    hopper::wgmma_commit();
  };
  auto retire_dkdv = [&](int u) {
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kNQ / 4; ++i) {
      fence_operand(pm[i]);
      fence_operand(pd[i]);
    }
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fence_operand(dkacc[p][i]);
        fence_operand(dvacc[p][i]);
      }
    if (u % kSub == kSub - 1 && t128 == 0)
      hopper::mbar_arrive(&empty[(u / kSub) % kStages]);
  };
  auto pack = [&]() {
    pack_pairs(pacc, pm);
    pack_pairs(sacc, pd);
  };

  // The sub-tile loop, pipelined as pass 1's: step u issues S^T, dP^T of
  // u + 1 and then the dK, dV products of u, fills u + 1's byte tile while
  // they run, and forms u + 1's operands once its S^T and dP^T are done.
  const int n_units = n_qtiles * kSub;
  hopper::mbar_wait(kvfull, 0);
  if (drop) {
    fill_bytes(0);
    hopper::named_barrier(1 + wg, 128);
  }
  issue_sdp(0);
  hopper::wgmma_wait<0>();
  wait_sdp();
  form_ds(0);
  pack();
  for (int u = 0; u + 1 < n_units; ++u) {
    issue_sdp(u + 1);
    issue_dkdv(u);
    if (drop) {   // every thread is past sub-tile u - 1's reads
      fill_bytes(u + 1);
      hopper::named_barrier(1 + wg, 128);
    }
    hopper::wgmma_wait<1>();   // S^T, dP^T of u + 1; u's products may run
    wait_sdp();
    form_ds(u + 1);
    retire_dkdv(u);
    pack();
  }
  issue_dkdv(n_units - 1);
  retire_dkdv(n_units - 1);
  store();
}

template <int D, int kConsumers, bool kBhnd>
cudaError_t launch_plan(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lsum,
                        void* delta, void* dq, void* dk, void* dv, int B,
                        int N, int H, int n_valid, float scale_log2e,
                        float ds_scale, float keep, float inv_keep,
                        int keep_q, uint64_t seed, cudaStream_t stream) {
  using P1 = DqPlan<D, kConsumers>;
  using P2 = DkvPlan<D, kConsumers>;
  const cuuint64_t e = 2;   // bytes of a bf16
  const cuuint64_t dims[4] = {
      cuuint64_t(D), cuuint64_t(kBhnd ? N : H), cuuint64_t(kBhnd ? H : N),
      cuuint64_t(B)};
  const cuuint64_t strides[3] = {D * e, dims[1] * D * e,
                                 dims[2] * dims[1] * D * e};
  const cuuint32_t box[4] = {64, kBhnd ? 64u : 1u, kBhnd ? 1u : 64u, 1};
  // Every map of both passes, encoded once: q, k, v, dO, dq, dk, dv.
  CUtensorMap maps[7];
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  for (int i = 0; i < 7; ++i) {
    const cudaError_t err =
        hopper::encode_bf16_4d(&maps[i], ptrs[i], dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  const auto dq_kernel = flash_bwd_dq_kernel<D, kConsumers, kBhnd>;
  const auto dkdv_kernel = flash_bwd_dkdv_kernel<D, kConsumers, kBhnd>;
  cudaError_t err = allow_smem(dq_kernel, P1::kSmemBytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(dkdv_kernel, P2::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid1(((N + P1::BQ - 1) / P1::BQ) * B * H);
  dq_kernel<<<grid1, P1::kThreads, P1::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lsum), static_cast<float*>(delta), N, H,
      n_valid, scale_log2e, ds_scale, keep, static_cast<uint32_t>(keep_q),
      seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2(((N + P2::BK - 1) / P2::BK) * B * H);
  dkdv_kernel<<<grid2, P2::kThreads, P2::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[5], maps[6],
      static_cast<const float*>(lsum), static_cast<const float*>(delta), N,
      H, n_valid, scale_log2e, ds_scale, inv_keep,
      static_cast<uint32_t>(keep_q), seed);
  return cudaGetLastError();
}

template <int D, bool kBhnd>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lsum,
                     void* delta, void* dq, void* dk, void* dv, int B, int N,
                     int H, int n_valid, float scale_log2e, float ds_scale,
                     float keep, float inv_keep, int keep_q, uint64_t seed,
                     cudaStream_t stream) {
  return consumers(B, N, H) == 2
             ? launch_plan<D, 2, kBhnd>(q, k, v, o, dout, lsum, delta, dq,
                                        dk, dv, B, N, H, n_valid,
                                        scale_log2e, ds_scale, keep,
                                        inv_keep, keep_q, seed, stream)
             : launch_plan<D, 1, kBhnd>(q, k, v, o, dout, lsum, delta, dq,
                                        dk, dv, B, N, H, n_valid,
                                        scale_log2e, ds_scale, keep,
                                        inv_keep, keep_q, seed, stream);
}

template <bool kBhnd>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lsum, void* delta, void* dq,
               void* dk, void* dv, int B, int N, int H, int D, int n_valid,
               float scale_log2e, float ds_scale, float keep, float inv_keep,
               int keep_q, uint64_t seed, void* stream) {
  // The grids' x and the statistics' row indices are 32-bit.
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N || keep_q < 0 ||
      keep_q > 255 ||
      static_cast<long long>(B) * H * ((N + 63) / 64) * 64 > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch_d<64, kBhnd>(
          q, k, v, o, dout, lsum, delta, dq, dk, dv, B, N, H, n_valid,
          scale_log2e, ds_scale, keep, inv_keep, keep_q, seed, s));
    case 128:
      return static_cast<int>(launch_d<128, kBhnd>(
          q, k, v, o, dout, lsum, delta, dq, dk, dv, B, N, H, n_valid,
          scale_log2e, ds_scale, keep, inv_keep, keep_q, seed, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace nvt

// K5. q, k, v, o, dout, dq, dk, dv: [B, N, H, D] bf16, contiguous, D in
// {64, 128} (the wrapper zero-pads other head dims); lsum: [B, H, N] f32
// from the forward; delta: [B, H, N] f32 scratch. 1 <= n_valid <= N, B * H
// * N rounded up to 64 < 2^31. keep_q 0 = no dropout (keep = inv_keep = 1).
extern "C" int nvt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lsum, void* delta, void* dq, void* dk,
    void* dv, int B, int N, int H, int D, int n_valid, float scale_log2e,
    float ds_scale, float keep, float inv_keep, int keep_q, uint64_t seed,
    void* stream) {
  return nvt::launch_bwd<false>(q, k, v, o, dout, lsum, delta, dq, dk, dv, B,
                                N, H, D, n_valid, scale_log2e, ds_scale, keep,
                                inv_keep, keep_q, seed, stream);
}

// K6's backward: the same with every [.., D] operand in [B, H, N, D].
extern "C" int nvt_flash_attention_bhnd_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lsum, void* delta, void* dq, void* dk,
    void* dv, int B, int N, int H, int D, int n_valid, float scale_log2e,
    float ds_scale, float keep, float inv_keep, int keep_q, uint64_t seed,
    void* stream) {
  return nvt::launch_bwd<true>(q, k, v, o, dout, lsum, delta, dq, dk, dv, B,
                               N, H, D, n_valid, scale_log2e, ds_scale, keep,
                               inv_keep, keep_q, seed, stream);
}

// Rows per block of both passes at (B, N, H): 128 or 64.
extern "C" int nvt_flash_bwd_block_rows(int B, int N, int H) {
  return 64 * nvt::flash::consumers(B, N, H);
}

// Dynamic shared memory of one block of pass 1 (dQ) or 2 (dK, dV) at head
// dim d (64 or 128) and `rows` rows a block (64 or 128), or -1 for an
// instance there is not.
extern "C" long long nvt_flash_bwd_smem_bytes(int d, int rows, int pass) {
  using nvt::DkvPlan;
  using nvt::DqPlan;
  const bool p1 = pass == 1;
  if (pass != 1 && pass != 2) return -1;
  if (d == 64 && rows == 64)
    return p1 ? DqPlan<64, 1>::kSmemBytes : DkvPlan<64, 1>::kSmemBytes;
  if (d == 64 && rows == 128)
    return p1 ? DqPlan<64, 2>::kSmemBytes : DkvPlan<64, 2>::kSmemBytes;
  if (d == 128 && rows == 64)
    return p1 ? DqPlan<128, 1>::kSmemBytes : DkvPlan<128, 1>::kSmemBytes;
  if (d == 128 && rows == 128)
    return p1 ? DqPlan<128, 2>::kSmemBytes : DkvPlan<128, 2>::kSmemBytes;
  return -1;
}
