// Flash attention forward, bf16, on TMA and wgmma, in two layouts:
//   bnhd [B, N, H, D] (K1): replaces the TPU kernel
//     neurovit_tpu/ops/flash_attention.py:233 (_fwd_kernel_allheads,
//     launched at :381 by flash_attention(layout="bnhd"));
//   bhnd [B, H, N, D] (K6): replaces :91 (_fwd_kernel, launched at :381 by
//     flash_attention(layout="bhnd"), the Grad-CAM probe's attention).
// The layout is a template parameter: it only changes the order of the
// tensor maps' dims. K6 reads and writes [B, H, N, D] in place.
// Same arithmetic, per (b, h) and query row:
//   s = q . k^T * (scale * log2 e)               f32 accumulation
//   p = exp2(clamp(s, -96, 96)) * (key < n_valid) f32
//   denom = sum(p)                                f32, before dropout
//   p = p * mask                                  training only (:258-262)
//   o = bf16((bf16(p) . v) / (denom * keep))
// The +-96 clamp replaces the row-max subtraction (flash_attention.py:39-45),
// so the key loop only sums: no online-softmax rescaling. The dropout mask
// of element (b, h, q, k) is byte i % 16 of Philox4x32-10(i / 16, seed) at
// i = ((b*H + h)*N + q)*N + k (nn.py, random_bytes): a function of
// position, so the backward (flash_attention_bwd.cu) regenerates it under
// its own tiling, and K1 and K6 draw the same bits. When a graph is
// recorded (training, Grad-CAM) the kernel also writes the f32 row sum
// denom per (b, h, q), the backward's row statistic.
//
// What bounds it on the H100: 4 N^2 D flops per (b, h) against 4 N D * 2
// bytes, about 500 flops a byte at N = 1001, so not HBM but the tensor
// cores (989 bf16 TFLOP/s) and, as much, the exp2 units: N^2 exponentials
// per (b, h) on 16 MUFU lanes per SM take as long as the products at
// D = 64 (0.015 ms against 0.0166 at the flagship's batch 8).
//
// The design, for the tensor cores: wgmma, their only path to full rate.
// A block of 64 or 128 query rows (kConsumers = 1 or 2 consumer
// warpgroups of 64 rows, plus one producer warp) walks the keys in tiles
// of 64. The producer loads each consumer's Q tile once and K/V tiles
// through a kStages ring by TMA, with full/empty mbarriers as
// hopper_gemm.cuh's Mainloop; the maps are rank 4, ordered by the layout,
// so a box never crosses a head and TMA zero-fills keys and queries past
// N. Every tile is 128-byte swizzled, in 64-column panels (D = 128 is two).
// S = Q K^T is wgmma.m64n64k16 with both operands K-major in shared memory.
// P stays in registers: the f32 accumulator of S, rounded to bf16 pairs, is
// the register A operand of O += P V (WgmmaRegA64), whose B is V as loaded,
// MN-major, through the transpose-B immediate: no transpose and no trip
// through shared memory for S or P. O accumulates in registers, is divided
// once, staged into the warpgroup's own Q slot (free after its last QK^T)
// in the swizzled layout and stored by TMA, which writes no row past N.
//
// For the exp2 units and the dropout's integer work: the softmax runs on
// the accumulator where it lies (thread t holds rows r = 16 (t / 32) +
// (t % 32) / 4 and r + 8, keys 8 j + 2 (t % 4) + {0, 1}); the key mask is
// applied only on the tile that crosses n_valid, and tiles wholly past it
// are not visited; exp2 is one MUFU op (ex2.approx.ftz). Half of the
// exponentials run under the warpgroup's own tensor-core work: it issues
// the next tile's QK^T and this tile's P V together and runs the next
// tile's softmax, in place on the f32 accumulator, while P V runs; the
// rounding to bf16 P waits for P V to release its registers. (The last
// tile is peeled off the loop: with the issue of QK^T under a condition,
// ptxas reported the wgmmas serialised, C7514, and the kernel ran slower.)
// With two consumer warpgroups, one's softmax also runs under the other's
// wgmmas. The Philox blocks of a row are shared within the quad that holds
// the row (QuadWindows, flash_attention.cuh): two Philox calls per thread
// per tile, where each thread computing its own would make eight to ten
// (its 16 keys of a row touch four or five blocks), and no data-dependent
// branch. The grid is one-dimensional, a head's q tiles adjacent
// (GridTile), so B * H is not bounded by the grid's y.
//
// D = 16 and 32 reach this kernel zero-padded to 64 by the wrapper (the
// 128-byte swizzle row is 64 bf16), other D from 8 to 128 to 64 or 128.
#include "flash_attention.cuh"

namespace nvt {
namespace {

using hopper::fence_operand;
using namespace flash;

constexpr int kStages = 3;                   // K/V ring depth

// Shared memory of one block: the consumers' Q tiles, the K and V rings,
// the dropout windows, the barriers, and 1 KiB of slack to align the tiles
// to the swizzle's 1024 bytes.
template <int D, int kConsumers>
struct FwdPlan {
  static_assert(D == 64 || D == 128, "head dim instance");
  static constexpr int kPanels = D / 64;
  static constexpr int BQ = 64 * kConsumers;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kQBytes = BQ * D * 2;
  static constexpr int kKVBytes = kBKV * D * 2;   // one K or V stage
  static constexpr int kXBytes = BQ * kWindowBytes;
  static constexpr int kBarriers = 2 * kStages + 1;
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * kStages * kKVBytes + kXBytes + kBarriers * 8;
};

// p = exp2(clamp(s * scale_log2e)) of one thread's 32 scores, in place,
// with keys at or past n_valid zeroed (kRagged: the tile crosses n_valid),
// summed into rowsum before dropout; then the dropout mask from the rows'
// windows. acc[4 j + i] is row r + 8 (i / 2), key 8 j + 2 (t % 4) + i % 2
// of the tile.
template <bool kRagged, bool kDrop>
__device__ __forceinline__ void softmax_tile(
    float (&acc)[32], float (&rowsum)[2], float scale_log2e, int key0,
    int n_valid, const unsigned char* const* win, uint32_t keep_q) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int R = i / 2, e = i % 2;
      float p = capped_exp2(acc[4 * j + i], scale_log2e);
      if (kRagged && key0 + 8 * j + e >= n_valid) p = 0.f;
      rowsum[R] += p;
      if (kDrop && win[R][8 * j + e] >= keep_q) p = 0.f;
      acc[4 * j + i] = p;
    }
  }
}

template <int D, int kConsumers, bool kBhnd>
__global__ void __launch_bounds__(FwdPlan<D, kConsumers>::kThreads)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to, int N, int H,
                     int n_valid, float scale_log2e, float keep,
                     uint32_t keep_q, uint64_t seed, float* __restrict__ lsum) {
  using P = FwdPlan<D, kConsumers>;
  constexpr int kPanels = P::kPanels;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      round_up(reinterpret_cast<size_t>(smem_raw), 1024));
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + P::kQBytes;
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

  if (wg == kConsumers) {   // the producer warp: one thread issues
    if (threadIdx.x % 32 == 0) {
      hopper::tma_prefetch_map(&tq);
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tv);
      hopper::mbar_expect_tx(qfull, P::kQBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int p = 0; p < kPanels; ++p)
          load_box<kBhnd>(Qs + (c * kPanels + p) * kPanelBytes, &tq, qfull,
                          64 * p, q0 + 64 * c, h, b);
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
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32, quad = lane % 4;
  const int r0 = 16 * (t128 / 32) + lane / 4;
  const int qw = q0 + 64 * wg;
  unsigned char* Qw = Qs + wg * kPanels * kPanelBytes;

  // Dropout: the quad's shared Philox windows of the thread's two rows.
  const bool drop = keep_q != 0;
  QuadWindows xw(Xs + 64 * wg * kWindowBytes,
                 static_cast<uint64_t>(bh) * N + qw, N, r0, quad, drop, seed);

  float oacc[kPanels][32];
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      oacc[p][i] = 0.f;
      fence_operand(oacc[p][i]);
    }
  float rowsum[2] = {0.f, 0.f};

  // The tile loop, software-pipelined within the warpgroup: step t issues
  // S_{t+1} = Q K_{t+1}^T and then O += P_t V_t, waits for S_{t+1} alone,
  // and runs tile t + 1's softmax in place while P_t V_t is on the tensor
  // cores; then it waits for P_t V_t, releases tile t's stage and rounds
  // P_{t+1} into the registers P_t V_t read.
  float sacc[32];
  uint32_t pa[16];
  auto issue_s = [&](int t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const unsigned char* Kt = Ks + s * P::kKVBytes;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = 0.f;
      fence_operand(sacc[i]);
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
    hopper::wgmma_commit();
  };
  auto softmax = [&](int t) {
    if (drop) xw.fill(t, seed);   // this tile's windows
    const int key0 = t * kBKV + 2 * quad;
    if ((t + 1) * kBKV > n_valid) {
      if (drop)
        softmax_tile<true, true>(sacc, rowsum, scale_log2e, key0, n_valid,
                                 xw.win, keep_q);
      else
        softmax_tile<true, false>(sacc, rowsum, scale_log2e, key0, n_valid,
                                  xw.win, keep_q);
    } else {
      if (drop)
        softmax_tile<false, true>(sacc, rowsum, scale_log2e, key0, n_valid,
                                  xw.win, keep_q);
      else
        softmax_tile<false, false>(sacc, rowsum, scale_log2e, key0, n_valid,
                                   xw.win, keep_q);
    }
  };

  // O += P_t V_t, P from registers, V MN-major.
  auto issue_pv = [&](int t) {
    const unsigned char* Vt = Vs + (t % kStages) * P::kKVBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBKV / 16; ++c) {
      const uint32_t a[4] = {pa[4 * c], pa[4 * c + 1], pa[4 * c + 2],
                             pa[4 * c + 3]};
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        hopper::WgmmaRegA64::mma(
            oacc[p], a,
            hopper::smem_desc_mn64(Vt + p * kPanelBytes + c * kKStepBytes));
    }
    hopper::wgmma_commit();
  };
  // After P_t V_t: the registers it read and wrote are the thread's again,
  // and tile t's stage goes back to the producer.
  auto retire_pv = [&](int t) {
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_operand(pa[i]);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(oacc[p][i]);
    if (t128 == 0) hopper::mbar_arrive(&empty[t % kStages]);
  };

  hopper::mbar_wait(qfull, 0);
  issue_s(0);
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_operand(sacc[i]);
  softmax(0);
  pack_pairs(sacc, pa);
  for (int t = 0; t + 1 < n_tiles; ++t) {
    issue_s(t + 1);
    issue_pv(t);
    hopper::wgmma_wait<1>();   // S_{t+1}; P_t V_t may still run
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(sacc[i]);
    softmax(t + 1);
    retire_pv(t);
    pack_pairs(sacc, pa);
  }
  issue_pv(n_tiles - 1);
  retire_pv(n_tiles - 1);

  // Row sums over the quad; the epilogue.
#pragma unroll
  for (int R = 0; R < 2; ++R) {
    rowsum[R] += __shfl_xor_sync(0xffffffffu, rowsum[R], 1);
    rowsum[R] += __shfl_xor_sync(0xffffffffu, rowsum[R], 2);
    const int qi = qw + r0 + 8 * R;
    if (lsum != nullptr && quad == 0 && qi < N)
      lsum[static_cast<size_t>(bh) * N + qi] = rowsum[R];
  }
  const float denom[2] = {rowsum[0] * keep, rowsum[1] * keep};
  // bf16 O into the Q slot, 128-byte swizzled, stored by TMA.
  stage_rows(Qw, oacc, r0, quad,
             [&](float x, int R) { return x / denom[R]; });
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + wg, 128);
  if (t128 == 0 && qw < N) {
    for (int p = 0; p < kPanels; ++p)
      store_box<kBhnd>(&to, Qw + p * kPanelBytes, 64 * p, qw, h, b);
    hopper::tma_store_wait();
  }
}

template <int D, int kConsumers, bool kBhnd>
cudaError_t launch_plan(const void* q, const void* k, const void* v, void* o,
                        int B, int N, int H, int n_valid, float scale_log2e,
                        float keep, int keep_q, uint64_t seed, void* lsum,
                        cudaStream_t stream) {
  using P = FwdPlan<D, kConsumers>;
  const cuuint64_t e = 2;   // bytes of a bf16
  const cuuint64_t dims[4] = {
      cuuint64_t(D), cuuint64_t(kBhnd ? N : H), cuuint64_t(kBhnd ? H : N),
      cuuint64_t(B)};
  const cuuint64_t strides[3] = {D * e, dims[1] * D * e,
                                 dims[2] * dims[1] * D * e};
  const cuuint32_t box[4] = {64, kBhnd ? 64u : 1u, kBhnd ? 1u : 64u, 1};
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err =
        hopper::encode_bf16_4d(&maps[i], ptrs[i], dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  const auto kernel = flash_fwd_kernel<D, kConsumers, kBhnd>;
  cudaError_t err = allow_smem(kernel, P::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((N + P::BQ - 1) / P::BQ) * B * H);
  kernel<<<grid, P::kThreads, P::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], N, H, n_valid, scale_log2e, keep,
      static_cast<uint32_t>(keep_q), seed, static_cast<float*>(lsum));
  return cudaGetLastError();
}

template <int D, bool kBhnd>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int N, int H, int n_valid, float scale_log2e,
                     float keep, int keep_q, uint64_t seed, void* lsum,
                     cudaStream_t stream) {
  return consumers(B, N, H) == 2
             ? launch_plan<D, 2, kBhnd>(q, k, v, o, B, N, H, n_valid,
                                        scale_log2e, keep, keep_q, seed, lsum,
                                        stream)
             : launch_plan<D, 1, kBhnd>(q, k, v, o, B, N, H, n_valid,
                                        scale_log2e, keep, keep_q, seed, lsum,
                                        stream);
}

template <bool kBhnd>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B,
               int N, int H, int D, int n_valid, float scale_log2e,
               float keep, int keep_q, uint64_t seed, void* lsum,
               void* stream) {
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N || keep_q < 0 ||
      keep_q > 255 ||
      static_cast<long long>(B) * H * ((N + 63) / 64) > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch_d<64, kBhnd>(
          q, k, v, o, B, N, H, n_valid, scale_log2e, keep, keep_q, seed, lsum,
          s));
    case 128:
      return static_cast<int>(launch_d<128, kBhnd>(
          q, k, v, o, B, N, H, n_valid, scale_log2e, keep, keep_q, seed, lsum,
          s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace nvt

// K1. q, k, v, o: [B, N, H, D] bf16, contiguous, D in {64, 128} (the
// wrapper zero-pads other head dims). 1 <= n_valid <= N, B * H *
// ceil(N / 64) < 2^31 (the grid's x).
// keep_q: dropout threshold q of keep = q / 256, 0 for no dropout (then
// keep = 1). lsum: [B, H, N] f32 row sums, or null (serving).
extern "C" int nvt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int B, int N,
                                       int H, int D, int n_valid,
                                       float scale_log2e, float keep,
                                       int keep_q, uint64_t seed, void* lsum,
                                       void* stream) {
  return nvt::launch_fwd<false>(q, k, v, o, B, N, H, D, n_valid, scale_log2e,
                                keep, keep_q, seed, lsum, stream);
}

// K6: the same with q, k, v, o in [B, H, N, D].
extern "C" int nvt_flash_attention_bhnd_fwd(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int N, int H, int D, int n_valid,
                                            float scale_log2e, float keep,
                                            int keep_q, uint64_t seed,
                                            void* lsum, void* stream) {
  return nvt::launch_fwd<true>(q, k, v, o, B, N, H, D, n_valid, scale_log2e,
                               keep, keep_q, seed, lsum, stream);
}

// Query rows per block of a launch at (B, N, H): 128 or 64.
extern "C" int nvt_flash_fwd_block_rows(int B, int N, int H) {
  return 64 * nvt::flash::consumers(B, N, H);
}

// Dynamic shared memory of one block of the forward at head dim d (64 or
// 128) and bq query rows (64 or 128), or -1 for an instance there is not.
extern "C" long long nvt_flash_fwd_smem_bytes(int d, int bq) {
  using nvt::FwdPlan;
  if (d == 64 && bq == 64) return FwdPlan<64, 1>::kSmemBytes;
  if (d == 64 && bq == 128) return FwdPlan<64, 2>::kSmemBytes;
  if (d == 128 && bq == 64) return FwdPlan<128, 1>::kSmemBytes;
  if (d == 128 && bq == 128) return FwdPlan<128, 2>::kSmemBytes;
  return -1;
}

extern "C" const char* nvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
