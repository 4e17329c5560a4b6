// Flash attention forward at f32 on the tensor cores (3xTF32), in two
// layouts:
//   bnhd [B, N, H, D] (K1): replaces the TPU kernel
//     neurovit_tpu/ops/flash_attention.py:233 (_fwd_kernel_allheads,
//     launched at :381 by flash_attention);
//   bhnd [B, H, N, D] (K6): replaces :91 (_fwd_kernel, launched at :381 by
//     flash_attention(layout="bhnd"), the Grad-CAM probe's attention).
// Both are instances of one kernel, templated on the layout, which only
// orders the tensor maps' dims, as the bf16 K1 and K6 are. On f32
// operands p.astype(v.dtype) is a no-op, so P is not rounded:
//   s = q . k^T * scale * log2(e)                 f32
//   p = exp2(clip(s, -96, 96)), 0 for keys >= n_valid
//   l = sum_k p                                   the denominator
//   o = (p * mask) . v / (l * keep)               mask: training only
// The clamp at +-96 (flash_attention.py:39-45) stands in for the row max,
// so nothing is rescaled as the key tiles go by. The dropout mask of
// element (b, h, q, k) is nn.keep_mask's bit at ((b H + h) N + q) N + k,
// the bits the bf16 kernel (flash_attention.cu) and the plain version
// draw, in either layout. With lsum, l goes out as the [B, H, N] row sums
// the backward reads.
//
// What bounds it on the H100: its 4 B H N n_valid D flops, 16.4 GFLOP for
// the flagship block at batch 8 (B H = 64, N = n_valid = 1001, D = 64),
// far above its 66 MB of q, k, v and o. Both products run in 3xTF32 on
// mma.sync (tf32x3.cuh: each operand split into big and small, three TF32
// MMAs a product, about f32's accuracy): 0.0995 ms at 165 TFLOP/s of f32
// products (the data sheet's 495 TF32), 0.1534 ms at the 107 that
// mma.sync's TF32 form reaches (scripts/torch_mma_tf32_peak.py); on FFMA
// on the CUDA cores, this kernel's first design, 0.2450 ms at 67.
//
// The design: the dQ pass of the f32 backward (flash_attention_bwd_f32.cu),
// whose products have the same two shapes, fed by TMA:
// - A block is four warps of 16 query rows (64), on a one-dimensional grid
//   with a head's row tiles adjacent (flash::GridTile), two blocks an SM.
//   A producer warp beside one or two consumer warpgroups (the bf16 K1's
//   shape) ran slower (PERF.md, section 6): its registers capped a thread at
//   168, and the MMAs waited on their operands' loads and splits.
// - Thread 0 loads the Q box once and the K and V boxes of 32 keys through
//   a ring of kStages stages by TMA, with full and empty mbarriers
//   (hopper_gemm.cuh): each warp gives a stage back when its P V is done,
//   and thread 0 refills it. The tensor maps are rank 4, ordered by the
//   layout, so a box never crosses a head and TMA zero-fills keys and
//   queries past N: the ragged 1001-token stream needs no padding and no
//   masked loads. A box is 32 f32 wide (128 bytes, 128-byte swizzled): a
//   row of D lies in D / 32 panels. Key tiles at or past n_valid are not
//   loaded.
// - S = Q K^T: per k8 step, A from the Q box and B from the K box
//   (K-major), both by ldmatrix (tf32x3.cuh's swizzled loaders, no bank
//   conflict), split in registers; the stage's four 8-key tiles take each
//   term of their 3xTF32 products back to back (mma3_rz_n), into fresh
//   accumulators every kSteps k8 steps (all of D <= 64, two at D = 128)
//   that are then added in f32 (an MMA rounds toward zero).
// - p, l and the mask in the accumulator's registers: a thread holds rows
//   g and g + 8 of its warp's 16, keys 8 j + 2 t + {0, 1}; l of its two
//   rows is reduced across the quad once, at the end. With dropout, lane
//   l draws the 16 keys 16 (l % 2) .. of its warp's row l / 2 of the stage
//   (flash_f32::keep_bits16, before the stage's wait) and each thread
//   takes its rows' bits by four shuffles, the dQ pass's scheme.
// - O += (P m) V: the accumulator of P, split, is the A fragment as it
//   lies (a_from_acc, k slots 0, 2, .., 7), and B is V read MN-major from
//   the V box (load_b_kn_sw, its rows in the same order), no transpose;
//   kNC 8-column tiles of O at a time, each stage's product in a fresh
//   accumulator (kPvSteps k8 steps), then added in f32.
// - At the end o = O / (l keep) is written from registers, rows past N
//   skipped, and with lsum l.
// Registers at D = 64 (two blocks an SM: at most 255 a thread): O 32, S
// and its fresh sum 16 + 16, the A and four B fragments 24; then the P V
// pass's fresh sums 16, its A 8 and four B 16; ptxas takes the rest to
// load fragments ahead (253 in all, no spill). Head dims are instances
// at 32, 64 and 128 (ops/flash_attention.py pads the others); the layout
// changes only where a head's rows lie, so both layouts share the grid
// and the shared memory and give the same bits.
#include "flash_attention.cuh"
#include "flash_f32.cuh"
#include "tf32x3.cuh"

namespace nvt {
namespace {

using flash_f32::kCap;
using flash_f32::keep_bits16;
using tf32x3::FragA;
using tf32x3::FragB;

constexpr int kThreads = 128;    // four warps of 16 query rows
constexpr int kBQ = 64;          // query rows a block
constexpr int kBKV = 32;         // keys a stage
constexpr int kNT = kBKV / 8;    // 8-key MMA tiles across a stage
constexpr int kNC = 4;           // 8-column tiles of O a product pass
constexpr int kCopiers = 1;      // threads that issue the ring's copies
// k8 steps of S a fresh accumulator takes before it is added to S (at
// D <= 64 all of them; at D = 128 two, whose unrolled loads fit in 255
// registers); k8 steps (8 keys each) of P V before one is added to O (a
// stage's).
template <int D>
constexpr int kSteps = D <= 64 ? 8 : 2;
constexpr int kPvSteps = kNT;
// Q's split fragments kept in registers across the key tiles (64 more at
// D = 64; loading them again each stage ran faster: PERF.md, section 6), and
// blocks an SM that ptxas fits a thread's registers to: two, at most 255
// registers (three, at most 168, ran slower).
template <int D>
constexpr bool kQResident = false;
template <int D>
constexpr int kQFrags = kQResident<D> ? D / 8 : 1;
constexpr int kMinBlocks = 2;

template <int D>
struct Plan {
  static_assert(D == 32 || D == 64 || D == 128, "head dim instance");
  static constexpr int kPanels = D / 32;   // 128-byte panels of a row
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kQFloats = kBQ * D;
  static constexpr int kKVFloats = kBKV * D;   // a K or V stage
  static constexpr int kBarriers = 2 * kStages + 1;
  // 1 KiB of slack aligns the boxes to the swizzle's 1024 bytes.
  static constexpr size_t kSmemBytes =
      1024 + (kQFloats + 2 * kStages * kKVFloats) * 4 + kBarriers * 8;
};

// s = Q K^T of the warp's 16 rows wr .. of the Q box against the stage's
// kBKV keys, kSteps k8 steps at a time into fresh accumulators (one at a
// time where Q stays in registers, whose fragments the loop then indexes
// by constants); Q from the box, or from qf.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kNT][4],
                                       const FragA (&qf)[kQFrags<D>],
                                       const float* qbox, const float* kbox,
                                       int wr) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) tf32x3::zero(s[j]);
#pragma unroll 1
  for (int k0 = 0; k0 < D; k0 += 8 * kSteps<D>) {
    float ts[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) tf32x3::zero(ts[j]);
#pragma unroll
    for (int kk = k0; kk < k0 + 8 * kSteps<D> && kk < D; kk += 8) {
      FragA fa;
      if constexpr (kQResident<D>)
        fa = qf[kk / 8];
      else
        tf32x3::load_a_sw<kBQ>(fa, qbox, wr, kk);
      FragB fb[kNT];
#pragma unroll
      for (int j = 0; j < kNT; j += 2)
        tf32x3::load_b_nk2_sw<kBKV>(fb[j], fb[j + 1], kbox, 8 * j, kk);
      tf32x3::mma3_rz_n(ts, fa, fb);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) tf32x3::add_to(s[j], ts[j]);
  }
}

// acc += P . V over the stage: P the warp's 16 x kBKV accumulators as A
// fragments, V the stage's rows read MN-major; kNC 8-column tiles of O at
// a time, each tile's sum taken kPvSteps k8 steps at a time apart, then
// added to acc.
template <int D>
__device__ __forceinline__ void product_pv(float (&acc)[D / 8][4],
                                           const float (&p)[kNT][4],
                                           const float* vbox) {
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += kNC)
#pragma unroll
    for (int j0 = 0; j0 < kNT; j0 += kPvSteps) {
      float d[kNC][4];
#pragma unroll
      for (int n = 0; n < kNC; ++n) tf32x3::zero(d[n]);
#pragma unroll
      for (int j = j0; j < j0 + kPvSteps; ++j) {
        FragA pa;
        tf32x3::a_from_acc(pa, p[j]);
        FragB fb[kNC];
#pragma unroll
        for (int n = 0; n < kNC; ++n)
          tf32x3::load_b_kn_sw<kBKV>(fb[n], vbox, 8 * j, 8 * (n0 + n));
        tf32x3::mma3_rz_n(d, pa, fb);
      }
#pragma unroll
      for (int n = 0; n < kNC; ++n) tf32x3::add_to(acc[n0 + n], d[n]);
    }
}

template <int D, bool kBhnd>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         float* __restrict__ o, float* __restrict__ lsum,
                         int N, int H, int n_valid, float scale_log2,
                         float keep, uint32_t keep_q, uint64_t seed) {
  using P = Plan<D>;
  constexpr int kStages = P::kStages, kKV = P::kKVFloats;
  extern __shared__ unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(
      round_up(reinterpret_cast<size_t>(smem_raw), 1024));
  float* ks = qs + P::kQFloats;    // the ring's K boxes
  float* vs = ks + kStages * kKV;  // and V boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * kKV);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;

  const flash::GridTile gt((N + kBQ - 1) / kBQ, H);
  const int q0 = gt.tile * kBQ;
  const int n_tiles = (n_valid + kBKV - 1) / kBKV;

  // Copy the K and V boxes of key tile t into stage st, by TMA
  // (kCopiers threads issue it: one).
  auto load_stage = [&](int st, int t) {
    hopper::mbar_expect_tx(&full[st], 2 * kKV * 4);
    for (int p = 0; p < P::kPanels; ++p) {
      flash::load_box<kBhnd>(ks + st * kKV + p * kBKV * 32, &tk, &full[st],
                             32 * p, t * kBKV, gt.h, gt.b);
      flash::load_box<kBhnd>(vs + st * kKV + p * kBKV * 32, &tv, &full[st],
                             32 * p, t * kBKV, gt.h, gt.b);
    }
  };
  // Thread 0 loads Q; the copiers fill the ring, then refill each stage
  // once the four warps have given it back.
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], kCopiers);
      hopper::mbar_init(&empty[s], kThreads / 32);
    }
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init_fence();
    hopper::tma_prefetch_map(&tq);
    hopper::tma_prefetch_map(&tk);
    hopper::tma_prefetch_map(&tv);
    hopper::mbar_expect_tx(qfull, P::kQFloats * 4);
    for (int p = 0; p < P::kPanels; ++p)
      flash::load_box<kBhnd>(qs + p * kBQ * 32, &tq, qfull, 32 * p, q0,
                             gt.h, gt.b);
  }
  __syncthreads();
  if (threadIdx.x < kCopiers)
    for (int st = 0; st < kStages && st < n_tiles; ++st) load_stage(st, st);

  // A warp: rows wr .. wr + 15 of the block's 64, the thread's rows g and
  // g + 8 of them.
  const int lane = threadIdx.x & 31;
  const int g = tf32x3::lane_g(), t = tf32x3::lane_t();
  const int wr = 16 * (threadIdx.x >> 5);
  const int qw = q0 + wr;   // the warp's first query row
  const size_t row0 = static_cast<size_t>(gt.bh) * N;

  float acc[D / 8][4];   // O: rows g, g + 8; columns 8 n + 2t, + 1
#pragma unroll
  for (int n = 0; n < D / 8; ++n) tf32x3::zero(acc[n]);
  float l[2] = {0.f, 0.f};

  hopper::mbar_wait(qfull, 0);
  FragA qf[kQFrags<D>];
  if constexpr (kQResident<D>) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      tf32x3::load_a_sw<kBQ>(qf[kk], qs, wr, 8 * kk);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kStages;
    const int key0 = kt * kBKV;
    // Keep bits of keys key0 + c (bit c) of the thread's rows: lane l
    // draws the 16 keys 16 (l % 2) .. of the warp's row l / 2, before the
    // stage's wait.
    uint32_t kept[2] = {~0u, ~0u};
    if (keep_q) {
      const int row = qw + (lane >> 1);
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

    hopper::mbar_wait(&full[st], (kt / kStages) & 1);
    const float* kbox = ks + st * kKV;
    const float* vbox = vs + st * kKV;
    float s[kNT][4];
    scores<D>(s, qf, qs, kbox, wr);

    // P m in place of S, l before the mask.
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = 8 * j + 2 * t + (e & 1);
        const float ex =
            exp2f(fminf(fmaxf(s[j][e] * scale_log2, -kCap), kCap));
        const float p = key0 + c < n_valid ? ex : 0.f;
        l[i] += p;
        s[j][e] = (kept[i] >> c) & 1u ? p : 0.f;
      }

    product_pv<D>(acc, s, vbox);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
    if (threadIdx.x < kCopiers && kt + kStages < n_tiles) {
      hopper::mbar_wait(&empty[st], (kt / kStages) & 1);
      load_stage(st, kt + kStages);
    }
  }

  const HeadRows<kBhnd> hr(gt.b, gt.h, N, H, D);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = qw + g + 8 * i;
    if (row >= N) continue;
    const float den = li * keep;
    float* out = o + hr.base + static_cast<size_t>(row) * hr.stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
    if (lsum != nullptr && t == 0) lsum[row0 + row] = li;
  }
}

template <int D, bool kBhnd>
cudaError_t launch(const void* q, const void* k, const void* v, float* o,
                   float* lsum, int B, int N, int H, int n_valid,
                   float scale_log2, float keep, uint32_t keep_q,
                   uint64_t seed, cudaStream_t stream) {
  using P = Plan<D>;
  const cuuint64_t e = 4;   // bytes of an f32
  const cuuint64_t dims[4] = {
      cuuint64_t(D), cuuint64_t(kBhnd ? N : H), cuuint64_t(kBhnd ? H : N),
      cuuint64_t(B)};
  const cuuint64_t strides[3] = {D * e, dims[1] * D * e,
                                 dims[2] * dims[1] * D * e};
  // Boxes of 32 columns (128 bytes) by kBQ query rows or kBKV keys.
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint32_t rows = i == 0 ? kBQ : kBKV;
    const cuuint32_t box[4] = {32, kBhnd ? rows : 1u, kBhnd ? 1u : rows, 1};
    const cudaError_t err =
        hopper::encode_4d(&maps[i], ptrs[i], dims, strides, box, true);
    if (err != cudaSuccess) return err;
  }
  const auto kernel = flash_fwd_f32_kernel<D, kBhnd>;
  cudaError_t err = allow_smem(kernel, P::kSmemBytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = ((N + kBQ - 1) / kBQ) * B * H;
  kernel<<<grid, kThreads, P::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], o, lsum, N, H, n_valid, scale_log2, keep,
      keep_q, seed);
  return cudaGetLastError();
}

template <bool kBhnd>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B,
               int N, int H, int D, int n_valid, float scale_log2, float keep,
               int keep_q, uint64_t seed, void* lsum, void* stream) {
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N || keep_q < 0 ||
      keep_q > 255 ||
      static_cast<long long>((N + kBQ - 1) / kBQ) * B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lsum);
  const uint32_t kq = static_cast<uint32_t>(keep_q);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch<32, kBhnd>(q, k, v, of, lf, B, N, H, n_valid, scale_log2,
                              keep, kq, seed, s);
      break;
    case 64:
      err = launch<64, kBhnd>(q, k, v, of, lf, B, N, H, n_valid, scale_log2,
                              keep, kq, seed, s);
      break;
    case 128:
      err = launch<128, kBhnd>(q, k, v, of, lf, B, N, H, n_valid,
                               scale_log2, keep, kq, seed, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace nvt

// K1 at f32. q, k, v, o [B, N, H, D] f32, contiguous, D in {32, 64, 128}
// (the wrapper zero-pads other head dims); lsum [B, H, N] f32 or null.
// keep = q / 256 (1 without dropout), keep_q the dropout threshold (0 =
// none).
extern "C" int nvt_flash_attention_f32_fwd(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int N, int H, int D, int n_valid,
                                           float scale_log2, float keep,
                                           int keep_q, uint64_t seed,
                                           void* lsum, void* stream) {
  return nvt::launch_fwd<false>(q, k, v, o, B, N, H, D, n_valid, scale_log2,
                                keep, keep_q, seed, lsum, stream);
}

// K6 at f32: the same with q, k, v, o in [B, H, N, D].
extern "C" int nvt_flash_attention_bhnd_f32_fwd(const void* q, const void* k,
                                                const void* v, void* o, int B,
                                                int N, int H, int D,
                                                int n_valid, float scale_log2,
                                                float keep, int keep_q,
                                                uint64_t seed, void* lsum,
                                                void* stream) {
  return nvt::launch_fwd<true>(q, k, v, o, B, N, H, D, n_valid, scale_log2,
                               keep, keep_q, seed, lsum, stream);
}

// Dynamic shared memory of a block of the instance at head dim D, either
// layout (ops/flash_attention.py flash_f32_plan), or -1.
extern "C" long long nvt_flash_attention_f32_smem_bytes(int D) {
  using nvt::Plan;
  switch (D) {
    case 32: return static_cast<long long>(Plan<32>::kSmemBytes);
    case 64: return static_cast<long long>(Plan<64>::kSmemBytes);
    case 128: return static_cast<long long>(Plan<128>::kSmemBytes);
    default: return -1;
  }
}
