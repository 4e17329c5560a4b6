// Attention with the P V product in int8 (K13) at f32, [B, N, H, D], on
// the tensor cores: QK^T in 3xTF32 on mma.sync, P8 . V8 on s8 mma.sync;
// head dims 64 and 128 (the wrapper zero-pads any other D from 8 to 128 to
// one of these, as the bf16 K13's does).
//
// Replaces the TPU kernel neurovit_tpu/ops/int8_serving.py:286
// (_attn_pv_kernel, launched at :356 by int8_flash_attention) on f32
// q, k and v, where it computes QK^T in f32 and writes f32 o. Per (b, h):
//   s_v = amax_k |v[k, :]| / 127 over the keys k < n_valid  (per channel)
//   v8 = clamp(rint(v / s_v), +-127), 0 for keys at or past n_valid
//   t = (q . k) * (scale * log2 e)            f32 products (3xTF32), f32 sums
//   p = exp2(clamp(t, -96, 96)) * (key < n_valid)
//   denom = sum(p),  s_p = rowmax(p) / 127    from the f32 p
//   p8 = clamp(rint(p / s_p), 0, 127)          IEEE division
//   o = float(p8 . v8) * (s_p / denom * s_v)   f32
// The int32 sums of p8 . v8 are exact.
//
// What bounds it on the H100: QK^T to about f32's accuracy, 2 B H N
// n_valid D flops (8.2 GFLOP at the flagship block at batch 8: B H = 64,
// N = n_valid = 1001, D = 64), 0.050 ms at 165 TFLOP/s (three TF32
// products each, tf32x3.cuh), plus the s8 P V (8.2 G operations at 1,979
// TOP/s, 0.004 ms): 0.054 ms. This design computes QK^T twice (below) on
// mma.sync, whose TF32 form reaches 322 TFLOP/s here
// (scripts/torch_mma_tf32_peak.py), 107 in 3xTF32: its floor is the two
// sweeps at 107 plus the P V, 0.157 ms. Its first design took both sweeps
// on FFMA on the CUDA cores (floor 0.245 ms at 67 TFLOP/s) and P V by
// __dp4a through a shared P8 tile.
//
// Why two sweeps: as the bf16 K13 (int8_attention.cu), a block cannot hold
// its rows of p over all N keys, and p8 needs each row's max before its
// first code. Sweep 0 computes S over the key tiles and keeps each row's
// max of the masked t; exp2 and the clamp are monotone, so rowmax(p) =
// exp2(clamp(max t)), the same exponential of the same f32 value as the
// max element's p in sweep 1. Sweep 1 recomputes S through the same
// function (scores()), so the same t bit for bit and no p above the max:
// p / s_p stays <= 127. It adds p to the row sum, rounds p / s_p to its
// code and accumulates P8 . V8 in int32.
//
// Why a fresh accumulator every k8 step. A score summed in another order
// than the plain version's (one rounded f32 FMA at a time along D) moves a
// p near a code's rounding boundary to the next code, and one code moves
// its query row by about 4e-3 of the row's largest |o|, far past F32_TOL;
// chip_smoke.py allows 1 % of the query rows that (INT8_F32_ATTN_ROW_FRAC).
// An MMA rounds its f32 sum toward zero, so a score kept in one
// accumulator along D drifts an ulp of the sum a step, all one way, and
// flips more codes: in tests/test_torch_int8_f32.py's model of the 3xTF32
// scores (N 1001, 4 heads, n_valid 1001 and 900), one accumulator over D
// = 128 puts more rows outside F32_TOL than the allowance, a fresh
// accumulator each k8 step, added to the score in f32 to nearest, about as
// few as scores summed in f64 and rounded once (the test prints the
// counts).
//
// Why some scores are summed again. The plain version's f32 matmul, on the
// card and on the CPU, sums q . k one rounded fused multiply-add at a time
// along D; the 3xTF32 sums land within about x 2^-18 of its x = p / s_p
// (the model above), but a code flipped in every few hundred rows moves
// the f32 int8 model's probabilities past chip_smoke.py (h)'s bound
// against the CPU (scripts/torch_int8_f32_score_order.py). So where x lies within x 2^-17 of a half-integer (0.01-0.07 % of
// the scores) the kernel sums that score again in the plain version's
// order from the Q and K boxes (seq_score), and it takes the row max's
// score so from K in device memory: its codes and s_p are then the plain
// version's (the model holds them bit for bit), and only the row sums'
// order differs.
//
// The design: K1 at f32's (flash_attention_f32.cu) skeleton.
// - A block is four warps of 16 query rows (64), on flash::GridTile's
//   one-dimensional grid (a head's row tiles adjacent), two blocks an SM.
// - Thread 0 loads the Q box once, then, through a ring of kStages stages
//   with full and empty mbarriers (hopper_gemm.cuh), the 32-key K boxes of
//   sweep 0 and then the K and v8 boxes of sweep 1: 2 n_tiles ring steps,
//   with no drain between the sweeps, as the bf16 K13's producer walks
//   them. Each warp gives a stage back when it is done with it, and thread
//   0 refills it. Q and K come through rank-4 [B, N, H, D] f32 maps, boxes
//   of 32 f32 (128 bytes, 128-byte swizzled; a row of D in D / 32 panels),
//   which zero-fill queries and keys past N. v8 comes through a map over
//   [B H D, n_pad] int8, a box of D channel rows x 32 key bytes with the
//   32-byte swizzle (the two 16-byte halves of row d swapped where (d / 4)
//   is odd). Key tiles at or past n_valid are not loaded.
// - S = Q K^T per k8 step: A from the Q box and B from the K box by
//   ldmatrix (tf32x3.cuh's swizzled loaders), split in registers, the
//   stage's four 8-key tiles' 3xTF32 products back to back (mma3_rz_n)
//   into a fresh accumulator, then added to S in f32. At D = 64 the warp's
//   Q fragments are split once and kept in registers (64 of them) for all
//   2 n_tiles steps.
// - Sweep 0 takes each row's max of the masked t in the accumulator's
//   registers: a thread holds rows g and g + 8 of its warp's 16 (lane = 4
//   g + t) at keys 8 j + 2 t + {0, 1}, j = 0..3; the quad reduces the max
//   by shuffles.
// - Sweep 1 computes p, l and the codes in those registers and packs the
//   stage's 16 codes as the four A registers of mma.sync.m16n8k32.s8,
//   whose A holds row g at k 4 t .. 4 t + 3 (register 0) and 16 + 4 t ..
//   (register 2), row g + 8 at the same k (1, 3). The prologue's v8 keeps
//   each channel's keys permuted within each group of 32 so that stored
//   position 16 u + 4 q + i holds key 16 u + 2 q + 8 (i / 2) + i % 2
//   (v8_key_order in ops/int8_serving.py): the thread's codes of keys 2 t,
//   2 t + 1, 8 + 2 t, 9 + 2 t are k 4 t .. 4 t + 3, with no shuffle (the
//   bf16 K13's P8_PACK). B is channel 8 n + g of the v8 box at stored
//   positions 4 t .. and 16 + 4 t .., two 32-bit shared loads that the
//   32-byte swizzle keeps in 32 distinct banks. O is D / 8 int32 n8 tiles
//   in registers. P never touches shared memory.
// - At the end l is reduced over the quad and o = float(acc) * ((s_p /
//   l) * s_v) written from registers, rows past N skipped.
//
// Rounding points are the JAX kernel's and the plain version's: the
// scores' product by scale * log2 e, the clamp, exp2, the row sum of the
// exact p. exp2 is one MUFU op (ex2.approx.ftz, flash::capped_exp2, as the
// bf16 K13 takes it): on the clamp's range its results are normal, and
// CUDA's exp2f, the same ex2.approx behind a rescaling for subnormal
// results, gives the same bits there
// (scripts/torch_int8_attention_f32_variants.py's exp2f variant). scale =
// amax / 127 (1 where amax is 0) and code = rint(p / s_p) clamped to [0,
// 127], IEEE quotients (quotient() below gives p / s_p correctly rounded
// without a division); o = float(acc) * ((s_p / denom) * s_v), each
// product rounded. The scores (3xTF32) and the denominator are sums in
// another order than the plain version's.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W;
// scripts/torch_int8_attention_f32_variants.py): the attention kernel at
// the flagship block takes 0.4443 ms of device time at batch 8 (37.0
// TFLOP/s of its two sweeps' QK^T, 0.35 of the design's floor), 1.7180 at
// batch 32, and 0.4944 at batch 8 on scores that spread as the
// random-weight flagship's; the first design's took 0.7352 at batch 8
// (scripts/torch_int8_attention_device_times.py --only f32), K1 at f32
// takes 0.3849 in all on the same inputs. PERF.md section 6 times the
// choices above against their alternatives in turns.
#include <cfloat>

#include "flash_attention.cuh"
#include "int8.cuh"
#include "tf32x3.cuh"

namespace nvt {
namespace {

using flash::kScoreCap;
using tf32x3::FragA;
using tf32x3::FragB;

constexpr int kThreads = 128;    // four warps of 16 query rows
constexpr int kBQ = 64;          // query rows a block
constexpr int kBKV = 32;         // keys a ring step: one k32 step of P V
constexpr int kNT = kBKV / 8;    // 8-key MMA tiles of S across a step

// Q's split fragments kept in registers across the key steps at D = 64
// (64 registers), loaded from the Q box again each step at D = 128, where
// they would not fit; and blocks an SM that ptxas fits a thread's
// registers to: two, at most 255 (PERF.md section 6 times the choices).
template <int D>
constexpr bool kQResident = D <= 64;
template <int D>
constexpr int kQFrags = kQResident<D> ? D / 8 : 1;
constexpr int kMinBlocks = 2;

template <int D>
struct Plan {
  static_assert(D == 64 || D == 128, "head dim instance");
  static constexpr int kPanels = D / 32;   // 128-byte panels of a row
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kBQ * D * 4;
  static constexpr int kKBytes = kBKV * D * 4;   // a K box
  static constexpr int kVBytes = D * kBKV;       // a v8 box
  static constexpr int kBarriers = 2 * kStages + 1;
  // 1 KiB of slack aligns the boxes to the swizzle's 1024 bytes; every
  // box's size is a multiple of 1024.
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + kStages * (kKBytes + kVBytes) + kBarriers * 8;
};

// k8 steps of S unrolled together: all of D = 64; two at D = 128, whose
// loads fit in 255 registers (all sixteen spilled).
template <int D>
constexpr int kUnroll = D <= 64 ? D / 8 : 2;

// s = Q K^T of the warp's 16 rows wr .. of the Q box (or Q's fragments
// qf) against the stage's kBKV keys: each k8 step's 3xTF32 products into a
// fresh accumulator, then added to s in f32. Both sweeps call it, so
// sweep 1 recomputes sweep 0's scores bit for bit.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kNT][4],
                                       const FragA (&qf)[kQFrags<D>],
                                       const float* qbox, const float* kbox,
                                       int wr) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) tf32x3::zero(s[j]);
#pragma unroll 1
  for (int k0 = 0; k0 < D; k0 += 8 * kUnroll<D>) {
#pragma unroll
    for (int kk = k0; kk < k0 + 8 * kUnroll<D>; kk += 8) {
      FragA fa;
      if constexpr (kQResident<D>)
        fa = qf[kk / 8];
      else
        tf32x3::load_a_sw<kBQ>(fa, qbox, wr, kk);
      FragB fb[kNT];
#pragma unroll
      for (int j = 0; j < kNT; j += 2)
        tf32x3::load_b_nk2_sw<kBKV>(fb[j], fb[j + 1], kbox, 8 * j, kk);
      float ts[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) tf32x3::zero(ts[j]);
      tf32x3::mma3_rz_n(ts, fa, fb);
#pragma unroll
      for (int j = 0; j < kNT; ++j) tf32x3::add_to(s[j], ts[j]);
    }
  }
}

// c += a . b, one s8 MMA of 16 x 8 x 32 with exact int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// RN(a / b) for the codes, with no division in the loop: q = a * inv_b
// is within one ulp of the quotient, inv_b = RN(1 / b) is correctly
// rounded, and the remainder a - b q is exact in one fused multiply-add,
// so q + r inv_b rounded once is the correctly rounded quotient
// (Markstein's theorem), wherever no step underflows: for p / s_p >= 2^-2,
// the only quotients whose codes are not 0. A division here would bring
// the IEEE division's slow-path call into the loop.
__device__ __forceinline__ float quotient(float a, float b, float inv_b) {
  const float q = __fmul_rn(a, inv_b);
  return __fmaf_rn(__fmaf_rn(-q, b, a), inv_b, q);
}

// q . k of query row r of the Q box and a key whose 4-float chunk at
// column c kchunk(c) gives, summed as the plain version's f32 matmul sums
// it on the card and on the CPU: one rounded fused multiply-add at a time
// along D, column 0 first.
template <int D, typename KChunk>
__device__ __forceinline__ float seq_score(const float* qbox, int r,
                                           KChunk kchunk) {
  float a = 0.f;
#pragma unroll 1
  for (int c = 0; c < D; c += 4) {
    const float4 qv =
        *reinterpret_cast<const float4*>(qbox + tf32x3::swz128<kBQ>(r, c));
    const float4 kv = kchunk(c);
    a = __fmaf_rn(qv.x, kv.x, a);
    a = __fmaf_rn(qv.y, kv.y, a);
    a = __fmaf_rn(qv.z, kv.z, a);
    a = __fmaf_rn(qv.w, kv.w, a);
  }
  return a;
}

// Whether p / s_p = x lies within x 2^-17 of a code's rounding boundary
// (a half-integer), where the 3xTF32 score's distance from the plain
// version's (at most x 2^-18 in tests/test_torch_int8_f32.py's model)
// could give another code.
__device__ __forceinline__ bool near_boundary(float x) {
  return fabsf(x - rintf(x)) >= __fmaf_rn(-x, 0x1p-17f, 0.5f);
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    int8_attn_f32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ kg,
                         const float* __restrict__ s_v,
                         float* __restrict__ o, int N, int H, int n_valid,
                         float scale_log2e) {
  using P = Plan<D>;
  constexpr int kStages = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      round_up(reinterpret_cast<size_t>(smem_raw), 1024));
  float* qs = reinterpret_cast<float*>(base);
  float* ks = reinterpret_cast<float*>(base + P::kQBytes);   // K boxes
  unsigned char* vs = base + P::kQBytes + kStages * P::kKBytes;   // v8
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * P::kVBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;

  const flash::GridTile gt((N + kBQ - 1) / kBQ, H);
  const int q0 = gt.tile * kBQ;
  const int n_tiles = (n_valid + kBKV - 1) / kBKV;
  const int steps = 2 * n_tiles;

  // Ring step it into its stage: K box it of sweep 0, then K and v8 box
  // it - n_tiles of sweep 1 (thread 0 issues it).
  auto load_step = [&](int it) {
    const int st = it % kStages;
    const bool pv = it >= n_tiles;
    const int t = pv ? it - n_tiles : it;
    hopper::mbar_expect_tx(&full[st], P::kKBytes + (pv ? P::kVBytes : 0));
    float* kbox = ks + st * (P::kKBytes / 4);
    for (int p = 0; p < P::kPanels; ++p)
      flash::load_box<false>(kbox + p * kBKV * 32, &tk, &full[st], 32 * p,
                             t * kBKV, gt.h, gt.b);
    if (pv)
      hopper::tma_load_2d(vs + st * P::kVBytes, &tv, &full[st], t * kBKV,
                          gt.bh * D);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kThreads / 32);
    }
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init_fence();
    hopper::tma_prefetch_map(&tq);
    hopper::tma_prefetch_map(&tk);
    hopper::tma_prefetch_map(&tv);
    hopper::mbar_expect_tx(qfull, P::kQBytes);
    for (int p = 0; p < P::kPanels; ++p)
      flash::load_box<false>(qs + p * kBQ * 32, &tq, qfull, 32 * p, q0,
                             gt.h, gt.b);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int it = 0; it < kStages && it < steps; ++it) load_step(it);

  // A warp: rows wr .. wr + 15 of the block's 64, the thread's rows g and
  // g + 8 of them, keys 8 j + 2 t + {0, 1} of each step.
  const int lane = threadIdx.x & 31;
  const int g = tf32x3::lane_g(), t = tf32x3::lane_t();
  const int wr = 16 * (threadIdx.x >> 5);
  const int qw = q0 + wr;

  auto wait_step = [&](int it) {
    hopper::mbar_wait(&full[it % kStages], (it / kStages) & 1);
  };
  // The warp is done with step it's stage; thread 0 refills it once the
  // four warps are.
  auto release = [&](int it) {
    const int st = it % kStages;
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
    if (threadIdx.x == 0 && it + kStages < steps) {
      hopper::mbar_wait(&empty[st], (it / kStages) & 1);
      load_step(it + kStages);
    }
  };
  auto kbox_of = [&](int it) {
    return ks + (it % kStages) * (P::kKBytes / 4);
  };

  hopper::mbar_wait(qfull, 0);
  FragA qf[kQFrags<D>];
  if constexpr (kQResident<D>) {
#pragma unroll
    for (int kk = 0; kk < D; kk += 8)
      tf32x3::load_a_sw<kBQ>(qf[kk / 8], qs, wr, kk);
  }

  // Sweep 0: each row's max of t over its keys below n_valid, and the
  // first key that takes it.
  float m[2] = {-FLT_MAX, -FLT_MAX};
  int arg[2] = {0, 0};
  float s[kNT][4];
  for (int it = 0; it < n_tiles; ++it) {
    wait_step(it);
    scores<D>(s, qf, qs, kbox_of(it), wr);
    const int key0 = it * kBKV + 2 * t;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + (e & 1);
        const float x = __fmul_rn(s[j][e], scale_log2e);
        if (key < n_valid && x > m[e >> 1]) {
          m[e >> 1] = x;
          arg[e >> 1] = key;
        }
      }
    release(it);
  }

  // s_p = rowmax(p) / 127, rowmax(p) = exp2(clamp(max t)) with the max
  // key's t summed in the plain version's order (from K in device memory:
  // sweep 0's boxes are gone); the row's keys lie in the quad's lanes.
  const HeadRows<false> hr(gt.b, gt.h, N, H, D);
  float s_p[2], inv_sp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int lanes = 1; lanes <= 2; lanes *= 2) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], lanes);
      const int ao = __shfl_xor_sync(0xffffffffu, arg[i], lanes);
      if (mo > m[i] || (mo == m[i] && ao < arg[i])) {
        m[i] = mo;
        arg[i] = ao;
      }
    }
    const float* krow = kg + hr.base + static_cast<size_t>(arg[i]) * hr.stride;
    const float mx = __fmul_rn(
        seq_score<D>(qs, wr + g + 8 * i,
                     [&](int c) {
                       return *reinterpret_cast<const float4*>(krow + c);
                     }),
        scale_log2e);
    s_p[i] =
        quant_scale(flash::exp2_ftz(fminf(fmaxf(mx, -kScoreCap), kScoreCap)));
    inv_sp[i] = __fdiv_rn(1.f, s_p[i]);
  }

  // Sweep 1: S again, p, the row sums and the codes; O += P8 . V8. The
  // v8 box's row d holds its 16-byte halves swapped where (d / 4) is odd:
  // channel 8 n + g's words t and 4 + t lie at v0 and v1 of tile n.
  int acc[D / 8][4];   // O: rows g, g + 8; channels 8 n + 2 t, + 1
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0;
  float l[2] = {0.f, 0.f};
  const int sw = g & 4;
  const int v0 = 8 * g + (t ^ sw), v1 = 8 * g + ((4 + t) ^ sw);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int it = n_tiles + kt;
    wait_step(it);
    scores<D>(s, qf, qs, kbox_of(it), wr);
    bool near = false;   // a score to take again
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = kt * kBKV + 8 * j + 2 * t + (e & 1) < n_valid
                            ? flash::capped_exp2(s[j][e], scale_log2e)
                            : 0.f;
        l[i] += p;
        s[j][e] = quotient(p, s_p[i], inv_sp[i]);
        near = near || near_boundary(s[j][e]);
      }
    // Those scores' codes from the plain version's sums; the row sum keeps
    // their 3xTF32 p, an ulp or so of one of its terms away.
    if (near) {
      const float* kbox = kbox_of(it);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (near_boundary(s[j][e])) {
            const int i = e >> 1, c = 8 * j + 2 * t + (e & 1);
            const float p = flash::capped_exp2(
                seq_score<D>(qs, wr + g + 8 * i,
                             [&](int col) {
                               return *reinterpret_cast<const float4*>(
                                   kbox + tf32x3::swz128<kBKV>(c, col));
                             }),
                scale_log2e);
            s[j][e] = quotient(p, s_p[i], inv_sp[i]);
          }
    }
    // The codes as the s8 A operand: row g's keys 2 t, 2 t + 1, 8 + 2 t,
    // 9 + 2 t (then 16 + ..) in registers 0 (2), row g + 8's in 1 (3).
    const uint32_t pa[4] = {
        pack_s8x4(s[0][0], s[0][1], s[1][0], s[1][1]),
        pack_s8x4(s[0][2], s[0][3], s[1][2], s[1][3]),
        pack_s8x4(s[2][0], s[2][1], s[3][0], s[3][1]),
        pack_s8x4(s[2][2], s[2][3], s[3][2], s[3][3])};
    const uint32_t* vw = reinterpret_cast<const uint32_t*>(
        vs + (it % kStages) * P::kVBytes);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      mma_s8(acc[n], pa, vw[64 * n + v0], vw[64 * n + v1]);
    release(it);
  }

  // Row sums over the quad; o = float(acc) * ((s_p / denom) * s_v).
  const float* sv = s_v + static_cast<size_t>(gt.bh) * D + 2 * t;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = qw + g + 8 * i;
    if (row >= N) continue;
    const float ratio = __fdiv_rn(s_p[i], li);
    float* out = o + hr.base + static_cast<size_t>(row) * hr.stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float2 s2 = *reinterpret_cast<const float2*>(sv + 8 * n);
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(
          __fmul_rn(__int2float_rn(acc[n][2 * i]), __fmul_rn(ratio, s2.x)),
          __fmul_rn(__int2float_rn(acc[n][2 * i + 1]),
                    __fmul_rn(ratio, s2.y)));
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int8_t* v8, float* stats, int B, int N, int H, int n_valid,
                   float scale_log2e, cudaStream_t stream) {
  using P = Plan<D>;
  const cuuint64_t e = 4;   // bytes of an f32
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(N),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {D * e, dims[1] * D * e,
                                 dims[2] * dims[1] * D * e};
  // Boxes of 32 columns (128 bytes) by kBQ query rows or kBKV keys.
  const cuuint32_t qbox[4] = {32, 1, kBQ, 1}, kbox[4] = {32, 1, kBKV, 1};
  CUtensorMap maps[3];
  cudaError_t err = hopper::encode_4d(&maps[0], q, dims, strides, qbox, true);
  if (err == cudaSuccess)
    err = hopper::encode_4d(&maps[1], k, dims, strides, kbox, true);
  // v8 [B H D, n_pad]: boxes of 32 key bytes by the head's D channels.
  const int n_pad = (N + 63) / 64 * 64;
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&maps[2], v8, B * H * D, n_pad, true, D, 32);
  if (err != cudaSuccess) return err;
  const auto kernel = int8_attn_f32_kernel<D>;
  err = allow_smem(kernel, P::kSmemBytes);
  if (err != cudaSuccess) return err;
  err = launch_v_prologue<float, D>(v, stats, v8, B, N, H, n_valid, stream);
  if (err != cudaSuccess) return err;
  const unsigned grid = ((N + kBQ - 1) / kBQ) * B * H;
  kernel<<<grid, kThreads, P::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], k, stats, o, N, H, n_valid, scale_log2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nvt

// q, k, v, o: [B, N, H, D] f32, contiguous, D in {64, 128} (the wrapper
// zero-pads other head dims). 1 <= n_valid <= N; the shapes and the
// scratch (v8 and the f32 stats) as nvt_int8_attention's, whose prologue
// this launches on f32 V. Three launches on `stream`, no allocation.
extern "C" int nvt_int8_attention_f32(const void* q, const void* k,
                                      const void* v, void* o, void* v8,
                                      void* stats, int B, int N, int H, int D,
                                      int n_valid, float scale_log2e,
                                      void* stream) {
  using namespace nvt;
  if (!int8_attn_takes(B, N, H, D) || n_valid < 1 || n_valid > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* v8b = static_cast<int8_t*>(v8);
  auto* st = static_cast<float*>(stats);
  return static_cast<int>(
      D == 64 ? launch<64>(qf, kf, vf, of, v8b, st, B, N, H, n_valid,
                           scale_log2e, s)
              : launch<128>(qf, kf, vf, of, v8b, st, B, N, H, n_valid,
                            scale_log2e, s));
}

// Dynamic shared memory of a block of the attention kernel at head dim d
// (64 or 128; ops/int8_serving.py int8_attn_f32_plan), or -1.
extern "C" long long nvt_int8_attn_f32_smem_bytes(int d) {
  using nvt::Plan;
  if (d == 64) return static_cast<long long>(Plan<64>::kSmemBytes);
  if (d == 128) return static_cast<long long>(Plan<128>::kSmemBytes);
  return -1;
}
