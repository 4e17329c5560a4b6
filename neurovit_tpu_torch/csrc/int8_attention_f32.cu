// Attention with the P V product in int8 (K13) at f32, [B, N, H, D], on
// the CUDA cores: head dims 64 and 128 (the wrapper zero-pads any other D
// from 8 to 128 to one of these, as the bf16 K13's does).
//
// Replaces the TPU kernel neurovit_tpu/ops/int8_serving.py:286
// (_attn_pv_kernel, launched at :356 by int8_flash_attention) on f32
// q, k and v, where it computes QK^T in f32 and writes f32 o. Per (b, h):
//   s_v = amax_k |v[k, :]| / 127 over the keys k < n_valid  (per channel)
//   v8 = clamp(rint(v / s_v), +-127), 0 for keys at or past n_valid
//   t = (q . k) * (scale * log2 e)            f32 products, f32 sums
//   p = exp2(clamp(t, -96, 96)) * (key < n_valid)
//   denom = sum(p),  s_p = rowmax(p) / 127    from the f32 p
//   p8 = clamp(rint(p / s_p), 0, 127)          IEEE division
//   o = float(p8 . v8) * (s_p / denom * s_v)   f32
// The int32 sums of p8 . v8 are exact.
//
// What bounds it on the H100: QK^T exact to f32, 2 B H N n_valid D flops
// (8.2 GFLOP at the flagship block at batch 8: B H = 64, N = n_valid =
// 1001, D = 64), 0.050 ms at 165 TFLOP/s (three TF32 products each), plus
// the s8 P V (8.2 G operations at 1,979 TOP/s, 0.004 ms). wgmma has no f32
// form and one TF32 product keeps 10 mantissa bits, so S is FFMA on the
// CUDA cores, as K1 at f32 (flash_attention_f32.cu) takes it: this
// design's floor is its two sweeps of QK^T at 67 TFLOP/s, 0.245 ms.
//
// Why two sweeps: as the bf16 K13 (int8_attention.cu), a block cannot hold
// its rows of p over all N keys, and p8 needs each row's max before its
// first code. Sweep 0 computes S over the key tiles and keeps each row's
// max of the masked t; exp2 and the clamp are monotone, so rowmax(p) =
// exp2(clamp(max t)), the same exponential of the same f32 value as the
// max element's p in sweep 1. Sweep 1 recomputes S through the same
// function (scores(), one __fmaf_rn at a time in a fixed order), so the
// same t bit for bit and no p above the max: p / s_p stays <= 127. It adds
// p to the row sum, rounds p / s_p to its code and accumulates P8 . V8 in
// int32 with __dp4a, four keys a step.
//
// The design: one block of 128 threads a 64-row query tile of one (b, h),
// on a one-dimensional grid of (query tiles x B H), query tiles fastest,
// as K1 at f32. Key tiles of 32: K (f32, its 16-byte chunks permuted by
// flash_f32::swz) and, in sweep 1, the 32 codes of each channel of v8 are
// staged by 16-byte cp.async copies, two tiles in flight. A thread holds
// S of 4 rows (ty * 4 + i, ty = tid / 8) x 4 keys (tx * 4 + j, tx = tid %
// 8), read from Q and K rows as 16-byte vectors along D, and O of the same
// 4 rows x D / 8 channels (tx + 8 c). The codes of P go through shared
// memory, [64 rows, 32 positions] int8, each written at the position that
// v8 keeps its key's code: v8 is the prologue's (the bf16 K13's
// launch_v_prologue, int8.cuh, on f32 V), each channel's keys permuted
// within each group of 32 (v8_key_order in ops/int8_serving.py), so P and
// V share one permutation and each __dp4a of a 4-byte word of a P row
// with one of a channel's row sums the products of the same four keys.
// The v8 tile's rows (32 bytes) have their two 16-byte halves swapped on
// every other group of 4 rows, so the 8 lanes of a quarter-warp read 8
// rows' halves from 32 different banks. Query rows past N and keys past N
// are zero-filled by the copies; keys past n_valid get p = 0 (and v8 code
// 0); rows past N are not stored.
//
// Rounding points are the JAX kernel's and the plain version's: the
// scores' product by scale * log2 e, the clamp, exp2 (CUDA's exp2f), the
// row sum of the exact p; scale = amax / 127 (1 where amax is 0) and code
// = rint(p / s_p) clamped to [0, 127], IEEE quotients (quotient() below
// gives p / s_p correctly rounded without a division); o = float(acc) *
// ((s_p / denom) * s_v), each product rounded. The f32 sums of S and of
// the denominator run in another order than the plain version's, so a p
// near a code's rounding boundary can take the next code there.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's f32 phase
// (g), two runs): 0.8155-0.8664 ms at the flagship block at batch 8, 18.9-
// 20.1 TFLOP/s of the two sweeps' QK^T, where K1 at f32 takes
// 0.5733-0.5772 on the same inputs; 150 registers at D = 64, 168 at D =
// 128, no spill.
#include <cfloat>

#include "flash_f32.cuh"
#include "int8.cuh"

namespace nvt {
namespace {

using flash_f32::kCap;
using flash_f32::kThreads;
using flash_f32::stage_rows;
using flash_f32::swz;

constexpr int kBQ = 64, kBKV = 32;

template <int D>
struct Layout {
  static constexpr int kQ = kBQ * D;       // floats of the Q tile
  static constexpr int kK = kBKV * D;      // floats of a K tile
  static constexpr int kV8 = D * kBKV;     // bytes of a v8 tile
  static constexpr int kP8 = kBQ * kBKV;   // bytes of the P8 tile
  static constexpr size_t kBytes =
      static_cast<size_t>(kQ + 2 * kK) * sizeof(float) + 2 * kV8 + kP8;
};

// S of the thread's rows ty * 4 + i and keys tx * 4 + j of the staged K
// tile, q . k over D in one fixed order: 16-byte chunk c = 0 .. D / 4 - 1,
// then its x, y, z and w, one rounded fused multiply-add at a time. Both
// sweeps call it, so sweep 1 recomputes sweep 0's scores bit for bit.
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* kst,
                                       int ty, int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D / 4; ++c) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(qs + swz(ty * 4 + i, c, D));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = *reinterpret_cast<const float4*>(kst + swz(tx * 4 + j, c, D));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = s[i][j];
        a = __fmaf_rn(qv[i].x, kv[j].x, a);
        a = __fmaf_rn(qv[i].y, kv[j].y, a);
        a = __fmaf_rn(qv[i].z, kv[j].z, a);
        s[i][j] = __fmaf_rn(qv[i].w, kv[j].w, a);
      }
  }
}

// Copy the codes of keys key0 .. key0 + 31 of the head's D channels from
// v8 [D, n_pad] into a tile of D rows of 32 bytes, the halves of row d
// swapped where (d / 4) is odd.
template <int D>
__device__ __forceinline__ void stage_v8(unsigned char* dst,
                                         const int8_t* v8h, int key0,
                                         int n_pad) {
  for (int c = threadIdx.x; c < 2 * D; c += kThreads) {
    const int d = c / 2, half = c % 2;
    ffma::cp_async16(
        reinterpret_cast<float*>(dst + 32 * d + 16 * (half ^ ((d >> 2) & 1))),
        reinterpret_cast<const float*>(v8h + static_cast<size_t>(d) * n_pad +
                                       key0 + 16 * half),
        true);
  }
}

// RN(a / b) for the codes, with no division in the loop: q = a * inv_b
// is within one ulp of the quotient, inv_b = RN(1 / b) is correctly
// rounded, and the remainder a - b q is exact in one fused multiply-add,
// so q + r inv_b rounded once is the correctly rounded quotient
// (Markstein's theorem), wherever no step underflows: for p / s_p >= 2^-2,
// the only quotients whose codes are not 0. A division here would bring
// the IEEE division's slow-path call into the loop, and at D = 128 ptxas
// spills around it (16 bytes) with the accumulators live.
__device__ __forceinline__ float quotient(float a, float b, float inv_b) {
  const float q = __fmul_rn(a, inv_b);
  return __fmaf_rn(__fmaf_rn(-q, b, a), inv_b, q);
}

// The byte of a P8 row that holds key tx * 4 of the tile: v8's stored
// position 16 (k / 16) + 4 ((k % 8) / 2) + 2 ((k % 16) / 8) + k % 2 of key
// k. Keys tx * 4 + 1, + 2 and + 3 are at + 1, + 4 and + 5.
__device__ __forceinline__ int p8_position(int tx) {
  return 16 * (tx / 4) + 8 * (tx % 2) + 2 * ((tx / 2) % 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    int8_attn_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const int8_t* __restrict__ v8,
                         const float* __restrict__ s_v,
                         float* __restrict__ o, int N, int H, int q_tiles,
                         int n_valid, int n_pad, float scale_log2e) {
  using L = Layout<D>;
  constexpr int kCh = D / 8;    // channels of O a thread: tx + 8 c
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + L::kQ;                                  // two stages
  unsigned char* vs = reinterpret_cast<unsigned char*>(ks + 2 * L::kK);
  unsigned char* ps = vs + 2 * L::kV8;

  const int qt = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const HeadRows<false> hr(bh / H, bh % H, N, H, D);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int n_tiles = (n_valid + kBKV - 1) / kBKV;
  const int8_t* v8h = v8 + static_cast<size_t>(bh) * D * n_pad;

  // Sweep 0: each row's max of t over its keys below n_valid.
  stage_rows<D, kBQ, true>(qs, q, hr, q0, N);
  stage_rows<D, kBKV, true>(ks, k, hr, 0, N);
  ffma::cp_async_commit();
  float m[4] = {-FLT_MAX, -FLT_MAX, -FLT_MAX, -FLT_MAX};
  float s[4][4];
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      stage_rows<D, kBKV, true>(ks + (st ^ 1) * L::kK, k, hr,
                                (kt + 1) * kBKV, N);
      ffma::cp_async_commit();
      ffma::cp_async_wait<1>();
    } else {
      ffma::cp_async_wait<0>();
    }
    __syncthreads();
    scores<D>(qs, ks + st * L::kK, ty, tx, s);
    const int key0 = kt * kBKV + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (key0 + j < n_valid)
          m[i] = fmaxf(m[i], __fmul_rn(s[i][j], scale_log2e));
    __syncthreads();
  }

  // s_p = rowmax(p) / 127, rowmax(p) = exp2(clamp(max t)); the row's keys
  // lie in the 8 lanes of its quarter-warp.
  float s_p[4], inv_sp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mi = m[i];
    mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, 1));
    mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, 2));
    mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, 4));
    s_p[i] = quant_scale(exp2f(fminf(fmaxf(mi, -kCap), kCap)));
    inv_sp[i] = __fdiv_rn(1.f, s_p[i]);
  }

  // Sweep 1: S again, p, the row sums and the codes; O += P8 . V8.
  stage_rows<D, kBKV, true>(ks, k, hr, 0, N);
  stage_v8<D>(vs, v8h, 0, n_pad);
  ffma::cp_async_commit();
  int acc[4][kCh];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[i][c] = 0;
  }
  const int pos = p8_position(tx);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      stage_rows<D, kBKV, true>(ks + (st ^ 1) * L::kK, k, hr,
                                (kt + 1) * kBKV, N);
      stage_v8<D>(vs + (st ^ 1) * L::kV8, v8h, (kt + 1) * kBKV, n_pad);
      ffma::cp_async_commit();
      ffma::cp_async_wait<1>();
    } else {
      ffma::cp_async_wait<0>();
    }
    __syncthreads();
    scores<D>(qs, ks + st * L::kK, ty, tx, s);
    const int key0 = kt * kBKV + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int code[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = __fmul_rn(s[i][j], scale_log2e);
        const float p =
            key0 + j < n_valid ? exp2f(fminf(fmaxf(t, -kCap), kCap)) : 0.f;
        l[i] += p;
        code[j] = static_cast<int>(fminf(
            fmaxf(rintf(quotient(p, s_p[i], inv_sp[i])), 0.f), 127.f));
      }
      unsigned char* row = ps + (ty * 4 + i) * kBKV + pos;
      *reinterpret_cast<uint16_t*>(row) =
          static_cast<uint16_t>(code[0] | (code[1] << 8));
      *reinterpret_cast<uint16_t*>(row + 4) =
          static_cast<uint16_t>(code[2] | (code[3] << 8));
    }
    __syncthreads();

    // O += P8 . V8 over the tile's 32 stored positions, 16 at a time.
    const unsigned char* vst = vs + st * L::kV8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint4 pw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pw[i] = *reinterpret_cast<const uint4*>(ps + (ty * 4 + i) * kBKV +
                                                16 * half);
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const int d = tx + 8 * c;
        const uint4 vw = *reinterpret_cast<const uint4*>(
            vst + 32 * d + 16 * (half ^ ((d >> 2) & 1)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int a = acc[i][c];
          a = __dp4a(static_cast<int>(pw[i].x), static_cast<int>(vw.x), a);
          a = __dp4a(static_cast<int>(pw[i].y), static_cast<int>(vw.y), a);
          a = __dp4a(static_cast<int>(pw[i].z), static_cast<int>(vw.z), a);
          acc[i][c] =
              __dp4a(static_cast<int>(pw[i].w), static_cast<int>(vw.w), a);
        }
      }
    }
    __syncthreads();
  }

  // Row sums over the quarter-warp; o = float(acc) * ((s_p / denom) * s_v).
  const float* sv = s_v + static_cast<size_t>(bh) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int row = q0 + ty * 4 + i;
    if (row >= N) continue;
    const float ratio = __fdiv_rn(s_p[i], li);
    float* out = o + hr.base + static_cast<size_t>(row) * hr.stride;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int d = tx + 8 * c;
      out[d] = __fmul_rn(__int2float_rn(acc[i][c]), __fmul_rn(ratio, sv[d]));
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int8_t* v8, float* stats, int B, int N, int H, int n_valid,
                   float scale_log2e, cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = allow_smem(int8_attn_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  err = launch_v_prologue<float, D>(v, stats, v8, B, N, H, n_valid, stream);
  if (err != cudaSuccess) return err;
  const int q_tiles = (N + kBQ - 1) / kBQ;
  const int n_pad = (N + 63) / 64 * 64;
  int8_attn_f32_kernel<D><<<static_cast<unsigned>(q_tiles) * B * H, kThreads,
                            smem, stream>>>(q, k, v8, stats, o, N, H,
                                            q_tiles, n_valid, n_pad,
                                            scale_log2e);
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
  using nvt::Layout;
  if (d == 64) return static_cast<long long>(Layout<64>::kBytes);
  if (d == 128) return static_cast<long long>(Layout<128>::kBytes);
  return -1;
}
