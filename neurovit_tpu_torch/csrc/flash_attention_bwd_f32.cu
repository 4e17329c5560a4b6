// Flash attention backward at f32 on the CUDA cores, in two layouts:
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
// + h) N + q) N + k, the forward's bits (flash_f32.cuh keep_bits4).
//
// What bounds it on the H100: 8 B H N n_valid D flops for the five
// products, exact in f32 only on the CUDA cores (ffma.cuh says why not
// TF32): 41 GFLOP for the flagship block at batch 8 (B H = 64, N = n_valid
// = 1001, D = 64), 0.61 ms at 67 TFLOP/s; this design recomputes S and dP
// in both passes, 57.4 GFLOP, 0.86 ms.
//
// The design, the bf16 K5's two passes with no atomics, each a block of
// 128 threads on K1 f32's layout (flash_f32.cuh: rows of f32 chunks
// permuted by the row's quad, copies by 16-byte cp.async, two tiles in
// flight), one-dimensional grids with a head's tiles adjacent:
//   dq_f32_kernel   a block owns 64 query rows; it first takes delta of its
//                   rows from dO and O (and writes it for pass 2) and each
//                   row's l, then walks the key tiles of 32 below n_valid:
//                   S = Q K^T and dP = dO V^T (a thread 4 rows x 4 keys of
//                   each), dS formed in registers and passed through
//                   shared memory, dQ += dS K (a thread 4 rows x D / 8
//                   columns).
//   dkv_f32_kernel  a block owns 64 keys and up to 64 columns of dK and dV
//                   (two blocks split D = 128, whose accumulators would
//                   take 128 registers); it walks every query tile of 32,
//                   the tile's l and delta staged beside Q and dO (the
//                   [B, H, N] statistics' rows are not 16-byte aligned:
//                   4-byte copies), S^T = K Q^T and dP^T = V dO^T (a thread
//                   4 keys x 4 queries: l and delta are per column), dS^T
//                   and (P m)^T through shared memory, dK += dS^T Q and dV
//                   += (P m)^T dO. Key blocks at or past n_valid write
//                   zeros.
// Head dims are instances at 32, 64 and 128 (ops/flash_attention.py pads
// the others), as K1 f32's; the layout changes only where a head's rows
// lie, so both layouts share the grids and the shared memory.
#include "flash_f32.cuh"

namespace nvt {
namespace {

using flash_f32::kCap;
using flash_f32::kThreads;
using flash_f32::keep_bits4;
using flash_f32::stage_rows;
using flash_f32::swz;

constexpr int kBQ = 64, kBKV = 32;   // pass 1: query rows a block, keys a tile
constexpr int kBK = 64, kBQT = 32;   // pass 2: keys a block, queries a tile

// Pass 2's columns of dK and dV a block.
template <int D>
constexpr int kDc = D < 64 ? D : 64;

template <int D>
struct DqLayout {
  static constexpr int kQ = kBQ * D;       // floats of the Q or dO tile
  static constexpr int kKV = kBKV * D;     // of a K or V tile (two stages)
  static constexpr int kS = kBQ * kBKV;    // of the dS tile
  static constexpr size_t kBytes =
      static_cast<size_t>(2 * kQ + 4 * kKV + kS) * sizeof(float);
};

template <int D>
struct DkvLayout {
  static constexpr int kK = kBK * D;       // floats of the K or V tile
  static constexpr int kQ = kBQT * D;      // of a Q or dO tile (two stages)
  static constexpr int kT = kBK * kBQT;    // of the dS^T or (P m)^T tile
  static constexpr int kStat = 2 * kBQT;   // of a tile's l and delta
  static constexpr size_t kBytes =
      static_cast<size_t>(2 * kK + 4 * kQ + 2 * kT + 2 * kStat) *
      sizeof(float);
};

// s[i][j] = row ra * 4 + i of a . row rb * 4 + j of b, two tiles D wide
// in the permuted layout.
template <int D>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int ra, int rb, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D / 4; ++c) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + swz(ra * 4 + i, c, D));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + swz(rb * 4 + j, c, D));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(av[i].x, bv[j].x, t);
        t = fmaf(av[i].y, bv[j].y, t);
        t = fmaf(av[i].z, bv[j].z, t);
        s[i][j] = fmaf(av[i].w, bv[j].w, t);
      }
  }
}

__device__ __forceinline__ float pick4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Pass 1: delta and dQ of 64 query rows. At D = 128 its shared memory
// leaves room for one block an SM, so ptxas may give a thread all the
// registers (its default of three blocks an SM, 168 registers, spilled
// 24 bytes there).
template <int D, bool kBhnd>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 3)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lsum, float* __restrict__ delta,
                  float* __restrict__ dq, int N, int H, int q_tiles,
                  int n_valid, float scale_log2, float ds_scale, float keep,
                  uint32_t keep_q, uint64_t seed) {
  using L = DqLayout<D>;
  constexpr int kCols = D / 32;  // float4 columns of dQ a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + L::kQ;
  float* ks = dos + L::kQ;       // two stages
  float* vs = ks + 2 * L::kKV;   // two stages
  float* ss = vs + 2 * L::kKV;

  const int qt = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const HeadRows<kBhnd> hr(bh / H, bh % H, N, H, D);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int n_tiles = (n_valid + kBKV - 1) / kBKV;

  stage_rows<D, kBQ, true>(qs, q, hr, q0, N);
  stage_rows<D, kBQ, true>(dos, dout, hr, q0, N);
  stage_rows<D, kBKV, true>(ks, k, hr, 0, N);
  stage_rows<D, kBKV, true>(vs, v, hr, 0, N);
  ffma::cp_async_commit();

  // delta and l of the thread's rows ty * 4 + i, while the copies land;
  // the 8 lanes of a row hold its columns tx * 4 + 32 c.
  float l[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    float d = 0.f;
    if (row < N) {
      const size_t at = hr.base + static_cast<size_t>(row) * hr.stride +
                        tx * 4;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(o + at + 32 * c);
        const float4 b = *reinterpret_cast<const float4*>(dout + at + 32 * c);
        d += (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    dlt[i] = keep * d;
    l[i] = row < N ? lsum[static_cast<size_t>(bh) * N + row] : 1.f;
    if (tx == 0 && row < N) delta[static_cast<size_t>(bh) * N + row] = dlt[i];
  }

  float4 acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      stage_rows<D, kBKV, true>(ks + (st ^ 1) * L::kKV, k, hr,
                                (kt + 1) * kBKV, N);
      stage_rows<D, kBKV, true>(vs + (st ^ 1) * L::kKV, v, hr,
                                (kt + 1) * kBKV, N);
      ffma::cp_async_commit();
      ffma::cp_async_wait<1>();
    } else {
      ffma::cp_async_wait<0>();
    }
    __syncthreads();

    const float* kst = ks + st * L::kKV;
    const float* vst = vs + st * L::kKV;
    float s[4][4], dp[4][4];
    tile_dots<D>(qs, kst, ty, tx, s);
    tile_dots<D>(dos, vst, ty, tx, dp);

    // dS of rows ty * 4 + i, keys key0 + j, to shared memory.
    const int key0 = kt * kBKV + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t kept =
          keep_q ? keep_bits4(
                       (static_cast<uint64_t>(bh) * N + q0 + ty * 4 + i) * N +
                           key0,
                       seed, keep_q)
                 : 0xfu;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e =
            exp2f(fminf(fmaxf(s[i][j] * scale_log2, -kCap), kCap));
        const float p = key0 + j < n_valid ? e / l[i] : 0.f;
        const float dpm = (kept >> j) & 1u ? dp[i][j] : 0.f;
        ds[j] = p * (dpm - dlt[i]) * ds_scale;
      }
      *reinterpret_cast<float4*>(ss + swz(ty * 4 + i, tx, kBKV)) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ += dS . K over the tile's keys.
#pragma unroll 2
    for (int c = 0; c < kBKV / 4; ++c) {
      float4 dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dv[i] = *reinterpret_cast<const float4*>(ss + swz(ty * 4 + i, c, kBKV));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const float4 kv = *reinterpret_cast<const float4*>(
              kst + swz(c * 4 + kk, tx + 8 * cc, D));
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(acc[i][cc], pick4(dv[i], kk), kv);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= N) continue;
    float* out = dq + hr.base + static_cast<size_t>(row) * hr.stride + tx * 4;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      *reinterpret_cast<float4*>(out + 32 * cc) = acc[i][cc];
  }
}

// Copy a query tile's l and delta ([B, H, N] rows at bh, from q0) into
// st[0 .. 31] and st[32 .. 63], zeros past N.
__device__ __forceinline__ void stage_stats(float* st, const float* lsum,
                                            const float* delta, size_t row0,
                                            int q0, int N) {
  const int t = threadIdx.x;
  if (t >= 2 * kBQT) return;
  const int q = q0 + (t % kBQT);
  const bool valid = q < N;
  const float* src = (t < kBQT ? lsum : delta) + row0 + (valid ? q : 0);
  ffma::cp_async4(st + t, src, valid);
}

// Pass 2: dK and dV of 64 keys, columns c0 .. c0 + kDc - 1.
template <int D, bool kBhnd>
__global__ void __launch_bounds__(kThreads)
    dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lsum,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int N, int H, int k_tiles,
                   int n_valid, float scale_log2, float ds_scale,
                   float inv_keep, uint32_t keep_q, uint64_t seed) {
  using L = DkvLayout<D>;
  constexpr int kParts = D / kDc<D>, kCols = kDc<D> / 32;
  extern __shared__ __align__(16) float smem[];
  float* kts = smem;
  float* vts = kts + L::kK;
  float* qs = vts + L::kK;        // two stages
  float* dos = qs + 2 * L::kQ;    // two stages
  float* ts = dos + 2 * L::kQ;    // dS^T
  float* ps = ts + L::kT;         // (P m)^T
  float* stat = ps + L::kT;       // two stages of [l, delta]

  const int kt = blockIdx.x % k_tiles;
  const int rest = blockIdx.x / k_tiles;
  const int part = rest % kParts, bh = rest / kParts;
  const HeadRows<kBhnd> hr(bh / H, bh % H, N, H, D);
  const int k0 = kt * kBK, c0 = part * kDc<D>;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const size_t row0 = static_cast<size_t>(bh) * N;

  if (k0 >= n_valid) {   // keys at or past n_valid have no gradient
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + ty * 4 + i;
      if (row >= N) continue;
      const size_t at =
          hr.base + static_cast<size_t>(row) * hr.stride + c0 + tx * 4;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        *reinterpret_cast<float4*>(dk + at + 32 * cc) = zero;
        *reinterpret_cast<float4*>(dv + at + 32 * cc) = zero;
      }
    }
    return;
  }

  const int q_tiles = (N + kBQT - 1) / kBQT;
  stage_rows<D, kBK, true>(kts, k, hr, k0, N);
  stage_rows<D, kBK, true>(vts, v, hr, k0, N);
  stage_rows<D, kBQT, true>(qs, q, hr, 0, N);
  stage_rows<D, kBQT, true>(dos, dout, hr, 0, N);
  stage_stats(stat, lsum, delta, row0, 0, N);
  ffma::cp_async_commit();

  float4 adk[4][kCols], adv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      adk[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      adv[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  const int key0 = k0 + ty * 4;

  for (int qt = 0; qt < q_tiles; ++qt) {
    const int st = qt & 1;
    if (qt + 1 < q_tiles) {
      const int nq = (qt + 1) * kBQT;
      stage_rows<D, kBQT, true>(qs + (st ^ 1) * L::kQ, q, hr, nq, N);
      stage_rows<D, kBQT, true>(dos + (st ^ 1) * L::kQ, dout, hr, nq, N);
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
    float s[4][4], dp[4][4];
    tile_dots<D>(kts, qst, ty, tx, s);     // keys ty * 4 + i, queries tx * 4 + j
    tile_dots<D>(vts, dost, ty, tx, dp);

    float dsv[4][4], pmv[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qrow = qt * kBQT + tx * 4 + j;
      const float lj = lst[tx * 4 + j], dj = lst[kBQT + tx * 4 + j];
      const uint32_t kept =
          keep_q ? keep_bits4((row0 + qrow) * N + key0, seed, keep_q) : 0xfu;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e =
            exp2f(fminf(fmaxf(s[i][j] * scale_log2, -kCap), kCap));
        const float p = key0 + i < n_valid && qrow < N ? e / lj : 0.f;
        const bool m = (kept >> i) & 1u;
        pmv[i][j] = m ? p : 0.f;
        dsv[i][j] = p * ((m ? dp[i][j] : 0.f) - dj) * ds_scale;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(ts + swz(ty * 4 + i, tx, kBQT)) =
          make_float4(dsv[i][0], dsv[i][1], dsv[i][2], dsv[i][3]);
      *reinterpret_cast<float4*>(ps + swz(ty * 4 + i, tx, kBQT)) =
          make_float4(pmv[i][0], pmv[i][1], pmv[i][2], pmv[i][3]);
    }
    __syncthreads();

    // dK += dS^T . Q and dV += (P m)^T . dO over the tile's queries.
#pragma unroll 2
    for (int c = 0; c < kBQT / 4; ++c) {
      float4 tv[4], pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tv[i] = *reinterpret_cast<const float4*>(ts + swz(ty * 4 + i, c, kBQT));
        pv[i] = *reinterpret_cast<const float4*>(ps + swz(ty * 4 + i, c, kBQT));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const int chunk = c0 / 4 + tx + 8 * cc;
          const float4 qv = *reinterpret_cast<const float4*>(
              qst + swz(c * 4 + kk, chunk, D));
          const float4 ov = *reinterpret_cast<const float4*>(
              dost + swz(c * 4 + kk, chunk, D));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fma4(adk[i][cc], pick4(tv[i], kk), qv);
            fma4(adv[i][cc], pick4(pv[i], kk), ov);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = key0 + i;
    if (row >= N) continue;
    const size_t at =
        hr.base + static_cast<size_t>(row) * hr.stride + c0 + tx * 4;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      *reinterpret_cast<float4*>(dk + at + 32 * cc) = adk[i][cc];
      const float4 a = adv[i][cc];
      *reinterpret_cast<float4*>(dv + at + 32 * cc) = make_float4(
          a.x * inv_keep, a.y * inv_keep, a.z * inv_keep, a.w * inv_keep);
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
  const unsigned q_tiles = (N + kBQ - 1) / kBQ;
  dq_kernel<<<q_tiles * B * H, kThreads, DqLayout<D>::kBytes, stream>>>(
      q, k, v, o, dout, lsum, delta, dq, N, H, q_tiles, n_valid, scale_log2,
      ds_scale, keep, keep_q, seed);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned k_tiles = (N + kBK - 1) / kBK;
  dkv_kernel<<<k_tiles * (D / kDc<D>) * B * H, kThreads, DkvLayout<D>::kBytes,
               stream>>>(q, k, v, dout, lsum, delta, dk, dv, N, H, k_tiles,
                         n_valid, scale_log2, ds_scale, inv_keep, keep_q,
                         seed);
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
      2LL * ((N + kBK - 1) / kBK) * B * H > 0x7fffffffLL)
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
