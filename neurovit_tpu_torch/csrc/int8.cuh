// Shared device code of the int8 serving kernels (K10-K13).
//
// The scheme is the JAX package's (neurovit_tpu/ops/int8_serving.py:13-22):
// weights are int8 per output channel, quantized once on the host;
// activations are quantized per row inside the kernel, symmetric,
//   scale = amax > 0 ? amax / 127 : 1,  code = clamp(rint(u / scale), +-127)
// (rint is round-half-even, like jnp.round); the products are exact int32
// sums, dequantized as float(acc) * s_row * s_col in f32.
//
// int8 tiles in shared memory are "K16-chunked": element (r, k) of a tile
// of R rows sits at byte ((k / 16) * R + r) * 16 + k % 16. Every 16 x 16
// wmma fragment is then one contiguous 256-byte block with a leading
// dimension of 16, so its pointer has the 32-byte (256-bit) alignment that
// load_matrix_sync asks for at every k step (a row-major int8 tile would
// put every other 16-wide k step on a 16-byte boundary), and a warp's
// fragment load touches each bank the same number of times.
#pragma once

#include "common.cuh"

namespace nvt {

__host__ __device__ constexpr int chunked(int r, int k, int rows) {
  return ((k >> 4) * rows + r) * 16 + (k & 15);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The symmetric scale of a row (or channel) whose largest magnitude is amax.
__device__ __forceinline__ float quant_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}

// round(u / scale) clamped to [lo, 127]; IEEE division, half-even rounding.
__device__ __forceinline__ int quant_code(float u, float scale, float lo) {
  return static_cast<int>(
      fminf(fmaxf(rintf(__fdiv_rn(u, scale)), lo), 127.f));
}

// float(acc) * s_row * s_col, rounded after each product (no contraction).
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col);
}

// Eight int8 codes, one 8-byte store.
__device__ __forceinline__ uint2 pack_codes(const int* c) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo |= (static_cast<uint32_t>(c[i]) & 0xFFu) << (8 * i);
    hi |= (static_cast<uint32_t>(c[i + 4]) & 0xFFu) << (8 * i);
  }
  return make_uint2(lo, hi);
}

// Quantize the BM rows row0 .. row0 + BM - 1 of x [M, dim] (bf16) per row
// into A8 (chunked, BM rows) and s_row[BM]: one warp per row, the row held
// in registers (dim % 256 == 0, dim <= 1024), so amax is known before any
// code is written. With LN, the row is first u = LN(x) * gamma + beta in
// f32 with the JAX kernels' order of operations (int8_serving.py:122-127,
// 158-159): mean, mean of squared deviations, rsqrt(var + eps), xhat *
// gamma + beta -- and, unlike the bf16 kernels, u is not rounded to bf16.
// Rows at or past M get zero codes.
template <int BM, int THREADS, bool LN>
__device__ void rowquant_rows(const bf16* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta, int8_t* A8,
                              float* s_row, int row0, int M, int dim,
                              float eps) {
  constexpr int kMaxGroups = 4;  // 4 x 256 columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = dim / 256;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = row0 + r;
    if (row >= M) {
      for (int g = 0; g < groups; ++g)
        *reinterpret_cast<uint2*>(A8 + chunked(r, g * 256 + lane * 8, BM)) =
            make_uint2(0u, 0u);
      if (lane == 0) s_row[r] = 1.f;
      continue;
    }
    const bf16* xrow = x + static_cast<size_t>(row) * dim;
    // Lane l holds columns g * 256 + l * 8 .. + 7 of each group g; the
    // groups past dim stay zero and take no part in the sums or the amax.
    float u[kMaxGroups][8] = {};
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g < groups) {
        unpack8(*reinterpret_cast<const uint4*>(xrow + g * 256 + lane * 8),
                u[g]);
      }
    }
    if constexpr (LN) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s += u[g][i];
      }
      const float mean = warp_sum(s) / dim;
      float ss = 0.f;
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g < groups) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float d = u[g][i] - mean;
            ss += d * d;
          }
        }
      }
      const float rstd = rsqrtf(warp_sum(ss) / dim + eps);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g < groups) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = g * 256 + lane * 8 + i;
            const float xhat = __fmul_rn(u[g][i] - mean, rstd);
            u[g][i] = __fadd_rn(__fmul_rn(xhat, gamma[c]), beta[c]);
          }
        }
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g < groups) {
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(u[g][i]));
      }
    }
    const float scale = quant_scale(warp_max(amax));
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g < groups) {
        int codes[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          codes[i] = quant_code(u[g][i], scale, -127.f);
        *reinterpret_cast<uint2*>(A8 + chunked(r, g * 256 + lane * 8, BM)) =
            pack_codes(codes);
      }
    }
    if (lane == 0) s_row[r] = scale;
  }
}

// C[BM, BN] = A8[BM, K] . W8[n0 : n0 + BN, 0 : K]^T, int8 in, exact int32
// out: the int8 counterpart of nvt::TileGemm.
//
// A8 is an int8 row block in shared memory, chunked over its BM rows. W8 is
// a torch-layout weight [N, K] in global memory (row n = output column n),
// read as a col_major wmma B operand with no transpose; it streams from L2
// through a two-stage cp.async ring of BN x BK tiles, each stored chunked
// over its BN rows. The int32 result lands in shared memory as C[BM][BN + 4],
// aliasing the ring, for the caller's fused epilogue. wmma's 16x16x16 int8
// tiles (signed char, int accumulator) run on sm_72 and later: the simple
// first version, as TileGemm's bf16 tiles are.
//
// Contract: K % BK == 0, the W rows n0 .. n0 + BN exist, W and scratch are
// 16-byte aligned and K is a multiple of 16 bytes. All threads of the block
// call run() together.
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
struct TileGemmI8 {
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  static constexpr int kStage = BN * BK;  // bytes
  static constexpr int LDC = BN + 4;
  static constexpr size_t kRingBytes = 2ull * kStage;
  static constexpr size_t kCBytes = 1ull * BM * LDC * sizeof(int);
  static constexpr size_t kScratchBytes =
      kRingBytes > kCBytes ? kRingBytes : kCBytes;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tile shape");

  __device__ static void load_w(int8_t* stage, const int8_t* __restrict__ W,
                                int ldw, int n0, int k0) {
    constexpr int kChunks = BN * BK / 16;
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int r = c / (BK / 16), kc = c % (BK / 16);
      cp_async16(stage + (kc * BN + r) * 16,
                 W + static_cast<size_t>(n0 + r) * ldw + k0 + kc * 16, 16);
    }
  }

  __device__ static void run(const int8_t* A8, const int8_t* __restrict__ W,
                             int ldw, int n0, int K, void* scratch) {
    int8_t* ring = reinterpret_cast<int8_t*>(scratch);
    int* C = reinterpret_cast<int*>(scratch);
    const int warp = threadIdx.x / 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

    // The caller's previous epilogue may still read C (= the ring), and
    // its prologue may still write A8.
    __syncthreads();
    const int KT = K / BK;
    load_w(ring, W, ldw, n0, 0);
    cp_async_commit();
    for (int kt = 0; kt < KT; ++kt) {
      if (kt + 1 < KT) {
        load_w(ring + ((kt + 1) & 1) * kStage, W, ldw, n0, (kt + 1) * BK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int8_t* Ws = ring + (kt & 1) * kStage;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> a[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::col_major> b[FN];
        const int kc = kt * (BK / 16) + kk;
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(a[i], A8 + (kc * BM + wm * WM + i * 16) * 16,
                                 16);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(b[j], Ws + (kk * BN + wn * WN + j * 16) * 16,
                                 16);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      // Every warp is done with this stage before it is refilled.
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(
            C + (wm * WM + i * 16) * LDC + wn * WN + j * 16, acc[i][j], LDC,
            wmma::mem_row_major);
    __syncthreads();
  }
};

}  // namespace nvt
