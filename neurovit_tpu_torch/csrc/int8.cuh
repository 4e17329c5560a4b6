// Shared device code of the int8 serving kernels (K10-K13).
//
// The scheme is the JAX package's (neurovit_tpu/ops/int8_serving.py:13-22):
// weights are int8 per output channel, quantized once on the host;
// activations are quantized per row inside the kernel, symmetric,
//   scale = amax > 0 ? amax / 127 : 1,  code = clamp(rint(u / scale), +-127)
// (rint is round-half-even, like jnp.round); the products are exact int32
// sums, dequantized as float(acc) * s_row * s_col in f32.
//
// K10 and K12 share one LayerNorm row-quantize pass, launch_ln_rowquant
// (int8_rowquant.cu), which writes the codes to device memory for their
// TMA + wgmma GEMMs. K11 still quantizes its rows into shared memory
// (rowquant_rows) and runs TileGemmI8 on wmma there. Its int8 tiles in
// shared memory are "K16-chunked": element (r, k) of a tile of R rows sits
// at byte ((k / 16) * R + r) * 16 + k % 16. Every 16 x 16 wmma fragment is
// then one contiguous 256-byte block with a leading dimension of 16, so its
// pointer has the 32-byte (256-bit) alignment that load_matrix_sync asks
// for at every k step (a row-major int8 tile would put every other 16-wide
// k step on a 16-byte boundary), and a warp's fragment load touches each
// bank the same number of times.
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

// Four int8 codes, one 4-byte store.
__device__ __forceinline__ uint32_t pack4(const int (&c)[4]) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    word |= (static_cast<uint32_t>(c[i]) & 0xFFu) << (8 * i);
  return word;
}

// Rows (one warp each) a block of the LayerNorm row-quantize pass.
constexpr int kLnRowWarps = 8;

// (u8, s_row) = rowquant(LN(x) * gamma + beta) for x [M, dim] bf16: u8
// [M, dim] int8 and s_row [M] f32 in device memory, one warp a row, any
// dim that is a multiple of 4 (int8_rowquant.cu). Launched on stream by K10
// and K12 alike; returns the launch's error.
cudaError_t launch_ln_rowquant(const bf16* x, const float* gamma,
                               const float* beta, int8_t* u8, float* s_row,
                               int M, int dim, float eps, cudaStream_t stream);

// Quantize the BM rows row0 .. row0 + BM - 1 of x [M, dim] (bf16) per row
// into A8 (chunked, BM rows) and s_row[BM]: one warp per row, the row held
// in registers (lane l holds columns 256 g + 8 l .. + 7; dim % 8 == 0,
// dim <= 1024), so amax is known before any code is written. The amax is
// over the dim real columns; the codes of the columns dim .. width - 1 (the
// GEMM's k tile, width % 8 == 0) are 0. Rows at or past M get zero codes.
template <int BM, int THREADS>
__device__ void rowquant_rows(const bf16* __restrict__ x, int8_t* A8,
                              float* s_row, int row0, int M, int dim,
                              int width) {
  constexpr int kMaxGroups = 4;  // 4 x 256 columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Group g of this lane holds real columns.
  auto in_row = [&](int g) { return g * 256 + lane * 8 < dim; };
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = row0 + r;
    for (int c = (row >= M ? 0 : dim) + lane * 8; c < width; c += 256)
      *reinterpret_cast<uint2*>(A8 + chunked(r, c, BM)) = make_uint2(0u, 0u);
    if (row >= M) {
      if (lane == 0) s_row[r] = 1.f;
      continue;
    }
    const bf16* xrow = x + static_cast<size_t>(row) * dim;
    // Lane l holds columns g * 256 + l * 8 .. + 7 of each group g; the
    // groups past dim stay zero and take no part in the amax.
    float u[kMaxGroups][8] = {};
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (in_row(g)) {
        unpack8(*reinterpret_cast<const uint4*>(xrow + g * 256 + lane * 8),
                u[g]);
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (in_row(g)) {
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(u[g][i]));
      }
    }
    const float scale = quant_scale(warp_max(amax));
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (in_row(g)) {
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
// Ragged shapes: the k loop runs ceil(K / BK) steps and W bytes at k >= K
// or rows n >= n_end are zero-filled, so C's columns past n_end are 0 and
// the caller masks them; A8's codes at k in K .. round_up(K, BK) must be 0
// (rowquant_rows writes them).
//
// Contract: K % 16 == 0, W and scratch are 16-byte aligned. All threads of
// the block call run() together.
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

  template <bool kMask>
  __device__ static void load_w(int8_t* stage, const int8_t* __restrict__ W,
                                int ldw, int n0, int k0, int K, int n_end) {
    constexpr int kChunks = BN * BK / 16;
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int r = c / (BK / 16), kc = c % (BK / 16);
      const bool ok = !kMask || (n0 + r < n_end && k0 + kc * 16 < K);
      cp_async16(stage + (kc * BN + r) * 16,
                 ok ? W + static_cast<size_t>(n0 + r) * ldw + k0 + kc * 16 : W,
                 ok ? 16 : 0);
    }
  }

  // Only a ragged tile takes the masked loads (as TileGemm).
  __device__ static void run(const int8_t* A8, const int8_t* __restrict__ W,
                             int ldw, int n0, int K, void* scratch,
                             int n_end = 1 << 30) {
    if (K % BK == 0 && n0 + BN <= n_end)
      run_tiles<false>(A8, W, ldw, n0, K, scratch, n_end);
    else
      run_tiles<true>(A8, W, ldw, n0, K, scratch, n_end);
  }

  template <bool kMask>
  __device__ static void run_tiles(const int8_t* A8,
                                   const int8_t* __restrict__ W, int ldw,
                                   int n0, int K, void* scratch, int n_end) {
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
    const int KT = (K + BK - 1) / BK;
    load_w<kMask>(ring, W, ldw, n0, 0, K, n_end);
    cp_async_commit();
    for (int kt = 0; kt < KT; ++kt) {
      if (kt + 1 < KT) {
        load_w<kMask>(ring + ((kt + 1) & 1) * kStage, W, ldw, n0,
                      (kt + 1) * BK, K, n_end);
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
