// Tiled GEMM probes: int8 x int8 -> int32 and bf16 x bf16 -> f32 (K17),
// and the int8 GEMM with the serving epilogue (K18).
//
// Replaces the TPU kernels of scripts/int8_pallas_bench.py:
//   K17 :30 _mm_kernel (blocked_matmul, :40): C = A . B, A [M, K], B [K, N]
//       row-major, int32 sums of int8 products or f32 sums of bf16 ones;
//   K18 :55 _dq_kernel (dynquant_matmul, :67): the int8 product, then
//       C = bf16((float(acc) * sa[m]) * sb[n]), each product rounded in f32.
// The probe asks how near the card's int8 tensor-core rate the port's int8
// path (wmma, as csrc/int8.cuh runs it) gets beside bf16 on the same
// tiling, and what the dequant epilogue costs.
//
// What bounds it on the H100: 2 M K N operations against (M K + K N)
// operand bytes and M N outputs -- at the probe's shapes (M 4096-8192,
// K and N 64-4096) the tensor cores, except at K = 64 or N = 64. The TPU
// kernel keeps a whole [256, K] row panel and [K, 256] column panel in
// VMEM; here K is tiled: a block owns a 128 x BN output tile (BN 128, or 64
// where N <= 64, the attention PV shape) and walks K through a three-stage
// cp.async ring of A and B tiles (32 bf16 or 64 int8 of K a stage), eight
// warps each accumulating a 64 x 32 (BN 128) or 32 x 32 (BN 64) sub-tile
// in wmma fragments: int32 for int8 (exact), f32 for bf16. int8 tiles are
// stored K16-chunked (int8.cuh), so every 16 x 16 fragment is one
// 256-byte block. The int32 and f32 results go from the fragments straight
// to device memory; K18 stages each fragment through a warp's 1 KB of
// shared memory for its per-row and per-column scales. M, N and K are
// multiples of 16; ragged tiles are zero-filled and their fragments not
// stored. No wgmma or TMA yet: the simple first version.
#include <type_traits>

#include "int8.cuh"

namespace nvt {
namespace {

constexpr int kBM = 128, kStages = 3, kThreads = 256, kWarps = 8;

template <bool kInt8, int BN>
struct GemmPlan {
  using Elem = typename std::conditional<kInt8, signed char, bf16>::type;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  static constexpr int BK = kInt8 ? 64 : 32;            // k per stage
  static constexpr int WARPS_N = BN == 128 ? 4 : 2;
  static constexpr int WARPS_M = kWarps / WARPS_N;
  static constexpr int WM = kBM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int FM = WM / 16, FN = WN / 16;
  static constexpr int LDA = BK + kPad, LDB = BN + kPad;   // bf16 tiles
  static constexpr size_t kABytes =
      kInt8 ? size_t(kBM) * BK : size_t(kBM) * LDA * sizeof(bf16);
  static constexpr size_t kBBytes =
      kInt8 ? size_t(BK) * BN : size_t(BK) * LDB * sizeof(bf16);
  static constexpr size_t kStageBytes = kABytes + kBBytes;
  static constexpr size_t kEpiBytes = kWarps * 16 * 16 * sizeof(int);
  static constexpr size_t smem(bool dequant) {
    return kStages * kStageBytes + (dequant ? kEpiBytes : 0);
  }
};

// Stage one BM x BK tile of A and one BK x BN tile of B (zero past M, N, K).
template <bool kInt8, int BN>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const void* A, const void* B,
                                           int M, int N, int K, int m0,
                                           int n0, int k0) {
  using P = GemmPlan<kInt8, BN>;
  constexpr int BK = P::BK;
  if constexpr (kInt8) {
    const int8_t* a = static_cast<const int8_t*>(A);
    const int8_t* b = static_cast<const int8_t*>(B);
    int8_t* As = reinterpret_cast<int8_t*>(stage);
    int8_t* Bs = reinterpret_cast<int8_t*>(stage + P::kABytes);
    for (int c = threadIdx.x; c < kBM * BK / 16; c += kThreads) {
      const int r = c / (BK / 16), kc = c % (BK / 16);
      const bool ok = m0 + r < M && k0 + kc * 16 < K;
      cp_async16(As + chunked(r, kc * 16, kBM),
                 ok ? a + size_t(m0 + r) * K + k0 + kc * 16 : a, ok ? 16 : 0);
    }
    // B chunked over its BK rows: element (k, n) at ((n/16) BK + k) 16 + n%16.
    for (int c = threadIdx.x; c < BK * BN / 16; c += kThreads) {
      const int r = c / (BN / 16), nc = c % (BN / 16);
      const bool ok = k0 + r < K && n0 + nc * 16 < N;
      cp_async16(Bs + (nc * BK + r) * 16,
                 ok ? b + size_t(k0 + r) * N + n0 + nc * 16 : b, ok ? 16 : 0);
    }
  } else {
    const bf16* a = static_cast<const bf16*>(A);
    const bf16* b = static_cast<const bf16*>(B);
    bf16* As = reinterpret_cast<bf16*>(stage);
    bf16* Bs = reinterpret_cast<bf16*>(stage + P::kABytes);
    for (int c = threadIdx.x; c < kBM * BK / 8; c += kThreads) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + col < K;
      cp_async16(As + r * P::LDA + col,
                 ok ? a + size_t(m0 + r) * K + k0 + col : a, ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < BK * BN / 8; c += kThreads) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + col < N;
      cp_async16(Bs + r * P::LDB + col,
                 ok ? b + size_t(k0 + r) * N + n0 + col : b, ok ? 16 : 0);
    }
  }
}

template <bool kInt8, int BN, bool kDequant>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const void* __restrict__ A, const void* __restrict__ B,
                const float* __restrict__ sa, const float* __restrict__ sb,
                void* __restrict__ C, int M, int N, int K) {
  using P = GemmPlan<kInt8, BN>;
  using Elem = typename P::Elem;
  using Acc = typename P::Acc;
  constexpr int BK = P::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / P::WARPS_N, wn = warp % P::WARPS_N;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[P::FM][P::FN];
#pragma unroll
  for (int i = 0; i < P::FM; ++i)
#pragma unroll
    for (int j = 0; j < P::FN; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT)
      load_stage<kInt8, BN>(smem + s * P::kStageBytes, A, B, M, N, K, m0, n0,
                            s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    // Stage kt has landed, and every warp is done with stage kt - 1, which
    // the load below refills.
    __syncthreads();
    const unsigned char* stage = smem + (kt % kStages) * P::kStageBytes;
    const Elem* As = reinterpret_cast<const Elem*>(stage);
    const Elem* Bs = reinterpret_cast<const Elem*>(stage + P::kABytes);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, Elem, wmma::row_major>
          a[P::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, Elem, wmma::row_major>
          b[P::FN];
#pragma unroll
      for (int i = 0; i < P::FM; ++i) {
        const int r = wm * P::WM + i * 16;
        if constexpr (kInt8)
          wmma::load_matrix_sync(a[i], As + chunked(r, kk * 16, kBM), 16);
        else
          wmma::load_matrix_sync(a[i], As + r * P::LDA + kk * 16, P::LDA);
      }
#pragma unroll
      for (int j = 0; j < P::FN; ++j) {
        const int n = wn * P::WN + j * 16;
        if constexpr (kInt8)
          wmma::load_matrix_sync(b[j], Bs + ((n / 16) * BK + kk * 16) * 16,
                                 16);
        else
          wmma::load_matrix_sync(b[j], Bs + kk * 16 * P::LDB + n, P::LDB);
      }
#pragma unroll
      for (int i = 0; i < P::FM; ++i)
#pragma unroll
        for (int j = 0; j < P::FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    const int next = kt + kStages - 1;
    if (next < KT)
      load_stage<kInt8, BN>(smem + (next % kStages) * P::kStageBytes, A, B, M,
                            N, K, m0, n0, next * BK);
    cp_async_commit();
  }

  // Fragments wholly inside [M, N] (M and N are multiples of 16).
#pragma unroll
  for (int i = 0; i < P::FM; ++i) {
#pragma unroll
    for (int j = 0; j < P::FN; ++j) {
      const int row = m0 + wm * P::WM + i * 16;
      const int col = n0 + wn * P::WN + j * 16;
      if (row >= M || col >= N) continue;
      if constexpr (!kDequant) {
        wmma::store_matrix_sync(static_cast<Acc*>(C) + size_t(row) * N + col,
                                acc[i][j], N, wmma::mem_row_major);
      } else {
        int* stage = reinterpret_cast<int*>(smem + kStages * P::kStageBytes) +
                     warp * 256;
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int r = lane >> 1, c = (lane & 1) * 8;
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f[e] = dequant(stage[r * 16 + c + e], sa[row + r], sb[col + c + e]);
        *reinterpret_cast<uint4*>(static_cast<bf16*>(C) +
                                  size_t(row + r) * N + col + c) = pack8(f);
        __syncwarp();
      }
    }
  }
}

template <bool kInt8, bool kDequant>
int launch(const void* a, const void* b, const void* sa, const void* sb,
           void* c, int M, int N, int K, void* stream) {
  if (M < 16 || N < 16 || K < 16 || M % 16 || N % 16 || K % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto kernel, int bn, size_t smem) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + bn - 1) / bn, (M + kBM - 1) / kBM);
    kernel<<<grid, kThreads, smem, s>>>(a, b, static_cast<const float*>(sa),
                                        static_cast<const float*>(sb), c, M,
                                        N, K);
    return static_cast<int>(cudaGetLastError());
  };
  if (N <= 64)
    return go(gemm_kernel<kInt8, 64, kDequant>, 64,
              GemmPlan<kInt8, 64>::smem(kDequant));
  return go(gemm_kernel<kInt8, 128, kDequant>, 128,
            GemmPlan<kInt8, 128>::smem(kDequant));
}

}  // namespace
}  // namespace nvt

// K17, bf16: a [M, K], b [K, N] bf16 row-major; c [M, N] f32. M, N, K
// multiples of 16.
extern "C" int nvt_gemm_bf16(const void* a, const void* b, void* c, int M,
                             int N, int K, void* stream) {
  return nvt::launch<false, false>(a, b, nullptr, nullptr, c, M, N, K, stream);
}

// K17, int8: a [M, K], b [K, N] int8 row-major; c [M, N] int32.
extern "C" int nvt_gemm_int8(const void* a, const void* b, void* c, int M,
                             int N, int K, void* stream) {
  return nvt::launch<true, false>(a, b, nullptr, nullptr, c, M, N, K, stream);
}

// K18: the int8 product of a and b, then c = bf16((float(acc) * sa[m]) *
// sb[n]); sa [M], sb [N] f32; c [M, N] bf16.
extern "C" int nvt_gemm_int8_dequant(const void* a, const void* b,
                                     const void* sa, const void* sb, void* c,
                                     int M, int N, int K, void* stream) {
  return nvt::launch<true, true>(a, b, sa, sb, c, M, N, K, stream);
}
