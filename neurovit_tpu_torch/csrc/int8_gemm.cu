// GEMM probes: bf16 x bf16 -> f32 and int8 x int8 -> int32 (K17), and the
// int8 GEMM with the serving epilogue (K18), on TMA and wgmma.
//
// Replaces the TPU kernels of scripts/int8_pallas_bench.py:
//   K17 :30 _mm_kernel (blocked_matmul, :40): C = A . B, A [M, K], B [K, N]
//       row-major, f32 sums of bf16 products or int32 sums of int8 ones;
//   K18 :55 _dq_kernel (dynquant_matmul, :67): the int8 product, then
//       C = bf16((float(acc) * sa[m]) * sb[n]), each product rounded in f32.
// The probe asks how much int8 gains over bf16 on the same tiling, so all
// three run one mainloop.
//
// What bounds it on the H100: 2 M K N operations against (M K + K N)
// operand bytes and M N outputs. At the probe's shapes (M 4096-8192, K and
// N 64-4096) that is the tensor cores (989 bf16 TFLOP/s, 1,979 int8
// TOP/s), except K17 int8 at fc1 ([8192, 1024] x [1024, 2048]), whose 67 MB
// int32 output takes longer to write than its operations take at the int8
// rate. So the design feeds the tensor cores with wgmma, its only path to
// their full rate, and keeps its loads off the threads: hopper_gemm.cuh's
// Mainloop, a 4-stage ring of 128-byte-swizzled TMA boxes (128 bytes of K
// by 128 rows of A and of B^T, 32 KiB a stage) filled by one producer warp,
// with two consumer warpgroups each running m64n128 wgmmas on 64 rows
// (64 x 64 tiles and one warpgroup where N <= 64, so the attention PV
// shape still fills the card). wgmma takes int8 operands only K-major, so
// each launch first transposes B [K, N] into the caller's scratch Bt [N,
// K] (transpose_kernel, timed as part of the function); bf16 takes the same
// path. The epilogue goes from the accumulator registers to device memory
// as 8-byte pairs (4-byte bf16 pairs for K18), masked at M and N; TMA
// zero-fills the boxes past M, N and K. M, N and K are multiples of 16.
#include <type_traits>

#include "hopper_gemm.cuh"

namespace nvt {
namespace {

// Bt[n, k] = B[k, n] for B [K, N] row-major, one tile of 128 bytes by 128
// bytes (64 x 64 bf16, 128 x 128 int8) per block through shared memory, in
// 16-byte vectors both ways: a warp reads four 128-byte rows of B and
// writes four of Bt. A thread gathers its 16-byte chunk of Bt from one
// column of 16 / sizeof(T) tile rows; chunk c of tile row r is kept at
// position c ^ (r / (16 / sizeof(T))) % 8 of its row, so the eight rows a
// warp gathers from at once sit in eight different groups of banks.
template <typename T>
__global__ void __launch_bounds__(256)
    transpose_kernel(const T* __restrict__ b, T* __restrict__ bt, int K,
                     int N) {
  constexpr int V = 16 / sizeof(T);       // elements a chunk
  constexpr int kTile = 128 / sizeof(T);  // elements a tile side
  __shared__ uint4 tile[kTile * 8];       // kTile rows of 8 chunks
  const int k0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile * 8; i += 256) {
    const int r = i / 8, c = i % 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < K && n0 + c * V < N)
      v = *reinterpret_cast<const uint4*>(b + size_t(k0 + r) * N + n0 + c * V);
    tile[r * 8 + (c ^ ((r / V) % 8))] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * 8; i += 256) {
    const int n = i / 8, kc = i % 8;   // Bt row n, its chunk kc
    if (n0 + n >= N || k0 + kc * V >= K) continue;
    uint4 v;
    T* out = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < V; ++j)
      out[j] = reinterpret_cast<const T*>(
          &tile[(kc * V + j) * 8 + ((n / V) ^ kc)])[n % V];
    *reinterpret_cast<uint4*>(bt + size_t(n0 + n) * K + k0 + kc * V) = v;
  }
}

template <bool kInt8, int BM, int BN, bool kDequant>
__global__ void __launch_bounds__(hopper::Mainloop<kInt8, BM, BN>::kThreads)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const float* __restrict__ sa, const float* __restrict__ sb,
                void* __restrict__ C, int M, int N, int K) {
  using L = hopper::Mainloop<kInt8, BM, BN>;
  using Acc = typename L::Acc;
  extern __shared__ unsigned char smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  Acc acc[L::kAccRegs];
  if (!L::run(&ta, &tb, m0, n0, K, smem, acc)) return;
  L::for_each_pair(acc, [&](int r, int c, Acc v0, Acc v1) {
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) return;   // N is even: col + 1 < N too
    const size_t at = size_t(row) * N + col;
    if constexpr (kDequant) {
      const float s = sa[row];
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(C) + at) =
          __floats2bfloat162_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(v0), s), sb[col]),
              __fmul_rn(__fmul_rn(__int2float_rn(v1), s), sb[col + 1]));
    } else if constexpr (kInt8) {
      *reinterpret_cast<int2*>(static_cast<int*>(C) + at) = make_int2(v0, v1);
    } else {
      *reinterpret_cast<float2*>(static_cast<float*>(C) + at) =
          make_float2(v0, v1);
    }
  });
}

template <bool kInt8, int BM, int BN, bool kDequant>
cudaError_t launch_tile(const void* a, const void* bt, const void* sa,
                        const void* sb, void* c, int M, int N, int K,
                        cudaStream_t s) {
  using L = hopper::Mainloop<kInt8, BM, BN>;
  CUtensorMap ta, tb;
  cudaError_t err = hopper::encode_kmajor(&ta, a, M, K, kInt8, BM);
  if (err != cudaSuccess) return err;
  err = hopper::encode_kmajor(&tb, bt, N, K, kInt8, BN);
  if (err != cudaSuccess) return err;
  const auto kernel = gemm_kernel<kInt8, BM, BN, kDequant>;
  err = allow_smem(kernel, L::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, L::kThreads, L::kSmemBytes, s>>>(
      ta, tb, static_cast<const float*>(sa), static_cast<const float*>(sb), c,
      M, N, K);
  return cudaGetLastError();
}

template <bool kInt8, bool kDequant>
int launch(const void* a, const void* b, void* bt, const void* sa,
           const void* sb, void* c, int M, int N, int K, void* stream) {
  if (M < 16 || N < 16 || K < 16 || M % 16 || N % 16 || K % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  using T = typename std::conditional<kInt8, signed char, bf16>::type;
  constexpr int kTile = 128 / sizeof(T);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 tgrid((N + kTile - 1) / kTile, (K + kTile - 1) / kTile);
  transpose_kernel<T><<<tgrid, 256, 0, s>>>(static_cast<const T*>(b),
                                             static_cast<T*>(bt), K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = N <= 64
            ? launch_tile<kInt8, 64, 64, kDequant>(a, bt, sa, sb, c, M, N, K, s)
            : launch_tile<kInt8, 128, 128, kDequant>(a, bt, sa, sb, c, M, N, K,
                                                     s);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace nvt

// K17, bf16: a [M, K], b [K, N] bf16 row-major; bt [N, K] bf16 scratch (b
// transposed into it first); c [M, N] f32. M, N, K multiples of 16.
extern "C" int nvt_gemm_bf16(const void* a, const void* b, void* bt, void* c,
                             int M, int N, int K, void* stream) {
  return nvt::launch<false, false>(a, b, bt, nullptr, nullptr, c, M, N, K,
                                   stream);
}

// K17, int8: a [M, K], b [K, N] int8 row-major; bt [N, K] int8 scratch; c
// [M, N] int32.
extern "C" int nvt_gemm_int8(const void* a, const void* b, void* bt, void* c,
                             int M, int N, int K, void* stream) {
  return nvt::launch<true, false>(a, b, bt, nullptr, nullptr, c, M, N, K,
                                  stream);
}

// K18: the int8 product of a and b (bt [N, K] int8 scratch), then c =
// bf16((float(acc) * sa[m]) * sb[n]); sa [M], sb [N] f32; c [M, N] bf16.
extern "C" int nvt_gemm_int8_dequant(const void* a, const void* b, void* bt,
                                     const void* sa, const void* sb, void* c,
                                     int M, int N, int K, void* stream) {
  return nvt::launch<true, true>(a, b, bt, sa, sb, c, M, N, K, stream);
}

// Dynamic shared memory of one block of the BM x BN instance (the same for
// bf16 and int8), or -1 for a tile the kernels do not have.
extern "C" long long nvt_gemm_smem_bytes(int bm, int bn) {
  if (bm == 64 && bn == 64)
    return static_cast<long long>(
        nvt::hopper::Mainloop<false, 64, 64>::kSmemBytes);
  if (bm == 128 && bn == 128)
    return static_cast<long long>(
        nvt::hopper::Mainloop<false, 128, 128>::kSmemBytes);
  return -1;
}
