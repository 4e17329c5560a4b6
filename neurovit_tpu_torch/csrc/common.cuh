// Shared device code for the package's Hopper kernels (sm_90a).
//
// Every kernel here computes bf16 products with f32 accumulation on the
// tensor cores through nvcuda::wmma 16x16x16 tiles: the simple, correct
// first version. TMA and wgmma come later, kernel by kernel.
//
// Host entry points have a plain C interface: each returns the
// cudaError_t of its launch (0 on success) and allocates nothing; the
// Python wrapper allocates every output with torch.empty.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace nvt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Row padding of shared-memory bf16 tiles, in elements (16 bytes): rows of
// a power-of-two width would otherwise start in the same bank.
constexpr int kPad = 8;

__host__ __device__ constexpr size_t round_up(size_t x, size_t to) {
  return (x + to - 1) / to * to;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous global -> shared copy; src_bytes == 0 writes zeros
// (how the kernels fill the rows past a ragged edge).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Philox4x32-10 (Salmon et al., SC'11) of the counter (ctr, 0) -- the
// 64-bit counter as words (lo, hi, 0, 0) -- under a 64-bit key.
__device__ __forceinline__ uint4 philox4x32_10(uint64_t ctr, uint64_t key) {
  uint32_t c0 = static_cast<uint32_t>(ctr);
  uint32_t c1 = static_cast<uint32_t>(ctr >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = static_cast<uint32_t>(key);
  uint32_t k1 = static_cast<uint32_t>(key >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The dropout mask of one site, as a pure function of the element's
// row-major index i in the site's logical tensor: keep where byte i % 16 of
// Philox(i / 16, seed) is below q (neurovit_tpu_torch/nn.py, random_bytes).
// The last Philox block is cached, so a thread walking contiguous indices
// pays one Philox call per 16 elements; any tiling gives the same bits.
struct DropoutBits {
  uint64_t seed;
  uint64_t block;
  uint4 w;

  __device__ explicit DropoutBits(uint64_t s) : seed(s), block(~0ull) {}

  __device__ __forceinline__ uint32_t byte(uint64_t i) {
    const uint64_t b = i >> 4;
    if (b != block) {
      block = b;
      w = philox4x32_10(b, seed);
    }
    const uint32_t j = static_cast<uint32_t>(i) & 15u;
    const uint32_t word = j < 4 ? w.x : (j < 8 ? w.y : (j < 12 ? w.z : w.w));
    return (word >> ((j & 3u) * 8u)) & 0xFFu;
  }

  __device__ __forceinline__ bool keep(uint64_t i, uint32_t q) {
    return byte(i) < q;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Exact-erf GELU in f32 with CUDA's erff (torch nn.GELU's default). The
// TPU kernels use an Abramowitz-Stegun polynomial (fused_mlp.py:65-79);
// both are within 1.5e-7 of erf.
__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

// Eight bf16 values (one 16-byte vector) <-> floats.
__device__ __forceinline__ void unpack8(uint4 raw, float* f) {
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 raw;
  bf16* h = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(f[i]);
  return raw;
}

// U[r, :] = bf16(LN(x[row0 + r, :]) * gamma + beta) for the BM rows of a
// row block, in f32 with the JAX kernels' order of operations
// (neurovit_tpu/ops/fused_qkv.py:48-63): mean, then the mean of squared
// deviations, rsqrt(var + eps), xhat * gamma + beta, one rounding to bf16.
// One warp per row; rows at or past M are written as zeros. dim % 8 == 0.
template <int BM, int THREADS>
__device__ void layer_norm_rows(const bf16* __restrict__ x,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta, bf16* U,
                                int ldu, int row0, int M, int dim,
                                float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = THREADS / 32;
  for (int r = warp; r < BM; r += kWarps) {
    const int row = row0 + r;
    bf16* urow = U + static_cast<size_t>(r) * ldu;
    if (row >= M) {
      for (int c = lane * 8; c < dim; c += 256)
        *reinterpret_cast<uint4*>(urow + c) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const bf16* xrow = x + static_cast<size_t>(row) * dim;
    float f[8];
    float s = 0.f;
    for (int c = lane * 8; c < dim; c += 256) {
      unpack8(*reinterpret_cast<const uint4*>(xrow + c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += f[i];
    }
    const float mean = warp_sum(s) / dim;
    float ss = 0.f;
    for (int c = lane * 8; c < dim; c += 256) {
      unpack8(*reinterpret_cast<const uint4*>(xrow + c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = f[i] - mean;
        ss += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(ss) / dim + eps);
    for (int c = lane * 8; c < dim; c += 256) {
      unpack8(*reinterpret_cast<const uint4*>(xrow + c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xhat = __fmul_rn(f[i] - mean, rstd);
        f[i] = __fadd_rn(__fmul_rn(xhat, gamma[c + i]), beta[c + i]);
      }
      *reinterpret_cast<uint4*>(urow + c) = pack8(f);
    }
  }
}

// C[BM, BN] = A[BM, K] . W[n0 : n0 + BN, 0 : K]^T, bf16 in, f32 out.
//
// A is a bf16 row block resident in shared memory (leading dimension lda);
// W is a torch Linear weight [N, K], row-major in global memory, so each
// W row is one column of the product: a col_major wmma B operand with no
// transpose anywhere. With KN = true, W is instead [K, N] row-major (the
// backward's products dY . W by the same torch weight) and is read as a
// row_major B operand, again with no transpose. W streams through a
// two-stage cp.async ring of BN x BK tiles (from L2: every row block of
// the grid reads the same W). The f32 result lands in shared memory as
// C[BM][BN + 4], aliasing the ring, for the caller's fused epilogue.
//
// Contract: K % BK == 0, the W columns n0 .. n0 + BN exist, A, W and
// scratch are 16-byte aligned. All threads of the block call run()
// together.
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, bool KN = false>
struct TileGemm {
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  static constexpr int LDB = KN ? BN + kPad : BK + kPad;
  static constexpr int kStage = KN ? BK * LDB : BN * LDB;
  static constexpr int LDC = BN + 4;
  static constexpr size_t kRingBytes = 2ull * kStage * sizeof(bf16);
  static constexpr size_t kCBytes = 1ull * BM * LDC * sizeof(float);
  static constexpr size_t kScratchBytes =
      kRingBytes > kCBytes ? kRingBytes : kCBytes;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tile shape");

  __device__ static void load_w(bf16* stage, const bf16* __restrict__ W,
                                int ldw, int n0, int k0) {
    if constexpr (KN) {
      constexpr int kChunks = BK * BN / 8;
      for (int c = threadIdx.x; c < kChunks; c += kThreads) {
        const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
        cp_async16(stage + r * LDB + col,
                   W + static_cast<size_t>(k0 + r) * ldw + n0 + col, 16);
      }
    } else {
      constexpr int kChunks = BN * BK / 8;
      for (int c = threadIdx.x; c < kChunks; c += kThreads) {
        const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
        cp_async16(stage + r * LDB + col,
                   W + static_cast<size_t>(n0 + r) * ldw + k0 + col, 16);
      }
    }
  }

  __device__ static void run(const bf16* A, int lda,
                             const bf16* __restrict__ W, int ldw, int n0,
                             int K, void* scratch) {
    bf16* ring = reinterpret_cast<bf16*>(scratch);
    float* C = reinterpret_cast<float*>(scratch);
    const int warp = threadIdx.x / 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    // The caller's previous epilogue may still read C (= the ring), and
    // its prologue may still write A.
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
      const bf16* Ws = ring + (kt & 1) * kStage;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            a[FM];
        using BLayout = typename std::conditional<KN, wmma::row_major,
                                                  wmma::col_major>::type;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(
              a[i], A + static_cast<size_t>(wm * WM + i * 16) * lda +
                        kt * BK + kk,
              lda);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          if constexpr (KN)
            wmma::load_matrix_sync(b[j], Ws + kk * LDB + wn * WN + j * 16,
                                   LDB);
          else
            wmma::load_matrix_sync(b[j], Ws + (wn * WN + j * 16) * LDB + kk,
                                   LDB);
        }
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
        wmma::store_matrix_sync(C + (wm * WM + i * 16) * LDC + wn * WN + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
  }
};

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace nvt
