// Variants of the f32 FFMA GEMM tile (csrc/ffma.cuh), built and timed by
// scripts/torch_ffma_tile_sweep.py on the card: C[M, N] = A[M, K] . B[N,
// K]^T for row-major A and B, K % 16 == 0, an epilogue a float4 of C.
//
// A variant is (T, BN, TM, TN, LY, BK, LOAD, STAGES, MINB): T threads a
// block, a 128 x BN block tile, a TM x TN thread tile (float4 blocks), a
// warp's lanes LY (rows) x 32 / LY (columns), BK-deep k slices, staged by
// 4-byte cp.async copies (LOAD 0, STAGES slices in flight) or by 16-byte
// loads into registers stored transposed (LOAD 1, two slices), and
// __launch_bounds__(T, MINB). (256, 128, 8, 8, 4, 16, 0, 2, 2) is the
// tile of ffma.cuh, which also computes a thread's staging addresses from
// one pointer. The library is the sweep's own: nothing of the package
// links it.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PART
#define PART 0
#endif

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint4 philox(uint64_t ctr, uint64_t key) {
  uint32_t c0 = (uint32_t)ctr, c1 = (uint32_t)(ctr >> 32), c2 = 0, c3 = 0;
  uint32_t k0 = (uint32_t)key, k1 = (uint32_t)(key >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0; c1 = lo1; c2 = hi0 ^ c3 ^ k1; c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}
__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

__device__ __forceinline__ void cp4(float* d, const float* s, bool v) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(d)), "l"(s), "r"(v ? 4 : 0) : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_g() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// R rows x BK of X at row r0, column k0 into xs[k][r] (ld R + 4).
template <int T, int R, int BK>
__device__ __forceinline__ void stage4(float* xs, const float* x, int r0,
                                       int rows, int K, int k0) {
#pragma unroll
  for (int c = 0; c < R * BK / T; ++c) {
    const int idx = threadIdx.x + T * c;
    const int k = (idx & 7) + 8 * (idx / (8 * R));
    const int r = (idx >> 3) % R;
    const bool valid = r0 + r < rows;
    cp4(xs + k * (R + 4) + r, x + (size_t)(valid ? r0 + r : 0) * K + k0 + k,
        valid);
  }
}

template <int T, int R, int BK>
struct Regs { float4 v[R * BK / 4 / T]; };

template <int T, int R, int BK>
__device__ __forceinline__ void pos(int c, int& r, int& kq) {
  const int f = threadIdx.x + T * c;
  const int lane = f & 31, wg = f >> 5;
  r = (wg % (R / 16)) * 16 + (lane & 15);
  kq = (lane >> 4) + 2 * (wg / (R / 16));
}

template <int T, int R, int BK>
__device__ __forceinline__ void ldg(Regs<T, R, BK>& g, const float* x, int r0,
                                    int rows, int K, int k0) {
#pragma unroll
  for (int c = 0; c < R * BK / 4 / T; ++c) {
    int r, kq;
    pos<T, R, BK>(c, r, kq);
    g.v[c] = r0 + r < rows
                 ? __ldg(reinterpret_cast<const float4*>(
                       x + (size_t)(r0 + r) * K + k0 + kq * 4))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
template <int T, int R, int BK>
__device__ __forceinline__ void sts(const Regs<T, R, BK>& g, float* xs) {
#pragma unroll
  for (int c = 0; c < R * BK / 4 / T; ++c) {
    int r, kq;
    pos<T, R, BK>(c, r, kq);
    xs[(kq * 4 + 0) * (R + 4) + r] = g.v[c].x;
    xs[(kq * 4 + 1) * (R + 4) + r] = g.v[c].y;
    xs[(kq * 4 + 2) * (R + 4) + r] = g.v[c].z;
    xs[(kq * 4 + 3) * (R + 4) + r] = g.v[c].w;
  }
}

struct StoreEpi {
  float* c; int n;
  __device__ __forceinline__ void operator()(int row, int col, float4 v) const {
    *reinterpret_cast<float4*>(c + (size_t)row * n + col) = v;
  }
};
struct GeluEpi {
  const float* b1; float* g; float* h; int hid; float inv_keep;
  uint32_t keep_q; uint64_t seed;
  __device__ __forceinline__ void operator()(int row, int col, float4 c) const {
    const size_t at = (size_t)row * hid + col;
    const float4 b = *reinterpret_cast<const float4*>(b1 + col);
    float4 hv = make_float4(c.x + b.x, c.y + b.y, c.z + b.z, c.w + b.w);
    if (h) *reinterpret_cast<float4*>(h + at) = hv;
    float4 gv = make_float4(gelu(hv.x), gelu(hv.y), gelu(hv.z), gelu(hv.w));
    if (keep_q) {
      const uint4 w = philox(at >> 4, seed);
      const uint32_t j = (uint32_t)(at >> 2) & 3u;
      const uint32_t q = j == 0 ? w.x : (j == 1 ? w.y : (j == 2 ? w.z : w.w));
      gv.x *= (q & 0xffu) < keep_q ? inv_keep : 0.f;
      gv.y *= ((q >> 8) & 0xffu) < keep_q ? inv_keep : 0.f;
      gv.z *= ((q >> 16) & 0xffu) < keep_q ? inv_keep : 0.f;
      gv.w *= (q >> 24) < keep_q ? inv_keep : 0.f;
    }
    *reinterpret_cast<float4*>(g + at) = gv;
  }
};

// T threads, block tile 128 x BN, thread tile TM x TN in float4 blocks,
// lanes LY x LX (LY = TM == 8 ? 8 : 4 ...): warp tile WM = LY*TM, WN =
// LX*TN; rows wm0 + ly*4 + i4*LY*4, cols wn0 + lx*4 + j4*LX*4.
template <int T, int BN, int TM, int TN, int LY, int BK, int LOAD, int STAGES,
          int MINB, typename Epi>
__global__ void __launch_bounds__(T, MINB)
    gemm(const float* __restrict__ A, const float* __restrict__ B, int M,
         int N, int K, Epi epi) {
  constexpr int BM = 128, LX = 32 / LY, WM = LY * TM, WN = LX * TN;
  constexpr int WARPS_M = BM / WM;
  static_assert((BM / WM) * (BN / WN) == T / 32, "warps");
  constexpr int LDA = BM + 4, LDB = BN + 4;
  constexpr int S = LOAD == 1 ? 2 : STAGES;
  constexpr int SA = BK * LDA, SB = BK * LDB;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = smem + S * SA;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int rb = (w % WARPS_M) * WM + (l / LX) * 4;
  const int cb = (w / WARPS_M) * WN + (l % LX) * 4;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  auto mma = [&](const float* a, const float* b) {
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i4 = 0; i4 < TM / 4; ++i4) {
        const float4 t = *reinterpret_cast<const float4*>(a + k * LDA + rb + i4 * LY * 4);
        av[4 * i4] = t.x; av[4 * i4 + 1] = t.y; av[4 * i4 + 2] = t.z; av[4 * i4 + 3] = t.w;
      }
#pragma unroll
      for (int j4 = 0; j4 < TN / 4; ++j4) {
        const float4 t = *reinterpret_cast<const float4*>(b + k * LDB + cb + j4 * LX * 4);
        bv[4 * j4] = t.x; bv[4 * j4 + 1] = t.y; bv[4 * j4 + 2] = t.z; bv[4 * j4 + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };
  const int slices = K / BK;
  if (LOAD == 0) {
#pragma unroll
    for (int p = 0; p < S - 1; ++p) {
      if (p < slices) {
        stage4<T, BM, BK>(as + p * SA, A, m0, M, K, p * BK);
        stage4<T, BN, BK>(bs + p * SB, B, n0, N, K, p * BK);
      }
      commit();
    }
    for (int s = 0; s < slices; ++s) {
      wait_g<S - 2>();
      __syncthreads();
      const int nx = s + S - 1;
      if (nx < slices) {
        stage4<T, BM, BK>(as + (nx % S) * SA, A, m0, M, K, nx * BK);
        stage4<T, BN, BK>(bs + (nx % S) * SB, B, n0, N, K, nx * BK);
      }
      commit();
      mma(as + (s % S) * SA, bs + (s % S) * SB);
    }
  } else {
    Regs<T, BM, BK> ra;
    Regs<T, BN, BK> rbg;
    ldg<T, BM, BK>(ra, A, m0, M, K, 0);
    ldg<T, BN, BK>(rbg, B, n0, N, K, 0);
    sts<T, BM, BK>(ra, as);
    sts<T, BN, BK>(rbg, bs);
    __syncthreads();
    for (int s = 0; s < slices; ++s) {
      if (s + 1 < slices) {
        ldg<T, BM, BK>(ra, A, m0, M, K, (s + 1) * BK);
        ldg<T, BN, BK>(rbg, B, n0, N, K, (s + 1) * BK);
      }
      mma(as + (s & 1) * SA, bs + (s & 1) * SB);
      if (s + 1 < slices) {
        sts<T, BM, BK>(ra, as + ((s + 1) & 1) * SA);
        sts<T, BN, BK>(rbg, bs + ((s + 1) & 1) * SB);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + rb + (i & 3) + (i >> 2) * LY * 4;
    if (row >= M) continue;
#pragma unroll
    for (int j4 = 0; j4 < TN / 4; ++j4) {
      const int col = n0 + cb + j4 * LX * 4;
      if (col < N)
        epi(row, col, make_float4(acc[i][4 * j4], acc[i][4 * j4 + 1],
                                  acc[i][4 * j4 + 2], acc[i][4 * j4 + 3]));
    }
  }
}

template <int T, int BN, int TM, int TN, int LY, int BK, int LOAD, int STAGES,
          int MINB, typename Epi>
int run(const float* A, const float* B, int M, int N, int K, Epi epi) {
  const int S = LOAD == 1 ? 2 : STAGES;
  const size_t smem = (size_t)S * BK * (128 + 4 + BN + 4) * sizeof(float);
  auto kern = gemm<T, BN, TM, TN, LY, BK, LOAD, STAGES, MINB, Epi>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((N + BN - 1) / BN, (M + 127) / 128);
  kern<<<grid, T, smem>>>(A, B, M, N, K, epi);
  return (int)cudaGetLastError();
}

template <int T, int BN, int TM, int TN, int LY, int BK, int LOAD, int STAGES,
          int MINB>
int dispatch(int epi_kind, const float* A, const float* B, float* C,
             const float* b1, float* h, int M, int N, int K, int keep_q) {
  if (epi_kind == 0)
    return run<T, BN, TM, TN, LY, BK, LOAD, STAGES, MINB>(A, B, M, N, K,
                                                          StoreEpi{C, N});
  return run<T, BN, TM, TN, LY, BK, LOAD, STAGES, MINB>(
      A, B, M, N, K,
      GeluEpi{b1, C, h, N, 1.f / 0.9f, (uint32_t)keep_q, 1234ull});
}

}  // namespace

// (T, BN, TM, TN, LY, BK, LOAD, STAGES, MINB); two parts, built in
// parallel.
#if PART == 0
#define VARIANTS(X) \
  X(128, 128, 16, 8, 4, 16, 0, 2, 2) \
  X(256, 128, 8, 8, 4, 16, 0, 2, 2) \
  X(256, 128, 8, 8, 4, 8, 1, 2, 2) \
  X(256, 128, 8, 8, 4, 16, 0, 2, 1) \
  X(128, 128, 16, 8, 4, 8, 1, 2, 2)
#else
#define VARIANTS(X) \
  X(128, 128, 16, 8, 4, 16, 0, 3, 2) \
  X(128, 128, 8, 16, 8, 16, 0, 3, 2) \
  X(128, 128, 8, 16, 8, 8, 1, 2, 2) \
  X(256, 256, 8, 16, 8, 8, 0, 3, 1) \
  X(128, 128, 16, 8, 4, 8, 0, 4, 2)
#endif

#define COUNT(...) +1
#define DESC(p1, p2, p3, p4, p5, p6, p7, p8, p9) \
  if (i == n++) { int v[9] = {p1, p2, p3, p4, p5, p6, p7, p8, p9}; for (int q = 0; q < 9; ++q) out[q] = v[q]; return 0; }
#define CALL(p1, p2, p3, p4, p5, p6, p7, p8, p9) \
  if (i == n++) return dispatch<p1, p2, p3, p4, p5, p6, p7, p8, p9>(epi, A, B, C, b1, h, M, N, K, keep_q);

extern "C" int exp_count() { return 0 VARIANTS(COUNT); }
extern "C" int exp_desc(int i, int* out) { int n = 0; VARIANTS(DESC) return -1; }
extern "C" int exp_gemm(int i, int epi, const float* A, const float* B, float* C,
                        const float* b1, float* h, int M, int N, int K,
                        int keep_q) {
  int n = 0;
  VARIANTS(CALL)
  return -1;
}
