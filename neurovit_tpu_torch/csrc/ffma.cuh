// The pieces the f32 kernels of the ViT block share on the CUDA cores
// (FFMA): K3's forward GEMM (fused_outproj_f32.cu), and the row passes of
// ffma.cu (the LayerNorm rows K2 and K4 at f32 run first, the row
// statistics of K7 at f32, the dz rows of K8 and K9 at f32).
//
// Why not the tensor cores everywhere: wgmma has no f32 form, and one TF32
// product keeps 10 mantissa bits (about three digits), too few for the JAX
// package's f32 path, whose Pallas kernels sum f32 products and whose plain
// products run at "highest" precision (neurovit_tpu/nn.py:28-32). Three
// TF32 products (a big and a small part of each operand) reach f32
// accuracy at up to 165 TFLOP/s: the attention forward and backward
// (flash_attention_f32.cu, flash_attention_bwd_f32.cu: K1, K5 and K6 at
// f32) take them on mma.sync (tf32x3.cuh), whose fragments the threads
// load in any layout; the other GEMMs of the forwards (K4's fc1 and fc2,
// K2's QKV product) and of the backwards (K8's dattn, K9's hidden GEMM,
// the du GEMM of K7 and K9) take them on wgmma (tf32x3_wgmma.cuh,
// tf32x3_ln_bwd.cuh), which takes TF32 operands K-major only, after a
// pre-pass writes each weight split (W1, W2 and Wqkv as they lie for the
// forwards, turned for the backwards). K3's GEMM, the smallest forward
// one, does not yet (ROADMAP): it is bounded by the card's 67 TFLOP/s of
// f32 FFMA.
//
// gemm_kernel: C[M, N] = A[M, K] . B[N, K]^T for row-major A and B (the
// activations and a torch Linear weight as they lie: K3), K % 16 == 0,
// N % 4 == 0, any M. One block of 256 threads computes a 128 x 128 tile of C:
// eight warps of 32 x 64 (4 x 2), a warp's lanes 4 (rows) x 8 (columns),
// 8 x 8 outputs a thread (rows wm*32 + ly*4 + 16 i4 + i, columns wn*64 +
// lx*4 + 32 j4 + j). A k step reads two 16-byte vectors of A (the four
// lane rows of a warp: 64 bytes, one wavefront) and two of B (the eight
// lane columns: 128 bytes, one wavefront) for 64 FFMA a thread. Each
// 16-deep slice of A and B is staged k-major in shared memory (As[k][m],
// 132 floats a row) by 4-byte cp.async copies: a warp copies four rows'
// 32 contiguous bytes each, into 32 different banks; a thread's eight
// copies are one pointer plus constant steps. Two slices: the copy of
// slice s + 1 runs under the products of slice s, one __syncthreads a
// slice. Rows past M and past N are zero-filled by the copy (src-size 0);
// the epilogue gets float4s of C at (row < M, col < N, col % 4 == 0) and
// does the rest.
//
// Registers bound the design. Two blocks an SM (__launch_bounds__(256,
// 2)) leave a thread 128 registers for 64 accumulators, 16 operands, the
// staging and the epilogue; ptxas takes 115-123 and spills nothing (the
// build log; test_f32_kernels_do_not_spill). The first design (threads
// on a 16 x 16 grid over the tile, two __syncthreads a slice) spilled
// 40-96 bytes in every epilogue at 128. With the warp tiles above but
// each copy's address computed apart, ptxas spilled 84-156 bytes at 128,
// and took 168-195 registers and one block an SM when allowed more.
// Threads of 16 x 8 outputs (128 a block) ran the plain store epilogue up
// to 5 % faster but took 228 registers and lost with the epilogues of
// K4's first design;
// 8-deep slices, three or four in flight, 128 x 256 tiles and loads
// staged through registers were no faster
// (scripts/torch_ffma_tile_sweep.py, PERF.md).
//
// Dropout: element (row, col) of an [M, N] site is kept where byte
// row * N + col of the site's Philox stream is below keep_q (nn.keep_mask,
// common.cuh philox4x32_10); the four elements of a float4 lie in one
// 16-byte Philox block (N % 4 == 0), so one Philox call gives them all.
#pragma once

#include "common.cuh"

namespace nvt {
namespace ffma {

constexpr int kTile = 128;                  // block tile rows and columns
constexpr int kBK = 16;                     // k per staged slice
constexpr int kLd = kTile + 4;              // floats a staged k row
constexpr int kThreads = 256;              // eight warps of 32 x 64
constexpr int kTM = 8, kTN = 8;             // a thread's rows and columns
constexpr int kStages = 2;
constexpr int kRowWarps = 8;                // rows (a warp each) a row block
constexpr size_t kSmemBytes =
    static_cast<size_t>(kStages) * 2 * kBK * kLd * sizeof(float);

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The keep factors (inv_keep or 0) of the four elements i .. i + 3 of a
// site (i % 4 == 0).
__device__ __forceinline__ float4 keep4(uint64_t i, uint64_t seed,
                                        uint32_t keep_q, float inv_keep) {
  const uint4 w = philox4x32_10(i >> 4, seed);
  const uint32_t j = static_cast<uint32_t>(i >> 2) & 3u;
  const uint32_t b = j == 0 ? w.x : (j == 1 ? w.y : (j == 2 ? w.z : w.w));
  return make_float4((b & 0xffu) < keep_q ? inv_keep : 0.f,
                     ((b >> 8) & 0xffu) < keep_q ? inv_keep : 0.f,
                     ((b >> 16) & 0xffu) < keep_q ? inv_keep : 0.f,
                     (b >> 24) < keep_q ? inv_keep : 0.f);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Copy the 16-deep slice k0 of the 128-row tile at row r0 of X [R, K] into
// Xs[k][r] (k-major). Copy c of thread t takes element idx = t + 256 c:
// k = (idx & 7) + 8 (idx >> 10) = t % 8 + 8 (c / 4), r = (idx >> 3) & 127
// = t / 8 + 32 (c % 4). The eight copies are one address plus constant
// row and column steps, so a thread keeps one pointer across the slices.
__device__ __forceinline__ void stage_slice(float* xs, const float* x, int r0,
                                            int rows, int K, int k0) {
  constexpr int kRowStep = kThreads / 8, kRowSteps = kTile / kRowStep;
  static_assert(kBK == 16 && kTile % kRowStep == 0, "two k steps of 8");
  const int r = threadIdx.x >> 3, k = threadIdx.x & 7;
  const float* src = x + static_cast<size_t>(r0 + r) * K + k0 + k;
  const size_t row_step = static_cast<size_t>(kRowStep) * K;
#pragma unroll
  for (int c = 0; c < 2 * kRowSteps; ++c) {
    const int dr = kRowStep * (c % kRowSteps), dk = 8 * (c / kRowSteps);
    const bool valid = r0 + r + dr < rows;
    cp_async4(xs + (k + dk) * kLd + r + dr,
              valid ? src + (c % kRowSteps) * row_step + dk : x, valid);
  }
}

// The products of the 128 x 128 tile of C = A . B^T at (m0, n0), into
// acc, which they zero first. acc[i][j] is C at row rb +
// (i & 3) + 16 (i >> 2), column cb + (j & 3) + 32 (j >> 2), where rb =
// wm*32 + ly*4 and cb = wn*64 + lx*4 for warp (wm, wn) = (w & 3, w >> 2)
// and lane (ly, lx) = (l >> 3, l & 7) (warp_tile_origin). smem: kSmemBytes.
__device__ __forceinline__ int2 warp_tile_origin() {
  constexpr int kWarpsM = kTile / (4 * kTM);
  static_assert(kThreads * kTM * kTN == kTile * kTile, "the tile's outputs");
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  return make_int2((w % kWarpsM) * 4 * kTM + (l >> 3) * 4,
                   (w / kWarpsM) * 8 * kTN + (l & 7) * 4);
}

__device__ __forceinline__ void tile_products(
    const float* __restrict__ A, const float* __restrict__ B, int M, int N,
    int K, int m0, int n0, int rb, int cb, float* smem,
    float (&acc)[kTM][kTN]) {
  constexpr int kSlice = kBK * kLd;
  float* as = smem;
  float* bs = smem + kStages * kSlice;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  // The products of one staged slice, a float4 of A's rows and of B's
  // columns at a time.
  auto slice_products = [&](const float* a, const float* b) {
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i4 = 0; i4 < kTM / 4; ++i4) {
        const float4 v =
            *reinterpret_cast<const float4*>(a + k * kLd + rb + 16 * i4);
        av[4 * i4] = v.x;
        av[4 * i4 + 1] = v.y;
        av[4 * i4 + 2] = v.z;
        av[4 * i4 + 3] = v.w;
      }
#pragma unroll
      for (int j4 = 0; j4 < kTN / 4; ++j4) {
        const float4 v =
            *reinterpret_cast<const float4*>(b + k * kLd + cb + 32 * j4);
        bv[4 * j4] = v.x;
        bv[4 * j4 + 1] = v.y;
        bv[4 * j4 + 2] = v.z;
        bv[4 * j4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };
  const int slices = K / kBK;
  // K >= 16 at every entry point; ptxas allocated fewer registers with the
  // test written out.
  if (slices > 0) {
    stage_slice(as, A, m0, M, K, 0);
    stage_slice(bs, B, n0, N, K, 0);
  }
  cp_async_commit();
  for (int s = 0; s < slices; ++s) {
    // Slice s has landed and every thread is done with slice s - 1, whose
    // buffer takes slice s + 1.
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < slices) {
      stage_slice(as + ((s + 1) & 1) * kSlice, A, m0, M, K, (s + 1) * kBK);
      stage_slice(bs + ((s + 1) & 1) * kSlice, B, n0, N, K, (s + 1) * kBK);
    }
    cp_async_commit();
    slice_products(as + (s & 1) * kSlice, bs + (s & 1) * kSlice);
  }
}

// One block a 128 x 128 tile of C = A . B^T at grid (column tile, row
// tile); epi(row, col, float4) for every float4 of C inside [M, N].
template <typename Epi>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                int M, int N, int K, Epi epi) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int2 o = warp_tile_origin();
  const int rb = o.x, cb = o.y;
  float acc[kTM][kTN];
  tile_products(A, B, M, N, K, m0, n0, rb, cb, smem, acc);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + rb + (i & 3) + 16 * (i >> 2);
    if (row >= M) continue;
#pragma unroll
    for (int j4 = 0; j4 < kTN / 4; ++j4) {
      const int col = n0 + cb + 32 * j4;
      if (col < N)
        epi(row, col, make_float4(acc[i][4 * j4], acc[i][4 * j4 + 1],
                                  acc[i][4 * j4 + 2], acc[i][4 * j4 + 3]));
    }
  }
}

// B [N, K], a torch Linear weight as it lies (K3).
template <typename Epi>
cudaError_t launch_gemm(const float* A, const float* B, int M, int N, int K,
                        const Epi& epi, cudaStream_t stream) {
  cudaError_t err = allow_smem(gemm_kernel<Epi>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  gemm_kernel<Epi><<<grid, kThreads, kSmemBytes, stream>>>(A, B, M, N, K,
                                                           epi);
  return cudaGetLastError();
}

// The epilogue of a GEMM whose output is a residual stream: y = x +
// (C + bias) * keep factors (K3): z = C + b, dropped and scaled
// where keep_q > 0, then x added in f32.
struct ResidualEpi {
  const float* bias;
  const float* x;
  float* y;
  int n;
  float inv_keep;
  uint32_t keep_q;
  uint64_t seed;

  __device__ __forceinline__ void operator()(int row, int col,
                                             float4 c) const {
    const size_t at = static_cast<size_t>(row) * n + col;
    float4 z = add4(c, *reinterpret_cast<const float4*>(bias + col));
    if (keep_q) z = mul4(z, keep4(at, seed, keep_q, inv_keep));
    *reinterpret_cast<float4*>(y + at) =
        add4(z, *reinterpret_cast<const float4*>(x + at));
  }
};

// LayerNorm of x [M, dim] into u, one row a warp (ffma.cu), on the
// caller's stream; dim % 4 == 0.
cudaError_t launch_ln_rows(const float* x, const float* gamma,
                           const float* beta, float* u, int M, int dim,
                           float eps, cudaStream_t stream);

// Each row's (mean, rstd) of x [M, dim] into stats [M], as launch_ln_rows
// computes them (K7's pass 1 at f32, so its xhat has K2 f32's statistics
// bit for bit), one row a warp (ffma.cu); dim % 4 == 0.
cudaError_t launch_row_stats(const float* x, float2* stats, int M, int dim,
                             float eps, cudaStream_t stream);

// K9's pass 1 at f32, and K8's without the LayerNorm (ffma.cu), one row a
// warp: dz = dy * mask / keep for dy, dz [M, dim] (dz null: not written),
// the mask nn.keep_mask's bits at row * dim + col under seed (keep4); with
// x non-null also u = LN(x) * gamma + beta and (mean, rstd) into stats
// [M], as launch_ln_rows computes them (so u is K4 f32's bit for bit).
// dim % 4 == 0.
cudaError_t launch_dz_rows(const float* dy, const float* x,
                           const float* gamma, const float* beta, float* dz,
                           float* u, float2* stats, int M, int dim,
                           float eps, float inv_keep, uint32_t keep_q,
                           uint64_t seed, cudaStream_t stream);

}  // namespace ffma
}  // namespace nvt
