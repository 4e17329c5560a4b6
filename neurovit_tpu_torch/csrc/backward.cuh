// Device code shared by the backward kernels of the row-blocked ops on
// wmma (K7 fused_qkv_bwd.cu, K8 fused_outproj_bwd.cu; K9, fused_mlp_bwd.cu,
// runs on TMA + wgmma with passes of its own and uses none of it).
//
// - dropout_rows: the backward's dz = bf16(dy * mask / keep) for a row
//   block, staged in shared memory as a GEMM A operand (and stored);
// - du_gemm_kernel: du = A . W in f32 for 32-row blocks, A the concatenation
//   along k of up to three [M, part] bf16 tensors, W [K, N] row-major (the
//   torch weight, read with no transpose). A block holds its rows of A in
//   shared memory 2048 columns at a time: at K <= 2048 (the flagship's K7)
//   all of them, and past it (ViT-B's K7 at 3 * 768) chunk by chunk,
//   adding each chunk's f32 product into du;
// - ln_bwd_kernel + colsum_kernel: the LayerNorm backward of a row from x
//   and du, plus the residual dy, and dgamma / dbeta as per-row-block f32
//   partials summed over the blocks in a fixed order (deterministic; the
//   TPU kernels accumulate them serially on an "arbitrary" grid,
//   fused_qkv.py:43-45).
//
// The LayerNorm backward needs whole rows of du (its row means), and a
// [rows, dim] f32 du does not fit beside the resident A block in shared
// memory, so du makes one f32 round trip through device memory: 8 bytes
// per element against the 2*K flops that produced it.
#pragma once

#include "common.cuh"

namespace nvt {
namespace {

template <int BM, int THREADS>
__device__ void dropout_rows(const bf16* __restrict__ dy, bf16* A, int lda,
                             bf16* __restrict__ dz_out, int row0, int M,
                             int dim, float inv_keep, uint32_t keep_q,
                             uint64_t seed) {
  DropoutBits bits(seed);
  for (int c = threadIdx.x; c < BM * (dim / 8); c += THREADS) {
    const int r = c / (dim / 8), col = (c % (dim / 8)) * 8;
    const int row = row0 + r;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (row < M) {
      const size_t off = static_cast<size_t>(row) * dim + col;
      packed = *reinterpret_cast<const uint4*>(dy + off);
      if (keep_q) {
        float f[8];
        unpack8(packed, f);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          f[i] *= bits.keep(off + i, keep_q) ? inv_keep : 0.f;
        packed = pack8(f);
      }
      if (dz_out != nullptr) *reinterpret_cast<uint4*>(dz_out + off) = packed;
    }
    *reinterpret_cast<uint4*>(A + r * lda + col) = packed;
  }
}

constexpr int kDuBM = 32, kDuBN = 128, kDuBK = 32, kDuChunk = 512;
constexpr int kDuMaxK = 2048;   // A columns resident at a time
using DuGemm = TileGemm<kDuBM, kDuBN, kDuBK, 2, 4, true>;

__host__ __device__ inline int du_k_chunk(int K) {
  const int k = static_cast<int>(round_up(K, kDuBK));
  return k < kDuMaxK ? k : kDuMaxK;
}

size_t du_gemm_smem(int K) {
  return round_up(static_cast<size_t>(kDuBM) * (du_k_chunk(K) + kPad) *
                      sizeof(bf16),
                  128) +
         DuGemm::kScratchBytes;
}

// du [M, N] f32 = [a0 | a1 | a2][M, K] . W[K, N]; K = parts * part.
// K, N and part are multiples of 8.
__global__ void __launch_bounds__(DuGemm::kThreads)
    du_gemm_kernel(const bf16* __restrict__ a0, const bf16* __restrict__ a1,
                   const bf16* __restrict__ a2, int part,
                   const bf16* __restrict__ w, float* __restrict__ du, int M,
                   int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kc_max = du_k_chunk(K);
  const int lda = kc_max + kPad;
  bf16* A = reinterpret_cast<bf16*>(smem);
  void* scratch =
      smem + round_up(static_cast<size_t>(kDuBM) * lda * sizeof(bf16), 128);
  const int row0 = blockIdx.x * kDuBM;
  const float* C = reinterpret_cast<const float*>(scratch);
  const int n_begin = blockIdx.y * kDuChunk;
  const int n_end = min(n_begin + kDuChunk, N);
  for (int k0 = 0; k0 < K; k0 += kDuMaxK) {
    const int kc = min(K - k0, kDuMaxK);
    const int kc_pad = static_cast<int>(round_up(kc, kDuBK));
    // The previous chunk's products are done reading A.
    __syncthreads();
    for (int c = threadIdx.x; c < kDuBM * (kc_pad / 8); c += DuGemm::kThreads) {
      const int r = c / (kc_pad / 8), col = (c % (kc_pad / 8)) * 8;
      const int row = row0 + r, k = k0 + col;
      const bool ok = row < M && col < kc;
      const int p = ok ? k / part : 0;
      const bf16* src = (p == 0 ? a0 : (p == 1 ? a1 : a2)) +
                        (ok ? static_cast<size_t>(row) * part + k - p * part
                            : 0);
      cp_async16(A + r * lda + col, src, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();

    for (int n0 = n_begin; n0 < n_end; n0 += kDuBN) {
      DuGemm::run(A, lda, w + static_cast<size_t>(k0) * N, N, n0, kc,
                  scratch, N);
      for (int e = threadIdx.x; e < kDuBM * kDuBN / 4;
           e += DuGemm::kThreads) {
        const int r = e / (kDuBN / 4), c = (e % (kDuBN / 4)) * 4;
        const int row = row0 + r;
        if (row >= M || n0 + c >= N) continue;
        const float* src = C + r * DuGemm::LDC + c;
        float4* dst =
            reinterpret_cast<float4*>(du + static_cast<size_t>(row) * N + n0 + c);
        float4 v = make_float4(src[0], src[1], src[2], src[3]);
        if (k0 > 0) {   // this thread wrote the earlier chunks' sum here
          const float4 prev = *dst;
          v = make_float4(prev.x + v.x, prev.y + v.y, prev.z + v.z,
                          prev.w + v.w);
        }
        *dst = v;
      }
    }
  }
}

// LayerNorm backward of 32-row blocks, one warp per row (neurovit_tpu/ops/
// fused_mlp.py:188-196):
//   xhat = (x - mean) * rstd               the forward's statistics, in f32
//   dxhat = du * gamma
//   dx = bf16(rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) + dy)
//   u = bf16(xhat * gamma + beta)          when u_out is given
// and this block's partial sums of du * xhat and du over its rows.
// A warp holds its row in registers, lane l the columns 256 i + 8 l .. + 7:
// dim % 8 == 0, dim <= 1024. Columns past dim take no part.
constexpr int kLnRows = 32, kLnThreads = 256, kLnMaxVec = 4;

__global__ void __launch_bounds__(kLnThreads)
    ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ du,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, const bf16* __restrict__ dy,
                  bf16* __restrict__ dx, bf16* __restrict__ u_out,
                  float* __restrict__ part_g, float* __restrict__ part_b,
                  int M, int dim, float eps) {
  extern __shared__ float red[];   // [2 * dim]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float ag[kLnMaxVec][8], ab[kLnMaxVec][8];
#pragma unroll
  for (int i = 0; i < kLnMaxVec; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) ag[i][j] = ab[i][j] = 0.f;

  for (int r = warp; r < kLnRows; r += kLnThreads / 32) {
    const int row = blockIdx.x * kLnRows + r;
    if (row >= M) break;
    const size_t base = static_cast<size_t>(row) * dim;
    float xv[kLnMaxVec][8], dv[kLnMaxVec][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kLnMaxVec; ++i) {
      const int col = i * 256 + lane * 8;
      if (col >= dim) break;
      unpack8(*reinterpret_cast<const uint4*>(x + base + col), xv[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += xv[i][j];
      const float4 d0 = *reinterpret_cast<const float4*>(du + base + col);
      const float4 d1 = *reinterpret_cast<const float4*>(du + base + col + 4);
      dv[i][0] = d0.x; dv[i][1] = d0.y; dv[i][2] = d0.z; dv[i][3] = d0.w;
      dv[i][4] = d1.x; dv[i][5] = d1.y; dv[i][6] = d1.z; dv[i][7] = d1.w;
    }
    const float mean = warp_sum(s) / dim;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kLnMaxVec; ++i) {
      if (i * 256 + lane * 8 >= dim) break;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = xv[i][j] - mean;
        ss += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(ss) / dim + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kLnMaxVec; ++i) {
      const int col = i * 256 + lane * 8;
      if (col >= dim) break;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        xv[i][j] = __fmul_rn(xv[i][j] - mean, rstd);        // xhat
        const float dxh = dv[i][j] * gamma[col + j];
        s1 += dxh;
        s2 += dxh * xv[i][j];
        ag[i][j] += dv[i][j] * xv[i][j];
        ab[i][j] += dv[i][j];
      }
    }
    const float m1 = warp_sum(s1) / dim, m2 = warp_sum(s2) / dim;
#pragma unroll
    for (int i = 0; i < kLnMaxVec; ++i) {
      const int col = i * 256 + lane * 8;
      if (col >= dim) break;
      float res[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, out[8];
      if (dy != nullptr)
        unpack8(*reinterpret_cast<const uint4*>(dy + base + col), res);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dxh = dv[i][j] * gamma[col + j];
        out[j] = rstd * (dxh - m1 - xv[i][j] * m2) + res[j];
      }
      *reinterpret_cast<uint4*>(dx + base + col) = pack8(out);
      if (u_out != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          out[j] = __fadd_rn(__fmul_rn(xv[i][j], gamma[col + j]), beta[col + j]);
        *reinterpret_cast<uint4*>(u_out + base + col) = pack8(out);
      }
    }
  }

  // Partials of this row block, warps added in a fixed order.
  for (int c = threadIdx.x; c < 2 * dim; c += kLnThreads) red[c] = 0.f;
  __syncthreads();
  for (int w = 0; w < kLnThreads / 32; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < kLnMaxVec; ++i) {
        if (i * 256 + lane * 8 >= dim) break;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = i * 256 + lane * 8 + j;
          red[col] += ag[i][j];
          red[dim + col] += ab[i][j];
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < dim; c += kLnThreads) {
    part_g[static_cast<size_t>(blockIdx.x) * dim + c] = red[c];
    part_b[static_cast<size_t>(blockIdx.x) * dim + c] = red[dim + c];
  }
}

// out[c] = sum over blocks b = 0, 1, ... of part[b, c], in that order.
__global__ void colsum_kernel(const float* __restrict__ part,
                              float* __restrict__ out, int n_blocks, int dim) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= dim) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += part[static_cast<size_t>(b) * dim + c];
  out[c] = s;
}

int ln_blocks(int M) { return (M + kLnRows - 1) / kLnRows; }

// The LayerNorm backward and the dgamma / dbeta reduction, on `s`.
cudaError_t launch_ln_bwd(const bf16* x, const float* du, const float* gamma,
                          const float* beta, const bf16* dy, bf16* dx,
                          bf16* u_out, float* part_g, float* part_b,
                          float* dgamma, float* dbeta, int M, int dim,
                          float eps, cudaStream_t s) {
  const int blocks = ln_blocks(M);
  ln_bwd_kernel<<<blocks, kLnThreads, 2 * dim * sizeof(float), s>>>(
      x, du, gamma, beta, dy, dx, u_out, part_g, part_b, M, dim, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cgrid = (dim + 255) / 256;
  colsum_kernel<<<cgrid, 256, 0, s>>>(part_g, dgamma, blocks, dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_kernel<<<cgrid, 256, 0, s>>>(part_b, dbeta, blocks, dim);
  return cudaGetLastError();
}

bool ln_dim_ok(int dim) {
  return dim >= 16 && dim % 16 == 0 && dim <= 256 * kLnMaxVec;
}

}  // namespace
}  // namespace nvt
