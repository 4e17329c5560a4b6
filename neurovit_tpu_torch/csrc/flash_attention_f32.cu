// Flash attention forward at f32 on the CUDA cores, in two layouts:
//   bnhd [B, N, H, D] (K1): replaces the TPU kernel
//     neurovit_tpu/ops/flash_attention.py:233 (_fwd_kernel_allheads,
//     launched at :381 by flash_attention);
//   bhnd [B, H, N, D] (K6): replaces :91 (_fwd_kernel, launched at :381 by
//     flash_attention(layout="bhnd"), the Grad-CAM probe's attention).
// Both are instances of one kernel, templated on the layout (common.cuh
// HeadRows), as the bf16 K1 and K6 are. On f32 operands p.astype(v.dtype)
// is a no-op, so P is not rounded:
//   s = q . k^T * scale * log2(e)                 f32
//   p = exp2(clip(s, -96, 96)), 0 for keys >= n_valid
//   l = sum_k p                                   the denominator
//   o = (p * mask) . v / (l * keep)               mask: training only
// The clamp at +-96 (flash_attention.py:39-45) stands in for the row max,
// so nothing is rescaled as the key tiles go by. The dropout mask of
// element (b, h, q, k) is nn.keep_mask's bit at ((b H + h) N + q) N + k,
// the bits the bf16 kernel (flash_attention.cu) and the plain version
// draw, in either layout. With lsum, l goes out as the [B, H, N] row sums
// the backward reads.
//
// What bounds it on the H100: its 4 B H N n_valid D flops, here on the
// CUDA cores (ffma.cuh says why not yet in 3xTF32): 16.4 GFLOP for the
// flagship block at batch 8 (B H = 64, N = n_valid = 1001, D = 64), 0.25 ms
// at 67 TFLOP/s, far above its 66 MB of q, k, v and o.
//
// The design: one block of 128 threads a 64-row query tile of one (b, h),
// on a one-dimensional grid of (query tiles x B H), query tiles fastest so
// a head's K and V stay in L2. The block walks the key tiles of 32 keys
// below n_valid (tiles past it are skipped, and the ragged stream of 1001
// tokens is not padded), K and V staged by 16-byte cp.async copies, two
// tiles in flight. A thread holds 4 rows x 4 keys of S and 4 rows x D / 8
// columns of O (columns tx*4 + 32 c): S from Q and K rows read as 16-byte
// vectors along D, P through shared memory (each thread's p of its 4 rows
// and keys), then O += P . V over the tile, reading P rows and V rows as
// vectors. Q, K and P rows are stored with their 16-byte chunks permuted
// (chunk c of row r at c ^ ((r / 4) % 8)), so the rows a warp reads at one
// chunk fall into different banks. Query rows past N and keys past N are
// zero-filled by the copies; rows past N are not stored. Head dims are
// instances at 32, 64 and 128 (ops/flash_attention.py pads the others).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's f32 phase,
// medians of 25 one-call CUDA-event timings at batch 8): 0.6546 ms, 25.1
// TFLOP/s, 2.7x the FFMA floor; f32 SDPA 0.5671 ms. 128 registers a thread
// at D = 64, 168 at D = 128, no spills (the build log).
#include "flash_f32.cuh"

namespace nvt {
namespace {

using flash_f32::kCap;
using flash_f32::kThreads;
using flash_f32::stage_rows;
using flash_f32::swz;

constexpr int kBQ = 64, kBKV = 32;

template <int D>
struct Layout {
  static constexpr int kQ = kBQ * D;     // floats of the Q tile
  static constexpr int kKV = kBKV * D;   // floats of a K or V tile
  static constexpr int kP = kBQ * kBKV;  // floats of the P tile
  static constexpr size_t kBytes =
      static_cast<size_t>(kQ + 4 * kKV + kP) * sizeof(float);
};

template <int D, bool kBhnd>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lsum, int N, int H,
                         int q_tiles, int n_valid, float scale_log2,
                         float keep, uint32_t keep_q, uint64_t seed) {
  using L = Layout<D>;
  constexpr int kCols = D / 32;  // float4 columns of O a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + L::kQ;        // two stages
  float* vs = ks + 2 * L::kKV;   // two stages
  float* ps = vs + 2 * L::kKV;

  const int qt = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const HeadRows<kBhnd> hr(bh / H, bh % H, N, H, D);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int n_tiles = (n_valid + kBKV - 1) / kBKV;

  stage_rows<D, kBQ, true>(qs, q, hr, q0, N);
  stage_rows<D, kBKV, true>(ks, k, hr, 0, N);
  stage_rows<D, kBKV, false>(vs, v, hr, 0, N);
  ffma::cp_async_commit();

  float4 acc[4][kCols];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      stage_rows<D, kBKV, true>(ks + (st ^ 1) * L::kKV, k, hr,
                                (kt + 1) * kBKV, N);
      stage_rows<D, kBKV, false>(vs + (st ^ 1) * L::kKV, v, hr,
                                 (kt + 1) * kBKV, N);
      ffma::cp_async_commit();
      ffma::cp_async_wait<1>();
    } else {
      ffma::cp_async_wait<0>();
    }
    __syncthreads();

    // S: rows ty*4 + i, keys tx*4 + j of the tile.
    const float* kst = ks + st * L::kKV;
    float s[4][4];
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
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // p, the row sums, the mask; P to shared memory.
    const int key0 = kt * kBKV + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = exp2f(fminf(fmaxf(s[i][j] * scale_log2, -kCap), kCap));
        p[j] = key0 + j < n_valid ? e : 0.f;
        l[i] += p[j];
      }
      if (keep_q) {
        const uint32_t kept = flash_f32::keep_bits4(
            (static_cast<uint64_t>(bh) * N + q0 + ty * 4 + i) * N + key0,
            seed, keep_q);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!((kept >> j) & 1u)) p[j] = 0.f;
      }
      *reinterpret_cast<float4*>(ps + swz(ty * 4 + i, tx, kBKV)) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // O += P . V over the tile's keys.
    const float* vst = vs + st * L::kKV;
#pragma unroll 2
    for (int c = 0; c < kBKV / 4; ++c) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + swz(ty * 4 + i, c, kBKV));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vst + (c * 4 + kk) * D + tx * 4 + 32 * cc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pk = kk == 0 ? pv[i].x
                             : kk == 1 ? pv[i].y
                             : kk == 2 ? pv[i].z
                                       : pv[i].w;
            acc[i][cc].x = fmaf(pk, vv.x, acc[i][cc].x);
            acc[i][cc].y = fmaf(pk, vv.y, acc[i][cc].y);
            acc[i][cc].z = fmaf(pk, vv.z, acc[i][cc].z);
            acc[i][cc].w = fmaf(pk, vv.w, acc[i][cc].w);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int row = q0 + ty * 4 + i;
    if (row >= N) continue;
    const float den = li * keep;
    float* out = o + hr.base + static_cast<size_t>(row) * hr.stride + tx * 4;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      *reinterpret_cast<float4*>(out + 32 * cc) =
          make_float4(acc[i][cc].x / den, acc[i][cc].y / den,
                      acc[i][cc].z / den, acc[i][cc].w / den);
    if (lsum != nullptr && tx == 0)
      lsum[static_cast<size_t>(bh) * N + row] = li;
  }
}

template <int D, bool kBhnd>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lsum, int B, int N, int H, int n_valid,
                   float scale_log2, float keep, uint32_t keep_q,
                   uint64_t seed, cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  const auto kernel = flash_fwd_f32_kernel<D, kBhnd>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (N + kBQ - 1) / kBQ;
  kernel<<<static_cast<unsigned>(q_tiles) * B * H, kThreads, smem, stream>>>(
      q, k, v, o, lsum, N, H, q_tiles, n_valid, scale_log2, keep, keep_q,
      seed);
  return cudaGetLastError();
}

template <bool kBhnd>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B,
               int N, int H, int D, int n_valid, float scale_log2, float keep,
               int keep_q, uint64_t seed, void* lsum, void* stream) {
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N || keep_q < 0 ||
      keep_q > 255 ||
      static_cast<long long>((N + kBQ - 1) / kBQ) * B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lsum);
  const uint32_t kq = static_cast<uint32_t>(keep_q);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch<32, kBhnd>(qf, kf, vf, of, lf, B, N, H, n_valid,
                              scale_log2, keep, kq, seed, s);
      break;
    case 64:
      err = launch<64, kBhnd>(qf, kf, vf, of, lf, B, N, H, n_valid,
                              scale_log2, keep, kq, seed, s);
      break;
    case 128:
      err = launch<128, kBhnd>(qf, kf, vf, of, lf, B, N, H, n_valid,
                               scale_log2, keep, kq, seed, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace nvt

// K1 at f32. q, k, v, o [B, N, H, D] f32, D in {32, 64, 128} (the wrapper
// zero-pads other head dims); lsum [B, H, N] f32 or null. keep = q / 256
// (1 without dropout), keep_q the dropout threshold (0 = none).
extern "C" int nvt_flash_attention_f32_fwd(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int N, int H, int D, int n_valid,
                                           float scale_log2, float keep,
                                           int keep_q, uint64_t seed,
                                           void* lsum, void* stream) {
  return nvt::launch_fwd<false>(q, k, v, o, B, N, H, D, n_valid, scale_log2,
                                keep, keep_q, seed, lsum, stream);
}

// K6 at f32: the same with q, k, v, o in [B, H, N, D].
extern "C" int nvt_flash_attention_bhnd_f32_fwd(const void* q, const void* k,
                                                const void* v, void* o, int B,
                                                int N, int H, int D,
                                                int n_valid, float scale_log2,
                                                float keep, int keep_q,
                                                uint64_t seed, void* lsum,
                                                void* stream) {
  return nvt::launch_fwd<true>(q, k, v, o, B, N, H, D, n_valid, scale_log2,
                               keep, keep_q, seed, lsum, stream);
}

// Dynamic shared memory of a block of the instance at head dim D, either
// layout (ops/flash_attention.py flash_f32_plan), or -1.
extern "C" long long nvt_flash_attention_f32_smem_bytes(int D) {
  using namespace nvt;
  switch (D) {
    case 32: return static_cast<long long>(Layout<32>::kBytes);
    case 64: return static_cast<long long>(Layout<64>::kBytes);
    case 128: return static_cast<long long>(Layout<128>::kBytes);
    default: return -1;
  }
}
