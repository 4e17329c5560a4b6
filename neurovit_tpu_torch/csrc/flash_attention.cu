// Flash attention forward, bf16, head dim D in {16, 32, 64, 128} (a
// template parameter; the wrapper zero-pads any other D from 8 to 128 to
// the next of these), in two layouts:
//   bnhd [B, N, H, D] (K1): replaces the TPU kernel
//     neurovit_tpu/ops/flash_attention.py:233 (_fwd_kernel_allheads,
//     launched at :381 by flash_attention(layout="bnhd"));
//   bhnd [B, H, N, D] (K6): replaces :91 (_fwd_kernel, launched at :381 by
//     flash_attention(layout="bhnd"), the Grad-CAM probe's attention).
// The layout is a template parameter: it only changes where a head's rows
// are (HeadRows, common.cuh). K6 reads and writes [B, H, N, D] in place.
// Same arithmetic, per (b, h) and query row:
//   s = q . k^T * (scale * log2 e)               f32 accumulation
//   p = exp2(clamp(s, -96, 96)) * (key < n_valid) f32
//   denom = sum(p)                                f32, before dropout
//   p = p * mask                                  training only (:258-262)
//   o = bf16((bf16(p) . v) / (denom * keep))
// The +-96 clamp replaces the row-max subtraction (flash_attention.py:39-45),
// so the key loop only sums: no online-softmax rescaling. The dropout mask
// of element (b, h, q, k) is nvt::DropoutBits at index ((b*H + h)*N + q)*N
// + k: a function of position, so the backward (flash_attention_bwd.cu)
// regenerates it under its own tiling, and K1 and K6 draw the same bits for
// the same (b, h, q, k). When a graph is recorded (training, Grad-CAM) the
// kernel also writes the f32 row sum denom per (b, h, q), the backward's row
// statistic.
//
// What bounds it on the H100: 4*N^2*D flops per (b, h) against 4*N*D*2 bytes,
// about 500 flops a byte at N = 1001, so the tensor cores and the exp2 units,
// not HBM. The TPU kernel keeps K and V for the whole sequence resident
// (2 x 128 KB at N = 1001 -- more than one block's shared memory here), so
// this kernel walks K/V in 64-key tiles through a two-stage cp.async ring
// inside the block instead. The grid is (B*H, ceil(N/64)) blocks of four
// warps; each warp owns 16 query rows, keeps its Q fragments in registers,
// and accumulates O over the key tiles in wmma f32 fragments. S goes
// through a per-warp shared tile because wmma fragments have no defined
// element layout. Keys past N are zero-filled and masked like keys past
// n_valid; tiles wholly past n_valid are skipped (their p is exactly 0).
#include "common.cuh"

namespace nvt {
namespace {

constexpr int kBQ = 64;     // query rows per block
constexpr int kBKV = 64;    // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLDP = kBKV + kPad;    // P tile leading dim (bf16)
constexpr float kScoreCap = 96.f;

// Shared-memory plan of head dim D: Q, two K/V stages, per-warp S (also
// the O staging, so max(64, D) wide) and P tiles: 127 KiB at D = 128.
template <int D>
struct FwdPlan {
  static constexpr int kLD = D + kPad;                     // Q/K/V (bf16)
  static constexpr int kLDS = (kBKV > D ? kBKV : D) + 4;   // S / O (f32)
  static constexpr size_t kQBytes = kBQ * kLD * sizeof(bf16);
  static constexpr size_t kKVBytes = 2 * kBKV * kLD * sizeof(bf16);
  static constexpr size_t kSBytes = kWarps * 16 * kLDS * sizeof(float);
  static constexpr size_t kPBytes = kWarps * 16 * kLDP * sizeof(bf16);
  static constexpr size_t kSmemBytes = kQBytes + 2 * kKVBytes + kSBytes + kPBytes;
};

// rows [t0, t0 + 64) of one head: 64 rows x D, zero past N.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t tok_stride, int t0, int N) {
  constexpr int kLD = D + kPad;
  for (int c = threadIdx.x; c < 64 * (D / 8); c += kThreads) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const int t = t0 + r;
    const int safe_t = t < N ? t : N - 1;
    cp_async16(dst + r * kLD + col, src + safe_t * tok_stride + col,
               t < N ? 16 : 0);
  }
}

template <int D, bool kBhnd>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int N,
                     int H, int n_valid, float scale_log2e, float keep,
                     uint32_t keep_q, uint64_t seed, float* __restrict__ lsum) {
  using P = FwdPlan<D>;
  constexpr int kLD = P::kLD, kLDS = P::kLDS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + P::kQBytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + P::kQBytes + P::kKVBytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Sw = reinterpret_cast<float*>(smem + P::kQBytes + 2 * P::kKVBytes) +
              warp * 16 * kLDS;
  bf16* Pw = reinterpret_cast<bf16*>(smem + P::kQBytes + 2 * P::kKVBytes +
                                     P::kSBytes) +
             warp * 16 * kLDP;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBQ;
  const HeadRows<kBhnd> rows(b, h, N, H, D);
  const size_t tok_stride = rows.stride, head_base = rows.base;
  const bf16* qh = q + head_base;
  const bf16* kh = k + head_base;
  const bf16* vh = v + head_base;

  load_tile<D>(Qs, qh, tok_stride, q0, N);
  load_tile<D>(Ks, kh, tok_stride, 0, N);
  load_tile<D>(Vs, vh, tok_stride, 0, N);
  cp_async_commit();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      qf[D / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(of[j], 0.f);

  // Lane -> (row, half row) of the warp's 16 x 64 score tile.
  const int pr = lane >> 1, pc = (lane & 1) * (kBKV / 2);
  float row_sum = 0.f;
  const int qi = q0 + warp * 16 + pr;
  // Dropout index of (b, h, qi, key 0); keep_q == 0 means no dropout.
  const uint64_t row_idx =
      (static_cast<uint64_t>(blockIdx.x) * N + qi) * static_cast<uint64_t>(N);
  DropoutBits bits(seed);

  const int n_tiles = (n_valid + kBKV - 1) / kBKV;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int s = (t + 1) & 1;
      load_tile<D>(Ks + s * kBKV * kLD, kh, tok_stride, (t + 1) * kBKV, N);
      load_tile<D>(Vs + s * kBKV * kLD, vh, tok_stride, (t + 1) * kBKV, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * kLD + kk * 16, kLD);
    }
    const bf16* Kt = Ks + (t & 1) * kBKV * kLD;
    const bf16* Vt = Vs + (t & 1) * kBKV * kLD;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
#pragma unroll
    for (int j = 0; j < kBKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Kt + j * 16 * kLD + kk * 16, kLD);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(Sw + j * 16, sf, kLDS, wmma::mem_row_major);
    }
    __syncwarp();

    // p = exp2(clamp(s)) * mask; the denominator sums the f32 p, the
    // numerator takes bf16(p).
    const int key0 = t * kBKV + pc;
#pragma unroll 8
    for (int c = 0; c < kBKV / 2; ++c) {
      const float s = Sw[pr * kLDS + pc + c] * scale_log2e;
      const float valid = (key0 + c) < n_valid ? 1.f : 0.f;
      float p = exp2f(fminf(fmaxf(s, -kScoreCap), kScoreCap)) * valid;
      row_sum += p;
      if (keep_q && !bits.keep(row_idx + key0 + c, keep_q)) p = 0.f;
      Pw[pr * kLDP + pc + c] = __float2bfloat16(p);
    }
    __syncwarp();

    // O += P V
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, Pw + kk * 16, kLDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vt + kk * 16 * kLD + j * 16, kLD);
        wmma::mma_sync(of[j], pf, vf, of[j]);
      }
    }
    // Every warp is done with this K/V stage before it is refilled.
    __syncthreads();
  }

  row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
  if (lsum != nullptr && qi < N && (lane & 1) == 0)
    lsum[static_cast<size_t>(blockIdx.x) * N + qi] = row_sum;
  const float denom = row_sum * keep;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, of[j], kLDS, wmma::mem_row_major);
  __syncwarp();
  if (qi < N) {
    // Lane pair (2 pr, 2 pr + 1) writes the two halves of row pr.
    const int oc = (lane & 1) * (D / 2);
    bf16* orow = o + head_base + qi * tok_stride;
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = Sw[pr * kLDS + oc + c + i] / denom;
      *reinterpret_cast<uint4*>(orow + oc + c) = pack8(f);
    }
  }
}

template <int D, bool kBhnd>
int launch_fwd_d(const void* q, const void* k, const void* v, void* o, int B,
                 int N, int H, int n_valid, float scale_log2e, float keep,
                 int keep_q, uint64_t seed, void* lsum, void* stream) {
  constexpr size_t smem = FwdPlan<D>::kSmemBytes;
  cudaError_t err = allow_smem(flash_fwd_kernel<D, kBhnd>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (N + kBQ - 1) / kBQ);
  flash_fwd_kernel<D, kBhnd><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), N, H, n_valid,
      scale_log2e, keep, static_cast<uint32_t>(keep_q), seed,
      static_cast<float*>(lsum));
  return static_cast<int>(cudaGetLastError());
}

template <bool kBhnd>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B,
               int N, int H, int D, int n_valid, float scale_log2e,
               float keep, int keep_q, uint64_t seed, void* lsum,
               void* stream) {
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N || keep_q < 0 ||
      keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16:
      return launch_fwd_d<16, kBhnd>(q, k, v, o, B, N, H, n_valid, scale_log2e,
                                     keep, keep_q, seed, lsum, stream);
    case 32:
      return launch_fwd_d<32, kBhnd>(q, k, v, o, B, N, H, n_valid, scale_log2e,
                                     keep, keep_q, seed, lsum, stream);
    case 64:
      return launch_fwd_d<64, kBhnd>(q, k, v, o, B, N, H, n_valid, scale_log2e,
                                     keep, keep_q, seed, lsum, stream);
    case 128:
      return launch_fwd_d<128, kBhnd>(q, k, v, o, B, N, H, n_valid,
                                      scale_log2e, keep, keep_q, seed, lsum,
                                      stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace nvt

// K1. q, k, v, o: [B, N, H, D] bf16, contiguous, D in {16, 32, 64, 128}.
// 1 <= n_valid <= N.
// keep_q: dropout threshold q of keep = q / 256, 0 for no dropout (then
// keep = 1). lsum: [B, H, N] f32 row sums, or null (serving).
extern "C" int nvt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int B, int N,
                                       int H, int D, int n_valid,
                                       float scale_log2e, float keep,
                                       int keep_q, uint64_t seed, void* lsum,
                                       void* stream) {
  return nvt::launch_fwd<false>(q, k, v, o, B, N, H, D, n_valid, scale_log2e,
                                keep, keep_q, seed, lsum, stream);
}

// K6: the same with q, k, v, o in [B, H, N, D].
extern "C" int nvt_flash_attention_bhnd_fwd(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int N, int H, int D, int n_valid,
                                            float scale_log2e, float keep,
                                            int keep_q, uint64_t seed,
                                            void* lsum, void* stream) {
  return nvt::launch_fwd<true>(q, k, v, o, B, N, H, D, n_valid, scale_log2e,
                               keep, keep_q, seed, lsum, stream);
}

extern "C" const char* nvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
