// Attention with the PV product in int8 (K13), [B, N, H, D] layout, bf16,
// head dim D in {16, 32, 64, 128} as K1's (a template parameter; the
// wrapper zero-pads any other D from 8 to 128 to the next of these).
//
// Replaces the TPU kernel neurovit_tpu/ops/int8_serving.py:286
// (_attn_pv_kernel, launched at :356 by int8_flash_attention). Per (b, h):
//   s_v = amax_k |v[k, :]| / 127 over the keys k < n_valid  (per channel)
//   v8 = clamp(rint(v / s_v), +-127)
//   s = q . k^T * (scale * log2 e)            bf16 in, f32 accumulation
//   p = exp2(clamp(s, -96, 96)) * (key < n_valid)
//   denom = sum(p),  s_p = rowmax(p) / 127    from the exact f32 p
//   p8 = clamp(rint(p / s_p), 0, 127)
//   o = bf16(float(p8 . v8) * (s_p / denom * s_v))
// QK^T and the softmax stay exact, as on the TPU: only the probabilities
// and V are quantized.
//
// What bounds it on the H100: like K1, the tensor cores and the exp2 units
// (about 500 operations per byte at N = 1001). The TPU kernel holds a
// whole [block_q, N] row of p, so its row max and row sum are known before
// it quantizes. K1's design walks K/V in 64-key tiles and cannot know them
// until it has seen every key, so this kernel walks the key tiles twice per
// query block: the first sweep computes S and keeps each row's sum and max
// of p; the second recomputes S (the same tensor-core sums, so the same p),
// quantizes p against the now-known row max and accumulates p8 . v8 in
// int32 fragments. The int32 sums are exact, so the numerator is the same
// under any tiling; only denom's summation order differs from the plain
// version. The second QK^T makes it half again K1's tensor-core work.
// V's per-channel scale needs every valid key of (b, h) first, so a
// prologue kernel (one block per (b, h)) writes s_v and the codes v8, zero
// for keys at or past n_valid, transposed and K16-chunked ([key/16][d][16],
// int8.cuh), the layout the PV product's col_major B fragments read.
// Main grid: (B*H, ceil(N/64)) blocks of four warps, each warp 16 query
// rows, as K1's.
#include "int8.cuh"

namespace nvt {
namespace {

constexpr int kBQ = 64;     // query rows per block
constexpr int kBKV = 64;    // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr float kScoreCap = 96.f;

template <int D>
struct Plan {
  static constexpr int kLD = D + kPad;                     // Q/K (bf16)
  static constexpr int kLDS = (kBKV > D ? kBKV : D) + 4;   // S / O staging
  static constexpr size_t kQBytes = kBQ * kLD * sizeof(bf16);
  static constexpr size_t kKBytes = 2 * kBKV * kLD * sizeof(bf16);  // 2 stages
  static constexpr size_t kV8Tile = kBKV * D;                       // bytes
  static constexpr size_t kV8Bytes = 2 * kV8Tile;                   // 2 stages
  static constexpr size_t kSBytes = kWarps * 16 * kLDS * sizeof(float);
  static constexpr size_t kP8Bytes = kWarps * 16 * kBKV;
  static constexpr size_t kSmemBytes =
      kQBytes + kKBytes + kV8Bytes + kSBytes + kP8Bytes;
  // The V prologue: D / 16 threads per key, 16 channels each.
  static constexpr int kKeysPerPass = 256 / (D / 16);
};

// Prologue: s_v [B*H, D] and v8 [B*H, n_pad/16, D, 16] of v [B, N, H, D].
template <int D>
__global__ void __launch_bounds__(256)
    v_quant_kernel(const bf16* __restrict__ v, int8_t* __restrict__ v8,
                   float* __restrict__ s_v, int N, int H, int n_valid,
                   int n_pad) {
  constexpr int kKP = Plan<D>::kKeysPerPass;
  __shared__ float part[kKP][D + 1];
  __shared__ float scale[D];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t tok_stride = static_cast<size_t>(H) * D;
  const bf16* vh = v + (static_cast<size_t>(b) * N * H + h) * D;
  // Thread t: 16 channels (t % (D/16)) * 16 .. + 15 of the keys
  // t / (D/16) + kKP i.
  const int kr = threadIdx.x / (D / 16), d0 = (threadIdx.x % (D / 16)) * 16;
  float m[16] = {};
  for (int key = kr; key < n_valid; key += kKP) {
    float f[16];
    const uint4* src =
        reinterpret_cast<const uint4*>(vh + key * tok_stride + d0);
    unpack8(src[0], f);
    unpack8(src[1], f + 8);
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = fmaxf(m[i], fabsf(f[i]));
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) part[kr][d0 + i] = m[i];
  __syncthreads();
  if (threadIdx.x < D) {
    float amax = 0.f;
    for (int r = 0; r < kKP; ++r) amax = fmaxf(amax, part[r][threadIdx.x]);
    scale[threadIdx.x] = quant_scale(amax);
    s_v[static_cast<size_t>(bh) * D + threadIdx.x] = scale[threadIdx.x];
  }
  __syncthreads();
  int8_t* out = v8 + static_cast<size_t>(bh) * n_pad * D;
  for (int key = kr; key < n_pad; key += kKP) {
    float f[16] = {};
    if (key < n_valid) {
      const uint4* src =
          reinterpret_cast<const uint4*>(vh + key * tok_stride + d0);
      unpack8(src[0], f);
      unpack8(src[1], f + 8);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      out[((key >> 4) * D + d0 + i) * 16 + (key & 15)] = static_cast<int8_t>(
          key < n_valid ? quant_code(f[i], scale[d0 + i], -127.f) : 0);
  }
}

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

// One 64-key tile of v8 (64 * D contiguous bytes).
template <int D>
__device__ __forceinline__ void load_v8(int8_t* dst, const int8_t* src) {
  constexpr int kChunks = static_cast<int>(Plan<D>::kV8Tile / 16);
  for (int c = threadIdx.x; c < kChunks; c += kThreads)
    cp_async16(dst + c * 16, src + c * 16, 16);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    int8_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const int8_t* __restrict__ v8,
                     const float* __restrict__ s_v, bf16* __restrict__ o,
                     int N, int H, int n_valid, int n_pad,
                     float scale_log2e) {
  using P = Plan<D>;
  constexpr int kLD = P::kLD, kLDS = P::kLDS;
  constexpr size_t kV8Tile = P::kV8Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + P::kQBytes);
  int8_t* V8s = reinterpret_cast<int8_t*>(smem + P::kQBytes + P::kKBytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Sw = reinterpret_cast<float*>(smem + P::kQBytes + P::kKBytes +
                                       P::kV8Bytes) +
              warp * 16 * kLDS;
  int8_t* P8w = reinterpret_cast<int8_t*>(smem + P::kQBytes + P::kKBytes +
                                          P::kV8Bytes + P::kSBytes) +
                warp * 16 * kBKV;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBQ;
  const size_t tok_stride = static_cast<size_t>(H) * D;
  const size_t head_base = (static_cast<size_t>(b) * N * H + h) * D;
  const bf16* qh = q + head_base;
  const bf16* kh = k + head_base;
  const int8_t* v8h = v8 + static_cast<size_t>(blockIdx.x) * n_pad * D;

  // Iteration it walks tile it % n_tiles of sweep it / n_tiles: sweep 0
  // reads K, sweep 1 reads K and v8.
  const int n_tiles = (n_valid + kBKV - 1) / kBKV;
  auto prefetch = [&](int it) {
    const int t = it % n_tiles, stage = it & 1;
    load_tile<D>(Ks + stage * kBKV * kLD, kh, tok_stride, t * kBKV, N);
    if (it >= n_tiles) load_v8<D>(V8s + stage * kV8Tile, v8h + t * kV8Tile);
  };
  load_tile<D>(Qs, qh, tok_stride, q0, N);
  prefetch(0);
  cp_async_commit();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      qf[D / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> of[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(of[j], 0);

  // Lane -> (row, half row) of the warp's 16 x 64 score tile.
  const int pr = lane >> 1, pc = (lane & 1) * (kBKV / 2);
  float row_sum = 0.f, row_max = 0.f, s_p = 1.f;

  for (int it = 0; it < 2 * n_tiles; ++it) {
    if (it + 1 < 2 * n_tiles) {
      prefetch(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * kLD + kk * 16, kLD);
    }
    const bool second = it >= n_tiles;
    if (it == n_tiles) {
      // Both lanes of a row now hold its full sum and max.
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      s_p = quant_scale(row_max);
    }
    const int t = it % n_tiles;
    const bf16* Kt = Ks + (it & 1) * kBKV * kLD;

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

    const int key0 = t * kBKV + pc;
    if (!second) {
      // Sweep 0: the row's sum and max of the exact f32 p.
#pragma unroll 8
      for (int c = 0; c < kBKV / 2; ++c) {
        const float s = Sw[pr * kLDS + pc + c] * scale_log2e;
        const float valid = (key0 + c) < n_valid ? 1.f : 0.f;
        const float p = exp2f(fminf(fmaxf(s, -kScoreCap), kScoreCap)) * valid;
        row_sum += p;
        row_max = fmaxf(row_max, p);
      }
    } else {
      // Sweep 1: p8 into the warp's chunked 16 x 64 tile, then O += p8 v8.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int codes[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int col = half * 16 + c;
          const float s = Sw[pr * kLDS + pc + col] * scale_log2e;
          const float valid = (key0 + col) < n_valid ? 1.f : 0.f;
          const float p =
              exp2f(fminf(fmaxf(s, -kScoreCap), kScoreCap)) * valid;
          codes[c] = quant_code(p, s_p, 0.f);
        }
        const uint2 lo = pack_codes(codes), hi = pack_codes(codes + 8);
        *reinterpret_cast<uint4*>(P8w + chunked(pr, pc + half * 16, 16)) =
            make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
      __syncwarp();
      const int8_t* Vt = V8s + (it & 1) * kV8Tile;
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> pf;
        wmma::load_matrix_sync(pf, P8w + kk * 256, 16);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::col_major> vf;
          wmma::load_matrix_sync(vf, Vt + (kk * D + j * 16) * 16, 16);
          wmma::mma_sync(of[j], pf, vf, of[j]);
        }
      }
    }
    // Every warp is done with this stage before it is refilled.
    __syncthreads();
  }

  const int qi = q0 + warp * 16 + pr;
  const float ratio = __fdiv_rn(s_p, row_sum);
  int* Ow = reinterpret_cast<int*>(Sw);
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(Ow + j * 16, of[j], kLDS, wmma::mem_row_major);
  __syncwarp();
  if (qi < N) {
    // Lane pair (2 pr, 2 pr + 1) writes the two halves of row pr.
    const int oc = (lane & 1) * (D / 2);
    const float* sv = s_v + static_cast<size_t>(blockIdx.x) * D;
    bf16* orow = o + head_base + qi * tok_stride;
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = __fmul_rn(__int2float_rn(Ow[pr * kLDS + oc + c + i]),
                         __fmul_rn(ratio, sv[oc + c + i]));
      *reinterpret_cast<uint4*>(orow + oc + c) = pack8(f);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* v8,
           void* s_v, int B, int N, int H, int n_valid, float scale_log2e,
           cudaStream_t s) {
  const int n_pad = (N + kBKV - 1) / kBKV * kBKV;
  v_quant_kernel<D><<<B * H, 256, 0, s>>>(
      static_cast<const bf16*>(v), static_cast<int8_t*>(v8),
      static_cast<float*>(s_v), N, H, n_valid, n_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem = Plan<D>::kSmemBytes;
  err = allow_smem(int8_attn_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (N + kBQ - 1) / kBQ);
  int8_attn_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const int8_t*>(v8), static_cast<const float*>(s_v),
      static_cast<bf16*>(o), N, H, n_valid, n_pad, scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace nvt

// q, k, v, o: [B, N, H, D] bf16, contiguous, D in {16, 32, 64, 128}.
// 1 <= n_valid <= N. v8: [B*H, n_pad, D] int8 scratch and s_v [B*H, D]
// f32, with n_pad = N rounded up to 64.
extern "C" int nvt_int8_attention(const void* q, const void* k, const void* v,
                                  void* o, void* v8, void* s_v, int B, int N,
                                  int H, int D, int n_valid, float scale_log2e,
                                  void* stream) {
  using namespace nvt;
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, v8, s_v, B, N, H, n_valid, scale_log2e, s);
    case 32: return launch<32>(q, k, v, o, v8, s_v, B, N, H, n_valid, scale_log2e, s);
    case 64: return launch<64>(q, k, v, o, v8, s_v, B, N, H, n_valid, scale_log2e, s);
    case 128: return launch<128>(q, k, v, o, v8, s_v, B, N, H, n_valid, scale_log2e, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
