// Flash attention backward, bf16, head dim D in {16, 32, 64, 128} (a
// template parameter, as in flash_attention.cu), in two layouts:
//   bnhd [B, N, H, D] (K5): replaces the TPU kernel
//     neurovit_tpu/ops/flash_attention.py:269 (_bwd_kernel_allheads,
//     launched at :420);
//   bhnd [B, H, N, D] (K6's backward): replaces :152 (_bwd_kernel, launched
//     at :420 under the custom VJP at :467-493), the Grad-CAM probe's.
// The layout is a template parameter of both kernels below: it only changes
// where a head's rows are (HeadRows, common.cuh). Per (b, h), with P and the
// dropout mask regenerated from q, k and the seed:
//   p     = exp2(clamp(q.k^T * scale log2 e, +-96)) * (key < n_valid) / l
//   delta = keep * sum_d(dO * O)                 per query row, f32
//   dp_m  = (dO . v^T) * mask
//   ds    = bf16(p * (dp_m - delta) * (scale / keep))
//   dq    = ds . k           dk = ds^T . q        dv = bf16(p * mask)^T . dO / keep
// l is the forward's f32 row sum (K1 or K6 write it when a graph is
// recorded). The TPU kernels hold the whole key row in VMEM and take delta =
// sum(p * dp_m) over it (:297-313, and :207 for bhnd); a GPU block holds 64
// keys, so delta comes from the row's
// output instead: sum_k p_k m_k (dO . v_k) = keep * (dO . O). Both are the
// same sum; this one rounds through the bf16 O, and the plain backward
// (ops/flash_attention.py) uses the same formula.
//
// What bounds it on the H100: 7 N^2 D flops per (b, h) on the tensor cores
// (two more than the minimum: S and dP are recomputed by each kernel) plus
// the exp2 and, in training, one Philox call per 16 mask bytes. Two kernels,
// both deterministic (no atomics):
//   dq_kernel   grid (B*H, ceil(N/64)): a block owns 64 query rows, walks
//               the key tiles, accumulates dQ in wmma fragments; it also
//               writes delta for its rows.
//   dkdv_kernel grid (B*H, ceil(N/64)): a block owns 64 keys (16 per warp),
//               walks every query tile, accumulates dK and dV in fragments.
//               A warp computes S^T and dP^T for its keys so that P^T and
//               dS^T are wmma A operands with no transpose; each lane walks
//               16 contiguous keys of one query row, so the mask bytes are
//               read in Philox order. Key tiles wholly past n_valid write
//               exact zeros.
// Rows past N are zero-filled, get l = 1 and delta = 0, and contribute 0.
// Registers at D = 128: a warp's dK and dV accumulators alone are 128 f32 a
// thread, so there (and for dQ's Q and dO) the A fragments are reloaded
// from shared memory at every use instead of held across the loop. Shared
// memory at D = 128: 177 KiB (dQ) and 187 KiB (dK, dV).
#include "common.cuh"

namespace nvt {
namespace {

constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLDP = 64 + kPad;     // per-warp bf16 staging
constexpr float kScoreCap = 96.f;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int D>
struct BwdPlan {
  static constexpr int kLD = D + kPad;                // bf16 tiles
  static constexpr int kLDS = (64 > D ? 64 : D) + 4;  // per-warp f32 staging
  static constexpr size_t kTile = 64 * kLD * sizeof(bf16);
  static constexpr size_t kWarpF32 = kWarps * 16 * kLDS * sizeof(float);
  static constexpr size_t kWarpBf16 = kWarps * 16 * kLDP * sizeof(bf16);
  // A fragments held in registers across the loop (else reloaded).
  static constexpr bool kHold = D <= 64;
  static constexpr int kHeld = kHold ? D / 16 : 1;
  static constexpr size_t kDqSmem = 2 * kTile + 4 * kTile + 2 * kWarpF32 + kWarpBf16;
  static constexpr size_t kStatBytes = 2 * 2 * kBQ * sizeof(float);  // l, delta x 2
  static constexpr size_t kDkvSmem =
      2 * kTile + 4 * kTile + kStatBytes + 2 * kWarpF32 + 2 * kWarpBf16;
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

__device__ __forceinline__ float prob(float s, float scale_log2e, bool valid,
                                      float l) {
  const float x = fminf(fmaxf(s * scale_log2e, -kScoreCap), kScoreCap);
  return (valid ? exp2f(x) : 0.f) / l;
}

// ---------------------------------------------------------------------------
// dQ (and delta): a block owns 64 query rows, warp w rows 16w .. 16w + 15.
// ---------------------------------------------------------------------------
template <int D, bool kBhnd>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lsum, bf16* __restrict__ dq,
                        float* __restrict__ delta_out, int N, int H,
                        int n_valid, float scale_log2e, float ds_scale,
                        float keep, uint32_t keep_q, uint64_t seed) {
  using P = BwdPlan<D>;
  constexpr int kLD = P::kLD, kLDS = P::kLDS;
  constexpr size_t kTile = P::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + kTile);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * kTile);   // two stages
  bf16* Vs = reinterpret_cast<bf16*>(smem + 4 * kTile);   // two stages
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Sw = reinterpret_cast<float*>(smem + 6 * kTile) + warp * 16 * kLDS;
  float* dPw = reinterpret_cast<float*>(smem + 6 * kTile + P::kWarpF32) +
               warp * 16 * kLDS;
  bf16* dSw = reinterpret_cast<bf16*>(smem + 6 * kTile + 2 * P::kWarpF32) +
              warp * 16 * kLDP;

  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int q0 = blockIdx.y * kBQ;
  const HeadRows<kBhnd> rows(b, h, N, H, D);
  const size_t tok_stride = rows.stride, head_base = rows.base;

  load_tile<D>(Qs, q + head_base, tok_stride, q0, N);
  load_tile<D>(dOs, dout + head_base, tok_stride, q0, N);
  load_tile<D>(Ks, k + head_base, tok_stride, 0, N);
  load_tile<D>(Vs, v + head_base, tok_stride, 0, N);
  cp_async_commit();

  // Lane -> (row, half row) of the warp's 16 x 64 tiles; oc: the half of a
  // D-wide row (O, dO, dQ) the lane takes.
  const int pr = lane >> 1, pc = (lane & 1) * 32, oc = (lane & 1) * (D / 2);
  const int qi = q0 + warp * 16 + pr;
  float l = 1.f, delta = 0.f;
  if (qi < N) {
    l = lsum[static_cast<size_t>(bh) * N + qi];
    const bf16* orow = o + head_base + qi * tok_stride + oc;
    const bf16* drow = dout + head_base + qi * tok_stride + oc;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      float fo[8], fd[8];
      unpack8(*reinterpret_cast<const uint4*>(orow + c), fo);
      unpack8(*reinterpret_cast<const uint4*>(drow + c), fd);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += fd[i] * fo[i];
    }
    delta = s;
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta *= keep;
  if (qi < N && (lane & 1) == 0)
    delta_out[static_cast<size_t>(bh) * N + qi] = delta;
  const uint64_t row_idx =
      (static_cast<uint64_t>(bh) * N + qi) * static_cast<uint64_t>(N);
  DropoutBits bits(seed);

  FragA qf[P::kHeld], dof[P::kHeld];
  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int n_tiles = (n_valid + kBKV - 1) / kBKV;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int st = (t + 1) & 1;
      load_tile<D>(Ks + st * 64 * kLD, k + head_base, tok_stride,
                   (t + 1) * kBKV, N);
      load_tile<D>(Vs + st * 64 * kLD, v + head_base, tok_stride,
                   (t + 1) * kBKV, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (P::kHold) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * kLD + kk * 16, kLD);
          wmma::load_matrix_sync(dof[kk], dOs + warp * 16 * kLD + kk * 16,
                                 kLD);
        }
      }
    }
    const bf16* Kt = Ks + (t & 1) * 64 * kLD;
    const bf16* Vt = Vs + (t & 1) * 64 * kLD;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and 64 keys.
#pragma unroll
    for (int j = 0; j < kBKV / 16; ++j) {
      FragC sf, pf;
      wmma::fill_fragment(sf, 0.f);
      wmma::fill_fragment(pf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBc kf, vf;
        wmma::load_matrix_sync(kf, Kt + j * 16 * kLD + kk * 16, kLD);
        wmma::load_matrix_sync(vf, Vt + j * 16 * kLD + kk * 16, kLD);
        if constexpr (P::kHold) {
          wmma::mma_sync(sf, qf[kk], kf, sf);
          wmma::mma_sync(pf, dof[kk], vf, pf);
        } else {
          FragA qa, da;
          wmma::load_matrix_sync(qa, Qs + warp * 16 * kLD + kk * 16, kLD);
          wmma::load_matrix_sync(da, dOs + warp * 16 * kLD + kk * 16, kLD);
          wmma::mma_sync(sf, qa, kf, sf);
          wmma::mma_sync(pf, da, vf, pf);
        }
      }
      wmma::store_matrix_sync(Sw + j * 16, sf, kLDS, wmma::mem_row_major);
      wmma::store_matrix_sync(dPw + j * 16, pf, kLDS, wmma::mem_row_major);
    }
    __syncwarp();

    const int key0 = t * kBKV + pc;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = prob(Sw[pr * kLDS + pc + c], scale_log2e,
                           key0 + c < n_valid, l);
      float dp = dPw[pr * kLDS + pc + c];
      if (keep_q && !bits.keep(row_idx + key0 + c, keep_q)) dp = 0.f;
      dSw[pr * kLDP + pc + c] = __float2bfloat16(p * (dp - delta) * ds_scale);
    }
    __syncwarp();

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      FragA sa;
      wmma::load_matrix_sync(sa, dSw + kk * 16, kLDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragBr kb;
        wmma::load_matrix_sync(kb, Kt + kk * 16 * kLD + j * 16, kLD);
        wmma::mma_sync(acc[j], sa, kb, acc[j]);
      }
    }
    // Every warp is done with this K/V stage before it is refilled.
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, acc[j], kLDS, wmma::mem_row_major);
  __syncwarp();
  if (qi < N) {
    bf16* row = dq + head_base + qi * tok_stride + oc;
#pragma unroll
    for (int c = 0; c < D / 2; c += 8)
      *reinterpret_cast<uint4*>(row + c) = pack8(Sw + pr * kLDS + oc + c);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: a block owns 64 keys, warp w keys 16w .. 16w + 15.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void load_stats(float* st, const float* lsum,
                                           const float* delta, size_t base,
                                           int q0, int N) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int qi = q0 + r;
    st[r] = qi < N ? lsum[base + qi] : 1.f;
    st[kBQ + r] = qi < N ? delta[base + qi] : 0.f;
  }
}

template <int D, bool kBhnd>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lsum,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int N,
                          int H, int n_valid, float scale_log2e,
                          float ds_scale, float inv_keep, uint32_t keep_q,
                          uint64_t seed) {
  using P = BwdPlan<D>;
  constexpr int kLD = P::kLD, kLDS = P::kLDS;
  constexpr size_t kTile = P::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + kTile);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * kTile);    // two stages
  bf16* dOs = reinterpret_cast<bf16*>(smem + 4 * kTile);   // two stages
  float* stats = reinterpret_cast<float*>(smem + 6 * kTile);  // two stages
  unsigned char* wbase = smem + 6 * kTile + P::kStatBytes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* St = reinterpret_cast<float*>(wbase) + warp * 16 * kLDS;
  float* dPt = reinterpret_cast<float*>(wbase + P::kWarpF32) + warp * 16 * kLDS;
  bf16* Pm = reinterpret_cast<bf16*>(wbase + 2 * P::kWarpF32) + warp * 16 * kLDP;
  bf16* dSt = reinterpret_cast<bf16*>(wbase + 2 * P::kWarpF32 + P::kWarpBf16) +
              warp * 16 * kLDP;

  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int k0 = blockIdx.y * kBKV;
  const HeadRows<kBhnd> rows(b, h, N, H, D);
  const size_t tok_stride = rows.stride, head_base = rows.base;
  const size_t stat_base = static_cast<size_t>(bh) * N;

  if (k0 >= n_valid) {
    // Keys past n_valid have p = 0 in every row: exact zero gradients.
    for (int c = threadIdx.x; c < kBKV * (D / 8); c += kThreads) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      if (k0 + r >= N) continue;
      const size_t off = head_base + (k0 + r) * tok_stride + col;
      *reinterpret_cast<uint4*>(dk + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv + off) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  load_tile<D>(Ks, k + head_base, tok_stride, k0, N);
  load_tile<D>(Vs, v + head_base, tok_stride, k0, N);
  load_tile<D>(Qs, q + head_base, tok_stride, 0, N);
  load_tile<D>(dOs, dout + head_base, tok_stride, 0, N);
  cp_async_commit();
  load_stats(stats, lsum, delta, stat_base, 0, N);

  FragA kf[P::kHeld], vf[P::kHeld];
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  const int my_key0 = k0 + warp * 16;
  DropoutBits bits(seed);
  const int n_qtiles = (N + kBQ - 1) / kBQ;
  for (int t = 0; t < n_qtiles; ++t) {
    if (t + 1 < n_qtiles) {
      const int st = (t + 1) & 1;
      load_tile<D>(Qs + st * 64 * kLD, q + head_base, tok_stride,
                   (t + 1) * kBQ, N);
      load_tile<D>(dOs + st * 64 * kLD, dout + head_base, tok_stride,
                   (t + 1) * kBQ, N);
      cp_async_commit();
      load_stats(stats + st * 2 * kBQ, lsum, delta, stat_base, (t + 1) * kBQ,
                 N);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (P::kHold) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::load_matrix_sync(kf[kk], Ks + warp * 16 * kLD + kk * 16, kLD);
          wmma::load_matrix_sync(vf[kk], Vs + warp * 16 * kLD + kk * 16, kLD);
        }
      }
    }
    const bf16* Qt = Qs + (t & 1) * 64 * kLD;
    const bf16* dOt = dOs + (t & 1) * 64 * kLD;
    const float* lt = stats + (t & 1) * 2 * kBQ;
    const float* dlt = lt + kBQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 query rows.
#pragma unroll
    for (int j = 0; j < kBQ / 16; ++j) {
      FragC sf, pf;
      wmma::fill_fragment(sf, 0.f);
      wmma::fill_fragment(pf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBc qb, db;
        wmma::load_matrix_sync(qb, Qt + j * 16 * kLD + kk * 16, kLD);
        wmma::load_matrix_sync(db, dOt + j * 16 * kLD + kk * 16, kLD);
        if constexpr (P::kHold) {
          wmma::mma_sync(sf, kf[kk], qb, sf);
          wmma::mma_sync(pf, vf[kk], db, pf);
        } else {
          FragA ka, va;
          wmma::load_matrix_sync(ka, Ks + warp * 16 * kLD + kk * 16, kLD);
          wmma::load_matrix_sync(va, Vs + warp * 16 * kLD + kk * 16, kLD);
          wmma::mma_sync(sf, ka, qb, sf);
          wmma::mma_sync(pf, va, db, pf);
        }
      }
      wmma::store_matrix_sync(St + j * 16, sf, kLDS, wmma::mem_row_major);
      wmma::store_matrix_sync(dPt + j * 16, pf, kLDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Lane -> query columns lane and lane + 32, each over the warp's 16
    // contiguous keys (Philox order).
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qc = lane + half * 32;
      const int qi = t * kBQ + qc;
      const float l = lt[qc], dl = dlt[qc];
      const uint64_t row_idx =
          (static_cast<uint64_t>(bh) * N + qi) * static_cast<uint64_t>(N);
#pragma unroll 4
      for (int kk = 0; kk < 16; ++kk) {
        const int key = my_key0 + kk;
        const float p = prob(St[kk * kLDS + qc], scale_log2e, key < n_valid, l);
        float dp = dPt[kk * kLDS + qc];
        float pm = p;
        if (keep_q && !bits.keep(row_idx + key, keep_q)) {
          dp = 0.f;
          pm = 0.f;
        }
        Pm[kk * kLDP + qc] = __float2bfloat16(pm);
        dSt[kk * kLDP + qc] = __float2bfloat16(p * (dp - dl) * ds_scale);
      }
    }
    __syncwarp();

    // dV += (P m)^T dO, dK += dS^T Q.
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      FragA pa, sa;
      wmma::load_matrix_sync(pa, Pm + kk * 16, kLDP);
      wmma::load_matrix_sync(sa, dSt + kk * 16, kLDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragBr db, qb;
        wmma::load_matrix_sync(db, dOt + kk * 16 * kLD + j * 16, kLD);
        wmma::load_matrix_sync(qb, Qt + kk * 16 * kLD + j * 16, kLD);
        wmma::mma_sync(dv_acc[j], pa, db, dv_acc[j]);
        wmma::mma_sync(dk_acc[j], sa, qb, dk_acc[j]);
      }
    }
    // Every warp is done with this Q/dO stage before it is refilled.
    __syncthreads();
  }

  // dK and dV (the latter times 1 / keep once) to bf16, rows past N dropped.
  const int pr = lane >> 1, oc = (lane & 1) * (D / 2);
  const int key = my_key0 + pr;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(St + j * 16, which ? dv_acc[j] : dk_acc[j], kLDS,
                              wmma::mem_row_major);
    __syncwarp();
    if (key < N) {
      bf16* row = (which ? dv : dk) + head_base + key * tok_stride + oc;
      const float mul = which ? inv_keep : 1.f;
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        float f[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = St[pr * kLDS + oc + c + i] * mul;
        *reinterpret_cast<uint4*>(row + c) = pack8(f);
      }
    }
    __syncwarp();
  }
}

template <int D, bool kBhnd>
int launch_bwd_d(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lsum, void* delta, void* dq,
                 void* dk, void* dv, int B, int N, int H, int n_valid,
                 float scale_log2e, float ds_scale, float keep, float inv_keep,
                 int keep_q, uint64_t seed, void* stream) {
  using P = BwdPlan<D>;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, kBhnd>, P::kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(flash_bwd_dkdv_kernel<D, kBhnd>, P::kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, (N + 63) / 64);
  flash_bwd_dq_kernel<D, kBhnd><<<grid, kThreads, P::kDqSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lsum),
      static_cast<bf16*>(dq), static_cast<float*>(delta), N, H, n_valid,
      scale_log2e, ds_scale, keep, static_cast<uint32_t>(keep_q), seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<D, kBhnd><<<grid, kThreads, P::kDkvSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lsum), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, H, n_valid,
      scale_log2e, ds_scale, inv_keep, static_cast<uint32_t>(keep_q), seed);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBhnd>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lsum, void* delta, void* dq,
               void* dk, void* dv, int B, int N, int H, int D, int n_valid,
               float scale_log2e, float ds_scale, float keep, float inv_keep,
               int keep_q, uint64_t seed, void* stream) {
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N || keep_q < 0 ||
      keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
#define NVT_BWD(DD)                                                          \
  return launch_bwd_d<DD, kBhnd>(q, k, v, o, dout, lsum, delta, dq, dk, dv, \
                                 B, N, H, n_valid, scale_log2e, ds_scale,    \
                                 keep, inv_keep, keep_q, seed, stream)
  switch (D) {
    case 16: NVT_BWD(16);
    case 32: NVT_BWD(32);
    case 64: NVT_BWD(64);
    case 128: NVT_BWD(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NVT_BWD
}

}  // namespace
}  // namespace nvt

// K5. q, k, v, o, dout, dq, dk, dv: [B, N, H, D] bf16, contiguous, D in
// {16, 32, 64, 128}; lsum:
// [B, H, N] f32 from the forward; delta: [B, H, N] f32 scratch. keep_q 0 =
// no dropout (keep = inv_keep = 1).
extern "C" int nvt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lsum, void* delta, void* dq, void* dk,
    void* dv, int B, int N, int H, int D, int n_valid, float scale_log2e,
    float ds_scale, float keep, float inv_keep, int keep_q, uint64_t seed,
    void* stream) {
  return nvt::launch_bwd<false>(q, k, v, o, dout, lsum, delta, dq, dk, dv, B,
                                N, H, D, n_valid, scale_log2e, ds_scale, keep,
                                inv_keep, keep_q, seed, stream);
}

// K6's backward: the same with every [.., D] operand in [B, H, N, D].
extern "C" int nvt_flash_attention_bhnd_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lsum, void* delta, void* dq, void* dk,
    void* dv, int B, int N, int H, int D, int n_valid, float scale_log2e,
    float ds_scale, float keep, float inv_keep, int keep_q, uint64_t seed,
    void* stream) {
  return nvt::launch_bwd<true>(q, k, v, o, dout, lsum, delta, dq, dk, dv, B,
                               N, H, D, n_valid, scale_log2e, ds_scale, keep,
                               inv_keep, keep_q, seed, stream);
}
