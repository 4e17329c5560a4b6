// Fused residual MLP block (K4), bf16, deterministic, on TMA + wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_mlp.py:108 (_fwd_kernel,
// launched at :213 by fused_mlp_block):
//   u = bf16(LN(x) * gamma + beta)
//   h = bf16(u . W1^T + b1)              rounded before GELU (fused_mlp.py:120-124)
//   g = bf16(GELU(h) * mask1 / keep)     exact-erf GELU in f32, CUDA erff
//   z = (g . W2^T + b2) * mask2 / keep   f32
//   y = bf16(x + z)                      x added in f32, one rounding
// The masks (training only, fused_mlp.py:125-133) are nn.keep_mask's bits
// of two sites: mask1 at row * hid + j of the hidden, mask2 at row * dim +
// c of the output. In training h is also stored (h [M, hid] bf16), the tensor
// the backward (fused_mlp_bwd.cu) reads; serving passes null. W1 [hid, dim]
// and W2 [dim, hid] are torch Linear weights: both are K-major for their
// GEMM as they lie, so wgmma reads them with no transpose.
//
// What bounds it on the H100: 4 M dim hid flops on the tensor cores (0.068
// ms at 989 TFLOP/s for the flagship block at batch 8: M = 8008, dim 1024,
// hid 2048). The TPU kernel keeps the [rows, hid] hidden in VMEM. The
// earlier wmma kernel kept a block's u and g (32 or 16 rows) in shared
// memory and read all of W1 and W2 again for every such block; a block
// that feeds wgmma from a TMA ring has no room for them. Here u and g go
// through device memory as bf16 (with x read twice, y and the weights,
// about 160 MB at that shape: 0.047 ms at 3.35 TB/s), in three launches
// on the caller's stream:
//   1. ln_rows: x -> u [M, dim], one warp a row (fused_mlp.cuh ln_row);
//      the row is read again from L1/L2 for each statistic, so any dim is
//      taken. K2 (fused_qkv.cu) launches the same pass (launch_ln_rows).
//   2. fc1_gelu: hopper_gemm.cuh Mainloop<false, 128, BN, 3> over
//      ceil(hid / BN) x ceil(M / 128) tiles, A = u, Bt = W1. The epilogue,
//      from the accumulator registers: + b1, h rounded, GELU, mask1, g
//      rounded; h (when stored) and g go to the ring and out by TMA.
//   3. fc2_residual: the same mainloop over ceil(dim / BN) x ceil(M / 128)
//      tiles, A = g, Bt = W2; the epilogue adds b2, applies mask2, adds x
//      in f32 and rounds y once, stored as bf16 pairs from registers. K3
//      (fused_outproj.cu) launches the same pass (launch_fc2_residual).
// Three stages (97 KiB of ring at BN = 128) let two GEMM blocks share an
// SM, so one block's epilogue runs under the other's mainloop. BN is 128,
// or 64 where 128-wide tiles would give the card fewer blocks than its 132
// SMs (fc1 and fc2 at one volume). TMA zero-fills the boxes past M, dim and
// hid on loads and clips them on stores, so ragged edges need no masks but
// the epilogue's column bound. Widths are multiples of 16 (TMA's 16-byte
// rows) of any size.
//
// fc1's stores: once both consumer warpgroups are done with the ring, each
// thread writes its bf16 pairs of g and h into it as the maps' 64-column
// boxes (128-byte swizzle: no bank conflicts), and one thread stores the
// boxes by TMA. Stores of the pairs straight from registers (4 bytes a
// thread, 16 contiguous bytes a quad) took fc1 98.3 us at batch 8, 137.2
// with h, against 90.0 and 104.9 staged; fc2's y staged so gained 2 us
// serving and lost 3 with dropout, and stays in registers (PERF.md,
// section 6; times on an H100 80GB HBM3 at 700 W).
//
// Dropout in the wgmma layout: a thread holds columns 8 j + 2 (t % 4) and
// + 1 of rows r0 and r0 + 8 (hopper_gemm.cuh, Wgmma), so its 32 elements of
// a row touch all eight 16-byte Philox blocks of the row's 128-column tile
// (a row starts on a block edge: hid and dim are multiples of 16). Thread o
// of the quad draws blocks 2 o and 2 o + 1 and turns their 32 bytes into 32
// keep bits; one shuffle from each of the four threads hands every thread
// the bits of its positions (QuadKeep). Two Philox calls a thread a row,
// each block drawn once; the bits are nn.keep_mask's
// (tests/test_torch_mlp_plan.py models the exchange).
//
// GELU uses CUDA's erff, not the TPU kernel's Abramowitz-Stegun polynomial
// (fused_mlp.py:65-79); both are within 1.5e-7 of erf, below bf16
// resolution.
#include "fused_mlp.cuh"

namespace nvt {
namespace {

using namespace mlp;

// Scratch of one call, one allocation: u [M, dim], then g [M, hid], both
// bf16, each on a 256-byte boundary.
struct Scratch {
  size_t u, g, bytes;
  Scratch(int M, int dim, int hid) {
    const size_t m = static_cast<size_t>(M);
    u = 0;
    g = round_up(m * dim * sizeof(bf16), 256);
    bytes = round_up(g + m * hid * sizeof(bf16), 256);
  }
};

// Pass 1: u = bf16(LN(x) * gamma + beta), one warp a row (ln_row).
__global__ void __launch_bounds__(kRowWarps * 32)
    ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, bf16* __restrict__ u,
                   int M, int dim, float eps) {
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= M) return;
  const size_t off = static_cast<size_t>(row) * dim;
  ln_row(x + off, gamma, beta, u + off, dim, eps);
}

// K9's pass 1 (fused_mlp_bwd.cu), and K8's without the LayerNorm
// (fused_outproj_bwd.cu): dz = bf16(dy * mask / keep), one warp a row;
// with kLn also u and the row's statistics as ln_rows writes them.
template <bool kLn>
__global__ void __launch_bounds__(kRowWarps * 32)
    dz_rows_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, bf16* __restrict__ dz,
                   bf16* __restrict__ u, float2* __restrict__ stats, int M,
                   int dim, float eps, float inv_keep, uint32_t keep_q,
                   uint64_t seed) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= M) return;
  const size_t off = static_cast<size_t>(row) * dim;
  if constexpr (kLn) {
    const float2 st = ln_row(x + off, gamma, beta, u + off, dim, eps);
    if (lane == 0) stats[row] = st;
  }
  // off + c is a multiple of 16 (dim is): the 16 columns are byte e of
  // Philox block (off + c) / 16, nn.keep_mask's bits.
  for (int c = lane * 16; c < dim; c += 512) {
    uint4 v[2] = {*reinterpret_cast<const uint4*>(dy + off + c),
                  *reinterpret_cast<const uint4*>(dy + off + c + 8)};
    if (keep_q) {
      const uint4 w = philox4x32_10((off + c) >> 4, seed);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float f[8];
        unpack8(v[half], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = 8 * half + i;
          const uint32_t byte = (ws[e / 4] >> (8 * (e % 4))) & 0xFFu;
          f[i] *= byte < keep_q ? inv_keep : 0.f;
        }
        v[half] = pack8(f);
      }
    }
    *reinterpret_cast<uint4*>(dz + off + c) = v[0];
    *reinterpret_cast<uint4*>(dz + off + c + 8) = v[1];
  }
}

// Pass 2: h = bf16(u . W1^T + b1) (stored when store_h), g = bf16(GELU(h)
// * mask1 / keep).
template <int BN>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
    fc1_gelu_kernel(const __grid_constant__ CUtensorMap tu,
                    const __grid_constant__ CUtensorMap tw1,
                    const __grid_constant__ CUtensorMap tg,
                    const __grid_constant__ CUtensorMap th,
                    const float* __restrict__ b1, bool store_h, int M,
                    int dim, int hid, float inv_keep, uint32_t keep_q,
                    uint64_t seed1) {
  extern __shared__ unsigned char smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  float acc[Loop<BN>::kAccRegs];
  if (!Loop<BN>::run(&tu, &tw1, m0, n0, dim, smem, acc)) return;
  const Place at;
  unsigned char* gs = reinterpret_cast<unsigned char*>(
      round_up(reinterpret_cast<size_t>(smem), 1024));   // the ring
  unsigned char* hs = gs + kBM * BN * sizeof(bf16);
  hopper::named_barrier(1, kConsumerThreads);   // no wgmma reads it now
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = at.r0 + 8 * half;
    // Every thread of the warp takes part in the quads' shuffles; rows
    // past M are computed too and clipped by the store.
    QuadKeep bits;
    if (keep_q)
      bits.draw((static_cast<uint64_t>(m0 + r) * hid + n0) >> 4, at.quad,
                keep_q, seed1);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * at.quad;
      if (col >= hid) continue;   // hid is even: col + 1 < hid too
      const float2 bc = *reinterpret_cast<const float2*>(b1 + col);
      const __nv_bfloat162 hv = __floats2bfloat162_rn(
          __fadd_rn(acc[4 * j + 2 * half], bc.x),
          __fadd_rn(acc[4 * j + 2 * half + 1], bc.y));
      const int where = staged_at(r, j, at.quad);
      if (store_h) *reinterpret_cast<__nv_bfloat162*>(hs + where) = hv;
      const float2 hf = __bfloat1622float2(hv);
      float g0 = gelu_erf(hf.x), g1 = gelu_erf(hf.y);
      if (keep_q) {
        g0 *= bits.keep(j, 0) ? inv_keep : 0.f;
        g1 *= bits.keep(j, 1) ? inv_keep : 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(gs + where) =
          __floats2bfloat162_rn(g0, g1);
    }
  }
  store_staged<BN>(&tg, gs, store_h ? &th : nullptr, hs, n0, m0, hid);
}

// Pass 3: y = bf16(x + (g . W2^T + b2) * mask2 / keep). The
// tensor-parallel form (kPartial) writes y in f32 without rounding, and
// adds b2 and x only where they are given (the model group's first shard).
template <int BN, bool kPartial>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
    fc2_residual_kernel(const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap tw2,
                        const float* __restrict__ b2,
                        const bf16* __restrict__ x, void* __restrict__ y,
                        int M, int dim, int hid, float inv_keep,
                        uint32_t keep_q, uint64_t seed2) {
  extern __shared__ unsigned char smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  float acc[Loop<BN>::kAccRegs];
  if (!Loop<BN>::run(&tg, &tw2, m0, n0, hid, smem, acc)) return;
  const Place at;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = at.r0 + 8 * half;
    const int row = m0 + r;
    QuadKeep bits;
    if (keep_q)
      bits.draw((static_cast<uint64_t>(row) * dim + n0) >> 4, at.quad,
                keep_q, seed2);
    if (row >= M) continue;
    const size_t off = static_cast<size_t>(row) * dim;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * at.quad;
      if (col >= dim) continue;   // dim is even: col + 1 < dim too
      float z0 = acc[4 * j + 2 * half], z1 = acc[4 * j + 2 * half + 1];
      if (!kPartial || b2 != nullptr) {
        const float2 bc = *reinterpret_cast<const float2*>(b2 + col);
        z0 = __fadd_rn(z0, bc.x);
        z1 = __fadd_rn(z1, bc.y);
      }
      if (keep_q) {
        z0 *= bits.keep(j, 0) ? inv_keep : 0.f;
        z1 *= bits.keep(j, 1) ? inv_keep : 0.f;
      }
      if constexpr (kPartial) {
        if (x != nullptr) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + off + col));
          z0 = __fadd_rn(z0, xf.x);
          z1 = __fadd_rn(z1, xf.y);
        }
        *reinterpret_cast<float2*>(static_cast<float*>(y) + off + col) =
            make_float2(z0, z1);
      } else {
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + off + col));
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(y) + off +
                                           col) =
            __floats2bfloat162_rn(__fadd_rn(z0, xf.x), __fadd_rn(z1, xf.y));
      }
    }
  }
}

template <int BN>
cudaError_t allow_fc1_smem() {
  return allow_smem(fc1_gelu_kernel<BN>, Loop<BN>::kSmemBytes);
}

template <int BN>
void launch_fc1(const CUtensorMap& tu, const CUtensorMap& tw1,
                const CUtensorMap& tg, const CUtensorMap& th, const float* b1,
                bool store_h, int M, int dim, int hid, float inv_keep,
                uint32_t keep_q, uint64_t seed1, cudaStream_t stream) {
  fc1_gelu_kernel<BN><<<dim3((hid + BN - 1) / BN, (M + kBM - 1) / kBM),
                        kThreads, Loop<BN>::kSmemBytes, stream>>>(
      tu, tw1, tg, th, b1, store_h, M, dim, hid, inv_keep, keep_q, seed1);
}

template <int BN, bool kPartial>
void launch_fc2(const CUtensorMap& tg, const CUtensorMap& tw2,
                const float* b2, const bf16* x, void* y, int M, int dim,
                int hid, float inv_keep, uint32_t keep_q, uint64_t seed2,
                cudaStream_t stream) {
  fc2_residual_kernel<BN, kPartial>
      <<<dim3((dim + BN - 1) / BN, (M + kBM - 1) / kBM), kThreads,
          Loop<BN>::kSmemBytes, stream>>>(tg, tw2, b2, x, y, M, dim, hid,
                                          inv_keep, keep_q, seed2);
}

template <int BN, bool kPartial>
cudaError_t allow_fc2_smem() {
  return allow_smem(fc2_residual_kernel<BN, kPartial>, Loop<BN>::kSmemBytes);
}

// The three passes; with yf non-null the last is fc2's tensor-parallel
// form into yf, its residual x_res and bias b2 each null or given.
cudaError_t launch_all(const bf16* x, const float* gamma, const float* beta,
                       const bf16* w1, const float* b1, const bf16* w2,
                       const float* b2, bf16* y, bf16* h,
                       unsigned char* scratch, int M, int dim, int hid,
                       float eps, float inv_keep, uint32_t keep_q,
                       uint64_t seed1, uint64_t seed2, cudaStream_t stream,
                       const bf16* x_res = nullptr, float* yf = nullptr) {
  const Scratch at(M, dim, hid);
  bf16* u = reinterpret_cast<bf16*>(scratch + at.u);
  bf16* g = reinterpret_cast<bf16*>(scratch + at.g);
  const int bn1 = tile_n(M, hid), bn2 = tile_n(M, dim);
  // Every map is encoded, and every instance allowed its shared memory,
  // before the first launch: a failure leaves nothing half done. g's map
  // serves fc1's store and fc2's load (64-column boxes of kBM rows).
  CUtensorMap tu, tw1, tg, tw2, th = {};
  cudaError_t err = hopper::encode_kmajor(&tu, u, M, dim, false, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw1, w1, hid, dim, false, bn1);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tg, g, M, hid, false, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw2, w2, dim, hid, false, bn2);
  if (err == cudaSuccess && h != nullptr)
    err = hopper::encode_kmajor(&th, h, M, hid, false, kBM);
  if (err == cudaSuccess) err = allow_fc1_smem<64>();
  if (err == cudaSuccess) err = allow_fc1_smem<128>();
  if (err == cudaSuccess)
    err = yf != nullptr ? allow_fc2_partial_smem() : allow_fc2_residual_smem();
  if (err != cudaSuccess) return err;

  if ((err = launch_ln_rows(x, gamma, beta, u, M, dim, eps, stream)) !=
      cudaSuccess)
    return err;
  (bn1 == 64 ? launch_fc1<64> : launch_fc1<128>)(
      tu, tw1, tg, th, b1, h != nullptr, M, dim, hid, inv_keep, keep_q, seed1,
      stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (yf != nullptr)
    return launch_fc2_partial(tg, tw2, b2, x_res, yf, M, dim, hid, inv_keep,
                              keep_q, seed2, bn2, stream);
  return launch_fc2_residual(tg, tw2, b2, x, y, M, dim, hid, inv_keep, keep_q,
                             seed2, bn2, stream);
}

}  // namespace

cudaError_t mlp::allow_fc2_residual_smem() {
  const cudaError_t err = allow_fc2_smem<64, false>();
  return err == cudaSuccess ? allow_fc2_smem<128, false>() : err;
}

cudaError_t mlp::launch_fc2_residual(const CUtensorMap& tg,
                                     const CUtensorMap& tb, const float* b,
                                     const bf16* x, bf16* y, int M, int N,
                                     int K, float inv_keep, uint32_t keep_q,
                                     uint64_t seed, int bn,
                                     cudaStream_t stream) {
  (bn == 64 ? launch_fc2<64, false> : launch_fc2<128, false>)(
      tg, tb, b, x, y, M, N, K, inv_keep, keep_q, seed, stream);
  return cudaGetLastError();
}

cudaError_t mlp::allow_fc2_partial_smem() {
  const cudaError_t err = allow_fc2_smem<64, true>();
  return err == cudaSuccess ? allow_fc2_smem<128, true>() : err;
}

cudaError_t mlp::launch_fc2_partial(const CUtensorMap& tg,
                                    const CUtensorMap& tb, const float* b,
                                    const bf16* x, float* y, int M, int N,
                                    int K, float inv_keep, uint32_t keep_q,
                                    uint64_t seed, int bn,
                                    cudaStream_t stream) {
  (bn == 64 ? launch_fc2<64, true> : launch_fc2<128, true>)(
      tg, tb, b, x, y, M, N, K, inv_keep, keep_q, seed, stream);
  return cudaGetLastError();
}

cudaError_t mlp::launch_ln_rows(const bf16* x, const float* gamma,
                                const float* beta, bf16* u, int M, int dim,
                                float eps, cudaStream_t stream) {
  ln_rows_kernel<<<(M + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                   stream>>>(x, gamma, beta, u, M, dim, eps);
  return cudaGetLastError();
}

cudaError_t mlp::launch_dz_rows(const bf16* dy, const bf16* x,
                                const float* gamma, const float* beta,
                                bf16* dz, bf16* u, float2* stats, int M,
                                int dim, float eps, float inv_keep,
                                uint32_t keep_q, uint64_t seed,
                                cudaStream_t stream) {
  const int blocks = (M + kRowWarps - 1) / kRowWarps;
  if (x != nullptr)
    dz_rows_kernel<true><<<blocks, kRowWarps * 32, 0, stream>>>(
        dy, x, gamma, beta, dz, u, stats, M, dim, eps, inv_keep, keep_q,
        seed);
  else
    dz_rows_kernel<false><<<blocks, kRowWarps * 32, 0, stream>>>(
        dy, nullptr, nullptr, nullptr, dz, nullptr, nullptr, M, dim, 0.f,
        inv_keep, keep_q, seed);
  return cudaGetLastError();
}

}  // namespace nvt

// x [M, dim] bf16; gamma, beta [dim] f32; w1 [hid, dim] bf16; b1 [hid] f32;
// w2 [dim, hid] bf16; b2 [dim] f32; y [M, dim] bf16; h [M, hid] bf16 or
// null; scratch nvt_fused_mlp_scratch_bytes(M, dim, hid) bytes, 256-byte
// aligned. dim and hid are multiples of 16, of any size. keep_q: dropout
// threshold (0 = none); seed1 the hidden site, seed2 the output.
extern "C" int nvt_fused_mlp_fwd(const void* x, const void* gamma,
                                 const void* beta, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* y, void* h,
                                 void* scratch, int M, int dim, int hid,
                                 float eps, float inv_keep, int keep_q,
                                 uint64_t seed1, uint64_t seed2,
                                 void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0 ||
      keep_q < 0 || keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(y),
      static_cast<bf16*>(h), static_cast<unsigned char*>(scratch), M, dim,
      hid, eps, inv_keep, static_cast<uint32_t>(keep_q), seed1, seed2,
      static_cast<cudaStream_t>(stream)));
}

// K4's tensor-parallel form on a shard (w1 [hid, dim], b1 [hid], w2 [dim,
// hid] the shard's hidden columns), every operand as nvt_fused_mlp_fwd's
// but y [M, dim] f32: y = (g . W2^T [+ b2]) * mask2 / keep [+ x_res], not
// rounded, b2 and x_res null on all but the model group's first shard.
extern "C" int nvt_fused_mlp_partial_fwd(
    const void* x, const void* gamma, const void* beta, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* x_res,
    void* y, void* h, void* scratch, int M, int dim, int hid, float eps,
    float inv_keep, int keep_q, uint64_t seed1, uint64_t seed2,
    void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0 ||
      keep_q < 0 || keep_q > 255 || y == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), nullptr, static_cast<bf16*>(h),
      static_cast<unsigned char*>(scratch), M, dim, hid, eps, inv_keep,
      static_cast<uint32_t>(keep_q), seed1, seed2,
      static_cast<cudaStream_t>(stream), static_cast<const bf16*>(x_res),
      static_cast<float*>(y)));
}

// Bytes of the scratch one call takes (ops/fused_mlp.py, mlp_plan).
extern "C" long long nvt_fused_mlp_scratch_bytes(int M, int dim, int hid) {
  return static_cast<long long>(nvt::Scratch(M, dim, hid).bytes);
}

// Dynamic shared memory of a block of the GEMM pass whose output is
// [M, N] (fc1: N = hid; fc2: N = dim), which follows its tile's width.
extern "C" long long nvt_fused_mlp_smem_bytes(int M, int N) {
  return static_cast<long long>(nvt::mlp::gemm_smem_bytes(M, N));
}
