// Backward of the fused residual MLP block (K9), bf16, deterministic, on
// TMA + wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_mlp.py:141 (_bwd_kernel,
// launched at :241). From dy, x, the forward's h and the regenerated masks:
//   dz = bf16(dy * mask2 / keep)
//   a  = bf16(GELU(h) * mask1 / keep)               the dW2 operand
//   da = dz . W2                                    f32, [M, hid]
//   dh = bf16(da * GELU'(h) * mask1 / keep)         GELU' = Phi + h phi
//   du = dh . W1                                    f32, [M, dim]
//   dx = bf16(LN backward of du at x + dy),  u = bf16(LN(x) * gamma + beta)
//   dgamma = sum_rows(du * xhat), dbeta = sum_rows(du)
// dW1 = u^T dh, dW2 = a^T dz, db1 and db2 stay outside (ops/fused_mlp.py,
// FusedMlp.backward).
//
// What bounds it on the H100: 4 M dim hid flops in two GEMMs (67.2 GFLOP,
// 0.068 ms at 989 TFLOP/s, for the flagship block at batch 8: M = 8008,
// dim 1024, hid 2048). The TPU kernel runs both GEMMs per row block with
// the [rows, hid] da in VMEM. A block that feeds wgmma from a TMA ring has
// no room for a row block's da or du, so the work goes through device
// memory where JAX writes to HBM anyway, plus du's f32 round trip (the
// LayerNorm backward needs whole rows of it): dy and x read twice, h once,
// dz, u, a, dh, dx written, dh read again, du written and read as f32,
// about 336 MB at that shape (0.100 ms at 3.35 TB/s), in five launches on
// the caller's stream:
//   1. dz_rows (fused_mlp.cu, launch_dz_rows, which K8 launches without
//      the LayerNorm): one warp a row writes u (ln_row, fused_mlp.cuh:
//      K4's ln_rows, so u has the forward's bits), the row's (mean, rstd),
//      and dz (lane l takes columns 512 i + 16 l .. + 15: one Philox
//      block).
//   2. hidden: fused_mlp.cuh Loop<BN, true> over ceil(hid / BN) x
//      ceil(M / 128) tiles, A = dz, B = W2 [dim, hid] as it lies (MN-major
//      for this product: hopper_gemm.cuh's MN-major B mode, wgmma's
//      transpose-B). The producer has TMA prefetch the block's h tile into
//      L2 as the mainloop starts, and once the ring is free TMA loads it
//      beside the two output tiles while the threads draw mask1 as K4's
//      fc1 draws it (QuadKeep at row * hid + j). The epilogue, from the
//      accumulator registers: erf, GELU and GELU', a and dh rounded and
//      staged in the ring, stored by TMA (K4's fc1 stores g and h so).
//   3-5. du, ln_bwd, colsum: ln_bwd.cuh's passes, which K7
//      (fused_qkv_bwd.cu) launches too, with A = dh, B = W1 [hid, dim] as
//      it lies and the residual dy: du = dh . W1 in f32 with the tile's
//      share of the LayerNorm backward's sums in its epilogue, one warp a
//      row for dx = bf16(rstd (du gamma - m1 - xhat m2) + dy), and dgamma
//      / dbeta summed over the row tiles in a fixed order.
// Three stages (97 KiB of ring at BN = 128) let two GEMM blocks share an
// SM, so one block's epilogue runs under the other's mainloop; BN is 128,
// or 64 where 128-wide tiles would give the card fewer blocks than its 132
// SMs (tile_n, K4's rule). TMA zero-fills the boxes past M, dim and hid on
// loads and clips them on stores. Widths are multiples of 16 (TMA's 16-byte
// rows) of any size. du, the row statistics and the partial sums live in
// one scratch allocation (ops/fused_mlp.py, mlp_bwd_plan).
//
// GELU and GELU' use CUDA's erff and expf, not the TPU kernel's
// Abramowitz-Stegun polynomial (fused_mlp.py:65-85); both are within
// 1.5e-7 of erf, below bf16 resolution.
#include "ln_bwd.cuh"

namespace nvt {
namespace {

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// Pass 2: da = dz . W2 in registers; a = bf16(GELU(h) * mask1 / keep) and
// dh = bf16(da * GELU'(h) * mask1 / keep), staged and stored by TMA. The
// producer prefetches the block's h tile into L2 as the mainloop starts;
// once the ring is free, TMA loads it past the two staged tiles while the
// threads draw their dropout bits.
template <int BN>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
    hidden_kernel(const __grid_constant__ CUtensorMap tdz,
                  const __grid_constant__ CUtensorMap tw2,
                  const __grid_constant__ CUtensorMap th,
                  const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tdh, int dim, int hid,
                  float inv_keep, uint32_t keep_q, uint64_t seed1) {
  extern __shared__ unsigned char smem[];
  __shared__ uint64_t h_full;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  if (threadIdx.x == 0) hopper::mbar_init(&h_full, 1);   // fenced in run()
  if (threadIdx.x == kConsumerThreads)
    for (int b = 0; b < BN / 64; ++b)
      hopper::tma_prefetch_l2_2d(&th, n0 + 64 * b, m0);
  float acc[Loop<BN, true>::kAccRegs];
  if (!Loop<BN, true>::run(&tdz, &tw2, m0, n0, dim, smem, acc)) return;
  const Place at;
  unsigned char* as = reinterpret_cast<unsigned char*>(
      round_up(reinterpret_cast<size_t>(smem), 1024));   // the ring
  unsigned char* dhs = as + kBM * BN * sizeof(bf16);
  const unsigned char* hs = dhs + kBM * BN * sizeof(bf16);
  hopper::named_barrier(1, kConsumerThreads);   // no wgmma reads it now
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(&h_full, kBM * BN * sizeof(bf16));
    for (int b = 0; b < BN / 64; ++b)
      hopper::tma_load_2d(const_cast<unsigned char*>(hs) + b * kBM * 128,
                          &th, &h_full, n0 + 64 * b, m0);
  }
  // Every thread of the warp takes part in the quads' shuffles; rows past
  // M (h zero-filled by TMA, da 0) are clipped by the store.
  QuadKeep bits[2];
  if (keep_q)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      bits[half].draw(
          (static_cast<uint64_t>(m0 + at.r0 + 8 * half) * hid + n0) >> 4,
          at.quad, keep_q, seed1);
  hopper::mbar_wait(&h_full, 0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = at.r0 + 8 * half;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * at.quad;
      if (col >= hid) continue;   // hid is even: col + 1 < hid too
      const int where = staged_at(r, j, at.quad);
      const float2 hf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(hs + where));
      const float hv[2] = {hf.x, hf.y};
      float av[2], dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // GELU as fused_mlp.cu computes it; GELU' = Phi(h) + h phi(h).
        const float x = hv[e];
        const float erf_x = erff(x * kInvSqrt2);
        av[e] = 0.5f * x * (1.f + erf_x);
        dv[e] = acc[4 * j + 2 * half + e] *
                (0.5f * (1.f + erf_x) + x * expf(-0.5f * x * x) * kInvSqrt2Pi);
        if (keep_q) {
          const float m = bits[half].keep(j, e) ? inv_keep : 0.f;
          av[e] *= m;
          dv[e] *= m;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(as + where) =
          __floats2bfloat162_rn(av[0], av[1]);
      *reinterpret_cast<__nv_bfloat162*>(dhs + where) =
          __floats2bfloat162_rn(dv[0], dv[1]);
    }
  }
  store_staged<BN>(&ta, as, &tdh, dhs, n0, m0, hid);
}

template <int BN>
void launch_hidden(const CUtensorMap& tdz, const CUtensorMap& tw2,
                   const CUtensorMap& th, const CUtensorMap& ta,
                   const CUtensorMap& tdh, int M, int dim, int hid,
                   float inv_keep, uint32_t keep_q, uint64_t seed1,
                   cudaStream_t stream) {
  hidden_kernel<BN><<<dim3((hid + BN - 1) / BN, row_tiles(M)), kThreads,
                      Loop<BN, true>::kSmemBytes, stream>>>(
      tdz, tw2, th, ta, tdh, dim, hid, inv_keep, keep_q, seed1);
}

// The five passes; res is the residual the LayerNorm rows add (dy, or
// null on a tensor-parallel shard other than the model group's first), dx
// bf16 or a shard's f32 partial.
template <typename TO>
cudaError_t launch_all(const bf16* dy, const bf16* x, const bf16* h,
                       const float* gamma, const float* beta, const bf16* w1,
                       const bf16* w2, const bf16* res, TO* dx, bf16* u,
                       bf16* a, bf16* dz, bf16* dh, float* dgamma,
                       float* dbeta, unsigned char* scratch, int M, int dim,
                       int hid, float eps, float inv_keep, uint32_t keep_q,
                       uint64_t seed1, uint64_t seed2, cudaStream_t stream) {
  float2* stats =
      reinterpret_cast<float2*>(scratch + Scratch(M, dim).stats);
  // Every map is encoded, and every instance allowed its shared memory,
  // before the first launch: a failure leaves nothing half done. dh's map
  // serves the hidden pass's store and the du pass's load (64-column boxes
  // of kBM rows); h's, a's and dz's have the same boxes.
  CUtensorMap tdz, tw2, th, ta, tdh, tw1;
  cudaError_t err = hopper::encode_kmajor(&tdz, dz, M, dim, false, kBM);
  if (err == cudaSuccess) err = hopper::encode_mnmajor(&tw2, w2, dim, hid);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&th, h, M, hid, false, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&ta, a, M, hid, false, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tdh, dh, M, hid, false, kBM);
  if (err == cudaSuccess) err = hopper::encode_mnmajor(&tw1, w1, hid, dim);
  if (err == cudaSuccess)
    err = allow_smem(hidden_kernel<64>, Loop<64, true>::kSmemBytes);
  if (err == cudaSuccess)
    err = allow_smem(hidden_kernel<128>, Loop<128, true>::kSmemBytes);
  if (err == cudaSuccess) err = allow_du_smem();
  if (err != cudaSuccess) return err;

  if ((err = launch_dz_rows(dy, x, gamma, beta, dz, u, stats, M, dim, eps,
                            inv_keep, keep_q, seed2, stream)) != cudaSuccess)
    return err;
  (tile_n(M, hid) == 64 ? launch_hidden<64> : launch_hidden<128>)(
      tdz, tw2, th, ta, tdh, M, dim, hid, inv_keep, keep_q, seed1, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_ln_bwd(tdh, tw1, x, gamma, res, dx, dgamma, dbeta, scratch,
                       M, dim, hid, stream);
}

}  // namespace
}  // namespace nvt

// dy, x [M, dim], h [M, hid], w1 [hid, dim], w2 [dim, hid] bf16; gamma,
// beta [dim] f32. Outputs: dx, u, dz [M, dim] and a, dh [M, hid] bf16;
// dgamma, dbeta [dim] f32. scratch: nvt_fused_mlp_bwd_scratch_bytes(M, dim,
// hid) bytes, 256-byte aligned. dim and hid are multiples of 16, of any
// size. keep_q: dropout threshold (0 = none); seed1 the hidden site, seed2
// the output site.
extern "C" int nvt_fused_mlp_bwd(
    const void* dy, const void* x, const void* h, const void* gamma,
    const void* beta, const void* w1, const void* w2, void* dx, void* u,
    void* a, void* dz, void* dh, void* dgamma, void* dbeta, void* scratch,
    int M, int dim, int hid, float eps, float inv_keep, int keep_q,
    uint64_t seed1, uint64_t seed2, void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0 ||
      keep_q < 0 || keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(x),
      static_cast<const bf16*>(h), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), static_cast<bf16*>(u), static_cast<bf16*>(a),
      static_cast<bf16*>(dz), static_cast<bf16*>(dh),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<unsigned char*>(scratch), M, dim, hid, eps, inv_keep,
      static_cast<uint32_t>(keep_q), seed1, seed2,
      static_cast<cudaStream_t>(stream)));
}

// K9's tensor-parallel form on a shard (h [M, hid], w1 [hid, dim], w2 [dim,
// hid] the shard's hidden columns), every operand as nvt_fused_mlp_bwd's
// but dx [M, dim] f32, the shard's partial: LN backward of its partial du
// [+ res], not rounded; res is dy on the model group's first shard and
// null on the others. dgamma and dbeta are the shard's partials.
extern "C" int nvt_fused_mlp_bwd_partial(
    const void* dy, const void* x, const void* h, const void* gamma,
    const void* beta, const void* w1, const void* w2, const void* res,
    void* dx, void* u, void* a, void* dz, void* dh, void* dgamma,
    void* dbeta, void* scratch, int M, int dim, int hid, float eps,
    float inv_keep, int keep_q, uint64_t seed1, uint64_t seed2,
    void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0 ||
      keep_q < 0 || keep_q > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(x),
      static_cast<const bf16*>(h), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(res),
      static_cast<float*>(dx), static_cast<bf16*>(u), static_cast<bf16*>(a),
      static_cast<bf16*>(dz), static_cast<bf16*>(dh),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<unsigned char*>(scratch), M, dim, hid, eps, inv_keep,
      static_cast<uint32_t>(keep_q), seed1, seed2,
      static_cast<cudaStream_t>(stream)));
}

// Bytes of the scratch one call takes (ops/fused_mlp.py, mlp_bwd_plan).
extern "C" long long nvt_fused_mlp_bwd_scratch_bytes(int M, int dim,
                                                     int /*hid*/) {
  return static_cast<long long>(nvt::Scratch(M, dim).bytes);
}

// Dynamic shared memory of a block of the GEMM pass whose output is
// [M, N] (hidden: N = hid; du: N = dim), which follows its tile's width.
extern "C" long long nvt_fused_mlp_bwd_smem_bytes(int M, int N) {
  return static_cast<long long>(nvt::mlp::gemm_smem_bytes(M, N));
}
