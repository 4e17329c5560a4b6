// Backward of the fused residual MLP block (K9) at f32, deterministic, on
// the tensor cores by 3xTF32 on wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_mlp.py:141 (_bwd_kernel,
// launched at :241) on f32 operands, where nothing is rounded. From dy, x,
// the forward's pre-GELU h and the regenerated masks:
//   dz = dy * mask2 / keep
//   a  = GELU(h) * mask1 / keep                     the dW2 operand
//   da = dz . W2                                    f32, [M, hid]
//   dh = da * GELU'(h) * mask1 / keep               GELU' = Phi + h phi
//   du = dh . W1                                    f32, [M, dim]
//   dx = LN backward of du at x, + dy;  u = LN(x) * gamma + beta
//   dgamma = sum_rows(du * xhat), dbeta = sum_rows(du)
// dW1 = u^T dh, dW2 = a^T dz, db1 and db2 stay outside (ops/fused_mlp.py,
// FusedMlp.backward). The masks are the forward's bits (fused_mlp_f32.cu).
//
// What bounds it on the H100: its 4 M dim hid flops in two GEMMs, 67.2
// GFLOP for the flagship block at batch 8 (M = 8008, dim 1024, hid 2048).
// In 3xTF32 (tf32x3_wgmma.cuh: three TF32 products a product, about f32's
// accuracy) at the data sheet's 495 TF32 TFLOP/s that is 165 TFLOP/s of
// f32 products, 0.407 ms; the CUDA cores' FFMA (67 TFLOP/s, this kernel's
// first design) 1.0 ms. Its bytes (dy, x, h and the weights in; dx, u,
// dz, a and dh out) are 0.38 GB at dropout > 0, 0.11 ms at 3.35 TB/s.
//
// The design, seven launches on the caller's stream
// (ops/fused_mlp.py mlp_bwd_f32_plan):
//   1-2. the weight pre-pass (nvt_wsplit_f32, its own wrapper), once for
//      W2 [dim, hid] and once for W1 [hid, dim]: both products contract
//      the weight's out dimension, so each weight is MN-major as it lies,
//      and split_t_kernel writes its transpose split into big and small
//      (W2^T [hid, dim], W1^T [dim, hid]), K-major for wgmma;
//   3. dz_rows (ffma.cu launch_dz_rows): one warp a row writes u and the
//      row's (mean, rstd) as K4 f32's LayerNorm computes them, and at
//      dropout > 0 dz (at dropout 0 dz is dy, which the wrapper returns);
//   4. hidden: tf32x3_wgmma.cuh's Loop over (ceil(hid / 128), ceil(M /
//      128)) tiles, K = dim, A = dz (dy at dropout 0); HiddenEpi reads h
//      and writes a and dh from the accumulator, four values at a time
//      (for_each_quad), their hidden-site keep bytes from one Philox call
//      (keep_quad, the bits K4 f32's fc1 epilogue draws);
//   5-7. du, ln_bwd, colsum: tf32x3_ln_bwd.cuh's passes (K7 f32's too)
//      with A = dh, W1^T split and the residual dy.
// A GEMM block takes 193 KiB of shared memory (four stages of 48 KiB), one
// block an SM; each stage sums into a fresh accumulator (the products
// round toward zero), added in f32. GELU and GELU' use CUDA's erff and
// expf, as K4 f32 and the bf16 K9 do.
#include "ffma.cuh"
#include "tf32x3_ln_bwd.cuh"

namespace nvt {
namespace {

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// da = C; a = GELU(h) * m, dh = da * GELU'(h) * m, m the hidden site's
// keep factor (1 without dropout), for a for_each_quad group: columns
// col, col + 1, col + 8 and col + 9 of row.
struct HiddenEpi {
  const float* h;
  float* a;
  float* dh;
  int hid;
  float inv_keep;
  uint32_t keep_q;
  uint64_t seed;

  __device__ __forceinline__ void operator()(int row, int col,
                                             float4 c) const {
    using namespace tf32x3_wgmma;
    const size_t at = static_cast<size_t>(row) * hid + col;
    const float4 hv = load_quad(h, at);
    const float4 m = keep_q ? keep_quad(at, seed, keep_q, inv_keep)
                            : make_float4(1.f, 1.f, 1.f, 1.f);
    const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
    const float cs[4] = {c.x, c.y, c.z, c.w};
    const float ms[4] = {m.x, m.y, m.z, m.w};
    float av[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = hs[e];
      const float erf_x = erff(x * kInvSqrt2);
      av[e] = 0.5f * x * (1.f + erf_x) * ms[e];
      dv[e] = cs[e] *
              (0.5f * (1.f + erf_x) + x * expf(-0.5f * x * x) * kInvSqrt2Pi) *
              ms[e];
    }
    store_quad(a, at, make_float4(av[0], av[1], av[2], av[3]));
    store_quad(dh, at, make_float4(dv[0], dv[1], dv[2], dv[3]));
  }
};

__global__ void __launch_bounds__(tf32x3_wgmma::kThreads, 1)
    hidden_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tbig,
                  const __grid_constant__ CUtensorMap tsmall, int M, int dim,
                  HiddenEpi epi) {
  extern __shared__ unsigned char smem[];
  tf32x3_wgmma::gemm_tile<BwdLoop>(&ta, &tbig, &tsmall, M, epi.hid, dim, smem,
                                   epi);
}

}  // namespace
}  // namespace nvt

// dy, x [M, dim], h [M, hid], gamma, beta [dim], w2t_big, w2t_small [hid,
// dim] (W2's split transpose, nvt_wsplit_f32), w1t_big, w1t_small [dim,
// hid] (W1's), all f32 and 16-byte aligned. Outputs: dx, u [M, dim], dz
// [M, dim] (null at dropout 0), a, dh [M, hid], dgamma, dbeta [dim], f32.
// scratch: nvt_ln_bwd_f32_scratch_bytes(M, dim) bytes, 256-byte aligned.
// dim and hid are multiples of 16. keep_q: dropout threshold (0 = none);
// seed1 the hidden site, seed2 the output site; res the residual the
// LayerNorm rows add (dy, or null for none).
static int mlp_f32_bwd(
    const void* dy, const void* res, const void* x, const void* h,
    const void* gamma, const void* beta, const void* w2t_big,
    const void* w2t_small, const void* w1t_big, const void* w1t_small,
    void* dx, void* u, void* a, void* dz, void* dh, void* dgamma,
    void* dbeta, void* scratch, int M, int dim, int hid, float eps,
    float inv_keep, int keep_q, uint64_t seed1, uint64_t seed2,
    void* stream) {
  using namespace nvt;
  using namespace nvt::tf32x3_wgmma;
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0 ||
      keep_q < 0 || keep_q > 255 || (keep_q > 0) != (dz != nullptr) ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const float* dyf = static_cast<const float*>(dy);
  const float* xf = static_cast<const float*>(x);
  const float* gm = static_cast<const float*>(gamma);
  const uint32_t kq = static_cast<uint32_t>(keep_q);
  float* dhf = static_cast<float*>(dh);
  // Every map is encoded, and the kernels allowed their shared memory,
  // before the first launch: a failure leaves nothing half done.
  CUtensorMap tz, t2big, t2small, th, t1big, t1small;
  cudaError_t err = encode_kmajor_f32(
      &tz, kq ? static_cast<const float*>(dz) : dyf, M, dim, kBM);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&t2big, static_cast<const float*>(w2t_big), hid,
                            dim, kBN);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&t2small, static_cast<const float*>(w2t_small),
                            hid, dim, kBN);
  if (err == cudaSuccess)
    err = prepare_ln_du(&th, &t1big, &t1small, dhf,
                        static_cast<const float*>(w1t_big),
                        static_cast<const float*>(w1t_small), M, dim, hid);
  if (err == cudaSuccess) err = allow_smem(hidden_kernel, BwdLoop::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ffma::launch_dz_rows(
      dyf, xf, gm, static_cast<const float*>(beta), static_cast<float*>(dz),
      static_cast<float*>(u),
      reinterpret_cast<float2*>(base + LnScratch(M, dim).stats), M, dim, eps,
      inv_keep, kq, seed2, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const HiddenEpi hidden{static_cast<const float*>(h), static_cast<float*>(a),
                         dhf, hid, inv_keep, kq, seed1};
  hidden_kernel<<<dim3((hid + kBN - 1) / kBN, (M + kBM - 1) / kBM), kThreads,
                  BwdLoop::kSmemBytes, s>>>(tz, t2big, t2small, M, dim,
                                            hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ln_bwd_f32(
      th, t1big, t1small, xf, gm, static_cast<const float*>(res),
      static_cast<float*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), base, M, dim,
      hid, s));
}

extern "C" int nvt_fused_mlp_f32_bwd(
    const void* dy, const void* x, const void* h, const void* gamma,
    const void* beta, const void* w2t_big, const void* w2t_small,
    const void* w1t_big, const void* w1t_small, void* dx, void* u, void* a,
    void* dz, void* dh, void* dgamma, void* dbeta, void* scratch, int M,
    int dim, int hid, float eps, float inv_keep, int keep_q, uint64_t seed1,
    uint64_t seed2, void* stream) {
  return mlp_f32_bwd(dy, dy, x, h, gamma, beta, w2t_big, w2t_small, w1t_big,
                     w1t_small, dx, u, a, dz, dh, dgamma, dbeta, scratch, M,
                     dim, hid, eps, inv_keep, keep_q, seed1, seed2, stream);
}

// K9 f32's tensor-parallel form on a shard (h, W2 and W1 the shard's
// hidden columns), every operand as nvt_fused_mlp_f32_bwd's, and res the
// residual the LayerNorm rows add: dy on the model group's first shard,
// null on the others. dx, dgamma and dbeta are the shard's partials.
extern "C" int nvt_fused_mlp_f32_bwd_partial(
    const void* dy, const void* x, const void* h, const void* gamma,
    const void* beta, const void* w2t_big, const void* w2t_small,
    const void* w1t_big, const void* w1t_small, const void* res, void* dx,
    void* u, void* a, void* dz, void* dh, void* dgamma, void* dbeta,
    void* scratch, int M, int dim, int hid, float eps, float inv_keep,
    int keep_q, uint64_t seed1, uint64_t seed2, void* stream) {
  return mlp_f32_bwd(dy, res, x, h, gamma, beta, w2t_big, w2t_small, w1t_big,
                     w1t_small, dx, u, a, dz, dh, dgamma, dbeta, scratch, M,
                     dim, hid, eps, inv_keep, keep_q, seed1, seed2, stream);
}

// Dynamic shared memory of a block of the hidden and du GEMMs
// (ops/fused_mlp.py mlp_bwd_f32_plan).
extern "C" long long nvt_fused_mlp_f32_bwd_smem_bytes() {
  return static_cast<long long>(nvt::BwdLoop::kSmemBytes);
}
