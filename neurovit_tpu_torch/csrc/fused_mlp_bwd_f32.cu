// Backward of the fused residual MLP block (K9) at f32, deterministic, on
// the CUDA cores.
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
// What bounds it on the H100: its 4 M dim hid flops in two GEMMs, at f32
// on the CUDA cores (ffma.cuh says why not yet in 3xTF32): 67.2 GFLOP for
// the flagship block at batch 8 (M = 8008, dim 1024, hid 2048), 1.0 ms at
// 67 TFLOP/s, far above its bytes.
//
// The design, five launches on the caller's stream, K9's bf16 plan
// (fused_mlp_bwd.cu) at f32 (ops/fused_mlp.py mlp_bwd_f32_plan):
//   1. dz_rows (ffma.cu launch_dz_rows): one warp a row writes u and the
//      row's (mean, rstd) as K4 f32's LayerNorm computes them, and at
//      dropout > 0 dz (at dropout 0 dz is dy, which the wrapper returns);
//   2. hidden: ffma.cuh's GEMM over (ceil(hid / 128), ceil(M / 128))
//      tiles, A = dz, B = W2 [dim, hid] as it lies (kBKn); HiddenEpi reads
//      h and writes a and dh from the accumulator registers;
//   3-5. du, ln_bwd, colsum: ffma_ln_bwd.cuh's passes (K7 f32's too) with
//      A = dh, B = W1 [hid, dim] as it lies and the residual dy.
// GELU and GELU' use CUDA's erff and expf, as K4 f32 and the bf16 K9 do.
#include "ffma_ln_bwd.cuh"

namespace nvt {
namespace {

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// da = C; a = GELU(h) * m, dh = da * GELU'(h) * m, m the hidden site's
// keep factor (1 without dropout).
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
    const size_t at = static_cast<size_t>(row) * hid + col;
    const float4 hv = *reinterpret_cast<const float4*>(h + at);
    const float4 m = keep_q ? ffma::keep4(at, seed, keep_q, inv_keep)
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
    *reinterpret_cast<float4*>(a + at) = make_float4(av[0], av[1], av[2],
                                                     av[3]);
    *reinterpret_cast<float4*>(dh + at) = make_float4(dv[0], dv[1], dv[2],
                                                      dv[3]);
  }
};

}  // namespace
}  // namespace nvt

// dy, x [M, dim], h [M, hid], w1 [hid, dim], w2 [dim, hid], gamma, beta
// [dim], all f32. Outputs: dx, u [M, dim], dz [M, dim] (null at dropout
// 0), a, dh [M, hid], dgamma, dbeta [dim], f32. scratch:
// nvt_ln_bwd_f32_scratch_bytes(M, dim) bytes, 256-byte aligned. dim and
// hid are multiples of 16. keep_q: dropout threshold (0 = none); seed1 the
// hidden site, seed2 the output site.
extern "C" int nvt_fused_mlp_f32_bwd(
    const void* dy, const void* x, const void* h, const void* gamma,
    const void* beta, const void* w1, const void* w2, void* dx, void* u,
    void* a, void* dz, void* dh, void* dgamma, void* dbeta, void* scratch,
    int M, int dim, int hid, float eps, float inv_keep, int keep_q,
    uint64_t seed1, uint64_t seed2, void* stream) {
  using namespace nvt;
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
  cudaError_t err = ffma::launch_dz_rows(
      dyf, xf, gm, static_cast<const float*>(beta), static_cast<float*>(dz),
      static_cast<float*>(u),
      reinterpret_cast<float2*>(base + LnScratch(M, dim).stats), M, dim, eps,
      inv_keep, kq, seed2, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dhf = static_cast<float*>(dh);
  const HiddenEpi hidden{static_cast<const float*>(h), static_cast<float*>(a),
                         dhf, hid, inv_keep, kq, seed1};
  err = ffma::launch_gemm<true>(kq ? static_cast<const float*>(dz) : dyf,
                                static_cast<const float*>(w2), M, hid, dim,
                                hidden, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ln_bwd_f32(
      dhf, static_cast<const float*>(w1), xf, gm, dyf,
      static_cast<float*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), base, M, dim, hid, s));
}
