// Fused residual MLP block (K4) at f32, deterministic, on the tensor cores
// by 3xTF32 on wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/fused_mlp.py:108 (_fwd_kernel,
// launched at :213 by fused_mlp_block) on f32 operands, where it sums f32
// products and rounds nowhere:
//   u = LN(x) * gamma + beta             f32
//   h = u . W1^T + b1                    f32
//   g = GELU(h) * mask1 / keep           exact-erf GELU, CUDA erff
//   z = (g . W2^T + b2) * mask2 / keep   f32
//   y = x + z                            f32
// The masks (training only, fused_mlp.py:125-133) are nn.keep_mask's bits
// of two sites: mask1 at row * hid + j of the hidden, mask2 at row * dim +
// c of the output, the bits the bf16 kernel (fused_mlp.cu) and the plain
// version draw. In training h (pre-GELU) is also stored, the tensor the
// backward reads; serving passes null.
//
// What bounds it on the H100: its 4 M dim hid flops, 67.2 GFLOP for the
// flagship block at batch 8 (M = 8008, dim 1024, hid 2048). In 3xTF32
// (tf32x3_wgmma.cuh: three TF32 products a product, about f32's accuracy)
// at the data sheet's 495 TF32 TFLOP/s that is 165 TFLOP/s of f32
// products, 0.407 ms; the bytes that must move (x, y, W1, W2, and h in
// training) are 75 MB, 0.022 ms at 3.35 TB/s.
//
// The design, five launches on the caller's stream, u and g going through
// one f32 scratch [M, dim] + [M, hid] that the wrapper allocates:
//   1-2. the weight pre-pass (nvt_split_f32, its own wrapper, once for W1
//      [hid, dim] and once for W2 [dim, hid]): big and small of each weight
//      as it lies, which is K-major for its product (tf32x3_wgmma.cuh
//      split_kernel);
//   3. ln_rows: x -> u, one warp a row (ffma.cu; K2's pass too);
//   4. fc1_gelu: tf32x3_wgmma.cuh's Loop over (ceil(hid / 128), ceil(M /
//      128)) tiles, K = dim, A = u; the epilogue adds b1, stores h
//      (training), applies GELU and mask1 and stores g;
//   5. fc2_residual: the Loop over (ceil(dim / 128), ceil(M / 128)) tiles,
//      K = hid, A = g; the epilogue adds b2, applies mask2 and adds x.
//      K3 f32 (fused_outproj_f32.cu) is one launch of this pass with A = a
//      and K = inner (launch_fc2_residual, declared in tf32x3_wgmma.cuh).
// A GEMM block takes 193 KiB of shared memory (four stages of 48 KiB), one
// block an SM; fc2's K = 2048 is 768 TF32 products deep, so each stage
// sums into a fresh accumulator (kFreshStages 1), added in f32. The
// epilogues take the accumulator four values at a time (for_each_quad:
// two pairs 8 columns apart in one row), which lie in one 16-byte Philox
// block of a dropout site, so one Philox call gives their four keep bytes
// (keep_quad). GELU uses CUDA's erff (common.cuh gelu_erf), within 1.5e-7
// of erf, as the TPU kernel's Abramowitz-Stegun polynomial is
// (fused_mlp.py:65-79).
#include "ffma.cuh"
#include "tf32x3_wgmma.cuh"

namespace nvt {
namespace {

using namespace tf32x3_wgmma;

constexpr int kStages = 4;
constexpr int kFreshStages = 1;
using MlpLoop = Loop<kStages, kFreshStages>;

// u [M, dim] then g [M, hid], each on a 256-byte boundary.
struct Scratch {
  size_t u, g, bytes;
  Scratch(int M, int dim, int hid) {
    const size_t m = static_cast<size_t>(M);
    u = 0;
    g = round_up(m * dim * sizeof(float), 256);
    bytes = round_up(g + m * hid * sizeof(float), 256);
  }
};

struct GeluEpi {
  const float* b1;
  float* g;
  float* h;
  int hid;
  float inv_keep;
  uint32_t keep_q;
  uint64_t seed;

  __device__ __forceinline__ void operator()(int row, int col,
                                             float4 c) const {
    const size_t at = static_cast<size_t>(row) * hid + col;
    const float4 hv = ffma::add4(c, load_quad(b1, col));
    if (h) store_quad(h, at, hv);
    float4 gv = make_float4(gelu_erf(hv.x), gelu_erf(hv.y), gelu_erf(hv.z),
                            gelu_erf(hv.w));
    if (keep_q) gv = ffma::mul4(gv, keep_quad(at, seed, keep_q, inv_keep));
    store_quad(g, at, gv);
  }
};

// y = x + (C + b) * keep factors on a for_each_quad group: b added, the
// mask of element (row, col) at row * n + col applied where keep_q > 0,
// then x added in f32 (fc2's b2 and mask2; K3 f32's b and mask).
struct Fc2Epi {
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
    float4 z = ffma::add4(c, load_quad(bias, col));
    if (keep_q) z = ffma::mul4(z, keep_quad(at, seed, keep_q, inv_keep));
    store_quad(y, at, ffma::add4(z, load_quad(x, at)));
  }
};

// Fc2Epi's tensor-parallel form: bias and x each added only where given.
struct Fc2PartialEpi {
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
    float4 z = bias != nullptr ? ffma::add4(c, load_quad(bias, col)) : c;
    if (keep_q) z = ffma::mul4(z, keep_quad(at, seed, keep_q, inv_keep));
    store_quad(y, at, x != nullptr ? ffma::add4(z, load_quad(x, at)) : z);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    fc1_gelu_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tbig,
                    const __grid_constant__ CUtensorMap tsmall, int M,
                    int dim, GeluEpi epi) {
  extern __shared__ unsigned char smem[];
  gemm_tile<MlpLoop>(&ta, &tbig, &tsmall, M, epi.hid, dim, smem, epi);
}

__global__ void __launch_bounds__(kThreads, 1)
    fc2_residual_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tbig,
                        const __grid_constant__ CUtensorMap tsmall, int M,
                        int hid, Fc2Epi epi) {
  extern __shared__ unsigned char smem[];
  gemm_tile<MlpLoop>(&ta, &tbig, &tsmall, M, epi.n, hid, smem, epi);
}

__global__ void __launch_bounds__(kThreads, 1)
    fc2_partial_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tbig,
                       const __grid_constant__ CUtensorMap tsmall, int M,
                       int hid, Fc2PartialEpi epi) {
  extern __shared__ unsigned char smem[];
  gemm_tile<MlpLoop>(&ta, &tbig, &tsmall, M, epi.n, hid, smem, epi);
}

// K4 f32's passes on one call's operands; with partial, fc2 is its
// tensor-parallel form, its residual x_res and bias b2 each null or given.
cudaError_t mlp_f32_all(const float* x, const float* gamma, const float* beta,
                        const float* w1_big, const float* w1_small,
                        const float* b1, const float* w2_big,
                        const float* w2_small, const float* b2,
                        const float* x_res, bool partial, float* y, float* h,
                        void* scratch, int M, int dim, int hid, float eps,
                        float inv_keep, uint32_t keep_q, uint64_t seed1,
                        uint64_t seed2, cudaStream_t s) {
  using namespace tf32x3_wgmma;
  const Scratch lay(M, dim, hid);
  char* base = static_cast<char*>(scratch);
  float* u = reinterpret_cast<float*>(base + lay.u);
  float* g = reinterpret_cast<float*>(base + lay.g);
  // Every map is encoded, and the kernels allowed their shared memory,
  // before the first launch: a failure leaves nothing half done.
  CUtensorMap tu, t1big, t1small, tg, t2big, t2small;
  cudaError_t err = encode_kmajor_f32(&tu, u, M, dim, kBM);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&t1big, w1_big, hid, dim, kBN);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&t1small, w1_small, hid, dim, kBN);
  if (err == cudaSuccess) err = encode_kmajor_f32(&tg, g, M, hid, kBM);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&t2big, w2_big, dim, hid, kBN);
  if (err == cudaSuccess)
    err = encode_kmajor_f32(&t2small, w2_small, dim, hid, kBN);
  if (err == cudaSuccess)
    err = allow_smem(fc1_gelu_kernel, MlpLoop::kSmemBytes);
  if (err == cudaSuccess)
    err = partial ? allow_fc2_partial_smem() : allow_fc2_residual_smem();
  if (err != cudaSuccess) return err;
  err = ffma::launch_ln_rows(x, gamma, beta, u, M, dim, eps, s);
  if (err != cudaSuccess) return err;
  const GeluEpi fc1{b1, g, h, hid, inv_keep, keep_q, seed1};
  fc1_gelu_kernel<<<dim3((hid + kBN - 1) / kBN, (M + kBM - 1) / kBM),
                    kThreads, MlpLoop::kSmemBytes, s>>>(tu, t1big, t1small, M,
                                                        dim, fc1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return (partial ? launch_fc2_partial : launch_fc2_residual)(
      tg, t2big, t2small, b2, partial ? x_res : x, y, M, dim, hid, inv_keep,
      keep_q, seed2, s);
}

}  // namespace

cudaError_t tf32x3_wgmma::allow_fc2_partial_smem() {
  return allow_smem(fc2_partial_kernel, MlpLoop::kSmemBytes);
}

cudaError_t tf32x3_wgmma::launch_fc2_partial(
    const CUtensorMap& ta, const CUtensorMap& tbig, const CUtensorMap& tsmall,
    const float* bias, const float* x, float* y, int M, int N, int K,
    float inv_keep, uint32_t keep_q, uint64_t seed, cudaStream_t stream) {
  const Fc2PartialEpi epi{bias, x, y, N, inv_keep, keep_q, seed};
  fc2_partial_kernel<<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM),
                       kThreads, MlpLoop::kSmemBytes, stream>>>(
      ta, tbig, tsmall, M, K, epi);
  return cudaGetLastError();
}

cudaError_t tf32x3_wgmma::allow_fc2_residual_smem() {
  return allow_smem(fc2_residual_kernel, MlpLoop::kSmemBytes);
}

cudaError_t tf32x3_wgmma::launch_fc2_residual(
    const CUtensorMap& ta, const CUtensorMap& tbig, const CUtensorMap& tsmall,
    const float* bias, const float* x, float* y, int M, int N, int K,
    float inv_keep, uint32_t keep_q, uint64_t seed, cudaStream_t stream) {
  const Fc2Epi epi{bias, x, y, N, inv_keep, keep_q, seed};
  fc2_residual_kernel<<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM),
                        kThreads, MlpLoop::kSmemBytes, stream>>>(
      ta, tbig, tsmall, M, K, epi);
  return cudaGetLastError();
}

size_t tf32x3_wgmma::fc2_residual_smem_bytes() { return MlpLoop::kSmemBytes; }

}  // namespace nvt

// The forwards' weight pre-pass (K2's Wqkv, K4's W1 and W2): w [n] f32
// into big and small [n] f32 (big + small == w exactly). n % 4 == 0, all
// 16-byte aligned.
extern "C" int nvt_split_f32(const void* w, void* big, void* small,
                             long long n, void* stream) {
  if (n < 4 || n % 4 != 0 || big == nullptr || small == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(nvt::tf32x3_wgmma::launch_split(
      static_cast<const float*>(w), static_cast<float*>(big),
      static_cast<float*>(small), static_cast<size_t>(n),
      static_cast<cudaStream_t>(stream)));
}

// Blocks of the pre-pass over n f32 (ops/tf32x3.py split_launch).
extern "C" int nvt_split_f32_blocks(long long n) {
  return nvt::tf32x3_wgmma::split_blocks(static_cast<size_t>(n));
}

// x [M, dim], gamma, beta, b2 [dim], w1_big, w1_small [hid, dim] (W1 split
// by nvt_split_f32), b1 [hid], w2_big, w2_small [dim, hid] (W2's), y [M,
// dim], h [M, hid] or null, scratch of nvt_fused_mlp_f32_scratch_bytes,
// all f32 and 16-byte aligned. dim % 16 == 0, hid % 16 == 0. keep_q:
// dropout threshold (0 = none), inv_keep = 1 / keep; seed1, seed2 the
// hidden and output sites.
extern "C" int nvt_fused_mlp_f32_fwd(
    const void* x, const void* gamma, const void* beta, const void* w1_big,
    const void* w1_small, const void* b1, const void* w2_big,
    const void* w2_small, const void* b2, void* y, void* h, void* scratch,
    int M, int dim, int hid, float eps, float inv_keep, int keep_q,
    uint64_t seed1, uint64_t seed2, void* stream) {
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0 ||
      keep_q < 0 || keep_q > 255 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(nvt::mlp_f32_all(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(w1_big),
      static_cast<const float*>(w1_small), static_cast<const float*>(b1),
      static_cast<const float*>(w2_big), static_cast<const float*>(w2_small),
      static_cast<const float*>(b2), nullptr, false, static_cast<float*>(y),
      static_cast<float*>(h), scratch, M, dim, hid, eps, inv_keep,
      static_cast<uint32_t>(keep_q), seed1, seed2,
      static_cast<cudaStream_t>(stream)));
}

// K4 f32's tensor-parallel form on a shard (W1, b1 and W2 the shard's
// hidden columns), every operand as nvt_fused_mlp_f32_fwd's: y [M, dim] =
// (g . W2^T [+ b2]) * mask2 / keep [+ x_res], b2 and x_res null on all but
// the model group's first shard.
extern "C" int nvt_fused_mlp_f32_partial_fwd(
    const void* x, const void* gamma, const void* beta, const void* w1_big,
    const void* w1_small, const void* b1, const void* w2_big,
    const void* w2_small, const void* b2, const void* x_res, void* y,
    void* h, void* scratch, int M, int dim, int hid, float eps,
    float inv_keep, int keep_q, uint64_t seed1, uint64_t seed2,
    void* stream) {
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0 ||
      keep_q < 0 || keep_q > 255 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(nvt::mlp_f32_all(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(w1_big),
      static_cast<const float*>(w1_small), static_cast<const float*>(b1),
      static_cast<const float*>(w2_big), static_cast<const float*>(w2_small),
      static_cast<const float*>(b2), static_cast<const float*>(x_res), true,
      static_cast<float*>(y), static_cast<float*>(h), scratch, M, dim, hid,
      eps, inv_keep, static_cast<uint32_t>(keep_q), seed1, seed2,
      static_cast<cudaStream_t>(stream)));
}

// Bytes of the scratch of one call (ops/fused_mlp.py mlp_f32_plan).
extern "C" long long nvt_fused_mlp_f32_scratch_bytes(int M, int dim,
                                                     int hid) {
  return static_cast<long long>(nvt::Scratch(M, dim, hid).bytes);
}

// Dynamic shared memory of a block of fc1_gelu and fc2_residual
// (ops/fused_mlp.py mlp_f32_plan).
extern "C" long long nvt_fused_mlp_f32_smem_bytes() {
  return static_cast<long long>(nvt::MlpLoop::kSmemBytes);
}
