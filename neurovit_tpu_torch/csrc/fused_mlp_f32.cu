// Fused residual MLP block (K4) at f32, deterministic, on the CUDA cores.
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
// backward reads; serving passes null. W1 [hid, dim] and W2 [dim, hid] are
// the torch weights as they lie.
//
// What bounds it on the H100: its 4 M dim hid flops. At f32 they run on
// the CUDA cores (ffma.cuh says why not yet in 3xTF32): 67.2 GFLOP for the
// flagship block at batch 8 (M = 8008, dim 1024, hid 2048), 1.0 ms at 67
// TFLOP/s; the bytes that must move (x, y, W1, W2, and h in training) are
// 75 MB, 0.022 ms at 3.35 TB/s.
//
// The design, three launches on the caller's stream, u and g going through
// one f32 scratch [M, dim] + [M, hid] that the wrapper allocates:
//   1. ln_rows: x -> u, one warp a row (ffma.cu; K2's pass too);
//   2. fc1_gelu: ffma.cuh's GEMM over (ceil(hid / 128), ceil(M / 128))
//      tiles, A = u, B = W1; the epilogue adds b1, stores h (training),
//      applies GELU and mask1 and stores g;
//   3. fc2_residual: the GEMM over (ceil(dim / 128), ceil(M / 128)) tiles,
//      A = g, B = W2, with ResidualEpi (b2, mask2, + x), K3's launch.
// GELU uses CUDA's erff (common.cuh gelu_erf), within 1.5e-7 of erf, as
// the TPU kernel's Abramowitz-Stegun polynomial is (fused_mlp.py:65-79).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/torch_kernel_ab.py at
// batch 8, medians over 5 rounds, beside the first GEMM design):
// 1.8779 ms (first design 1.9530), 35.8 TFLOP/s, 1.9x the FFMA floor;
// torch.mm at f32 for fc1 and fc2 1.4608 ms
// (scripts/torch_ffma_tile_sweep.py).
#include "ffma.cuh"

namespace nvt {
namespace {

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
    const float4 hv = ffma::add4(c, *reinterpret_cast<const float4*>(b1 + col));
    if (h) *reinterpret_cast<float4*>(h + at) = hv;
    float4 gv = make_float4(gelu_erf(hv.x), gelu_erf(hv.y), gelu_erf(hv.z),
                            gelu_erf(hv.w));
    if (keep_q) gv = ffma::mul4(gv, ffma::keep4(at, seed, keep_q, inv_keep));
    *reinterpret_cast<float4*>(g + at) = gv;
  }
};

}  // namespace
}  // namespace nvt

// x [M, dim], gamma, beta, b2 [dim], w1 [hid, dim], b1 [hid], w2 [dim,
// hid], y [M, dim], h [M, hid] or null, scratch of
// nvt_fused_mlp_f32_scratch_bytes, all f32. dim % 16 == 0, hid % 16 == 0.
// keep_q: dropout threshold (0 = none), inv_keep = 1 / keep; seed1, seed2
// the hidden and output sites.
extern "C" int nvt_fused_mlp_f32_fwd(const void* x, const void* gamma,
                                     const void* beta, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* y, void* h,
                                     void* scratch, int M, int dim, int hid,
                                     float eps, float inv_keep, int keep_q,
                                     uint64_t seed1, uint64_t seed2,
                                     void* stream) {
  using namespace nvt;
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0 ||
      keep_q < 0 || keep_q > 255 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch lay(M, dim, hid);
  char* base = static_cast<char*>(scratch);
  float* u = reinterpret_cast<float*>(base + lay.u);
  float* g = reinterpret_cast<float*>(base + lay.g);
  const float* xf = static_cast<const float*>(x);
  cudaError_t err = ffma::launch_ln_rows(
      xf, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      u, M, dim, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GeluEpi fc1{static_cast<const float*>(b1), g, static_cast<float*>(h),
                    hid, inv_keep, static_cast<uint32_t>(keep_q), seed1};
  err = ffma::launch_gemm(u, static_cast<const float*>(w1), M, hid, dim, fc1,
                          s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ffma::ResidualEpi fc2{static_cast<const float*>(b2), xf,
                              static_cast<float*>(y), dim, inv_keep,
                              static_cast<uint32_t>(keep_q), seed2};
  return static_cast<int>(ffma::launch_gemm(
      g, static_cast<const float*>(w2), M, dim, hid, fc2, s));
}

// Bytes of the scratch of one call (ops/fused_mlp.py mlp_f32_plan).
extern "C" long long nvt_fused_mlp_f32_scratch_bytes(int M, int dim,
                                                     int hid) {
  return static_cast<long long>(nvt::Scratch(M, dim, hid).bytes);
}
