// Shared device code of the int8 serving kernels (K10-K13).
//
// The scheme is the JAX package's (neurovit_tpu/ops/int8_serving.py:13-22):
// weights are int8 per output channel, quantized once on the host;
// activations are quantized per row inside the kernel, symmetric,
//   scale = amax > 0 ? amax / 127 : 1,  code = clamp(rint(u / scale), +-127)
// (rint is round-half-even, like jnp.round); the products are exact int32
// sums, dequantized as float(acc) * s_row * s_col in f32.
//
// K10, K11 and K12 share one row-quantize pass (int8_rowquant.cu): with the
// LayerNorm for K10 and K12 (launch_ln_rowquant), without it for K11
// (launch_rowquant). It writes the codes to device memory for their TMA +
// wgmma GEMMs. K11 and K12 share one GEMM pass too, K12's fc2_residual
// (int8_mlp.cu, launch_fc2_residual): y = bf16((dequant + b) + x).
#pragma once

#include "hopper_gemm.cuh"

namespace nvt {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The symmetric scale of a row (or channel) whose largest magnitude is amax.
__device__ __forceinline__ float quant_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}

// round(u / scale) clamped to [lo, 127]; IEEE division, half-even rounding.
__device__ __forceinline__ int quant_code(float u, float scale, float lo) {
  return static_cast<int>(
      fminf(fmaxf(rintf(__fdiv_rn(u, scale)), lo), 127.f));
}

// float(acc) * s_row * s_col, rounded after each product (no contraction).
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col);
}

// Four int8 codes, one 4-byte store.
__device__ __forceinline__ uint32_t pack4(const int (&c)[4]) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    word |= (static_cast<uint32_t>(c[i]) & 0xFFu) << (8 * i);
  return word;
}

// Rows (one warp each) a block of the LayerNorm row-quantize pass.
constexpr int kLnRowWarps = 8;

// (u8, s_row) = rowquant(LN(x) * gamma + beta) for x [M, dim] bf16: u8
// [M, dim] int8 and s_row [M] f32 in device memory, one warp a row, any
// dim that is a multiple of 4 (int8_rowquant.cu). Launched on stream by K10
// and K12 alike; returns the launch's error.
cudaError_t launch_ln_rowquant(const bf16* x, const float* gamma,
                               const float* beta, int8_t* u8, float* s_row,
                               int M, int dim, float eps, cudaStream_t stream);

// (x8, s_row) = rowquant(float(x)) for x [M, dim] bf16, the same pass
// without the LayerNorm: x8 [M, dim] int8 and s_row [M] f32, one warp a
// row, any dim that is a multiple of 4. Launched on stream by K11; returns
// the launch's error.
cudaError_t launch_rowquant(const bf16* x, int8_t* x8, float* s_row, int M,
                            int dim, cudaStream_t stream);

// The GEMM passes' output tile rows and ring stages: three, so two GEMM
// blocks share an SM and one block's epilogue runs under the other's
// mainloop.
constexpr int kGemmRows = 128, kGemmStages = 3;
template <int BN>
using GemmLoop = hopper::Mainloop<true, kGemmRows, BN, kGemmStages>;

// The output tile's columns of a GEMM pass with an [M, N] output: 128, or
// 64 where 128-wide tiles would give the card fewer blocks than its 132
// SMs (the rule of K4's passes, fused_mlp.cuh tile_n).
inline int gemm_tile_n(int M, int N) {
  return ((N + 127) / 128) * ((M + kGemmRows - 1) / kGemmRows) < 132 ? 64
                                                                    : 128;
}

// Dynamic shared memory of a GEMM block whose tile is bn columns wide.
inline size_t gemm_smem_bytes(int bn) {
  return bn == 64 ? GemmLoop<64>::kSmemBytes : GemmLoop<128>::kSmemBytes;
}

// K12's pass 4, which K11 launches too (int8_mlp.cu):
//   y = bf16((float(a8 . Bt^T) * s_row * s_col + b) + x)
// for a8 [M, K] and Bt [N, K] int8 through the maps ta (boxes of kGemmRows
// rows) and tb (boxes of bn rows, bn 64 or 128); s_row [M], s_col and b
// [N] f32; x and y [M, N] bf16, N even. GemmLoop<bn> over (ceil(N / bn),
// ceil(M / kGemmRows)) tiles on the stream; the epilogue stores bf16
// pairs from registers. allow_fc2_residual_smem() opts both instances into
// their shared memory; call it before the first launch of a call. Each
// returns the CUDA error.
cudaError_t allow_fc2_residual_smem();
cudaError_t launch_fc2_residual(const CUtensorMap& ta, const CUtensorMap& tb,
                                const float* s_row, const float* s_col,
                                const float* b, const bf16* x, bf16* y, int M,
                                int N, int K, int bn, cudaStream_t stream);

}  // namespace nvt
