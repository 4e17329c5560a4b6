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
// (int8_mlp.cu, launch_fc2_residual): y = T((dequant + b) + x).
//
// Each pass that reads or writes activations has two instances, on the
// element type T of x (and of q, k, v or y): bf16, and f32 for the int8
// serving of an f32 ViT, where the TPU kernels write x.dtype
// (int8_serving.py:218, 244, 273, 363). The codes, the scales and the int32
// products are the same in both; only the loads of x and the stores of the
// outputs differ. The f32 instances' kernels carry T first among their
// template arguments, so their names read "<kernel>If..." in ptxas's
// report.
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

// Four consecutive elements of a row as f32: one 8-byte load of bf16, one
// 16-byte load of f32.
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x, v[1] = raw.y, v[2] = raw.z, v[3] = raw.w;
}

// Two consecutive elements as f32, and a pair stored rounded to the
// element type (bf16: round to nearest even; f32: as it is).
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// An element of V as f32.
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// Four int8 codes, one 4-byte store.
__device__ __forceinline__ uint32_t pack4(const int (&c)[4]) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    word |= (static_cast<uint32_t>(c[i]) & 0xFFu) << (8 * i);
  return word;
}

// Four values of p / s_p as s8 codes in one register, x0 in the lowest
// byte: each rounded half-even to an int and saturated to 127 (the values
// are >= 0) by cvt.pack.sat, which packs b into the low byte, a above it,
// and c's low 16 bits above those. K13's sweep 1 packs its codes so, both
// instances.
__device__ __forceinline__ uint32_t pack_s8x4(float x0, float x1, float x2,
                                              float x3) {
  uint32_t hi, w;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, 0;"
      : "=r"(hi)
      : "r"(__float2int_rn(x3)), "r"(__float2int_rn(x2)));
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;"
      : "=r"(w)
      : "r"(__float2int_rn(x1)), "r"(__float2int_rn(x0)), "r"(hi));
  return w;
}

// Rows (one warp each) a block of the LayerNorm row-quantize pass.
constexpr int kLnRowWarps = 8;

// (u8, s_row) = rowquant(LN(x) * gamma + beta) for x [M, dim] of T (bf16
// or float): u8 [M, dim] int8 and s_row [M] f32 in device memory, one warp
// a row, any dim that is a multiple of 4 (int8_rowquant.cu). Launched on
// stream by K10 and K12 alike; returns the launch's error.
template <typename T>
cudaError_t launch_ln_rowquant(const T* x, const float* gamma,
                               const float* beta, int8_t* u8, float* s_row,
                               int M, int dim, float eps, cudaStream_t stream);

// (x8, s_row) = rowquant(float(x)) for x [M, dim] of T, the same pass
// without the LayerNorm: x8 [M, dim] int8 and s_row [M] f32, one warp a
// row, any dim that is a multiple of 4. Launched on stream by K11; returns
// the launch's error.
template <typename T>
cudaError_t launch_rowquant(const T* x, int8_t* x8, float* s_row, int M,
                            int dim, cudaStream_t stream);

// The same pass split in two for a tensor-parallel shard of a row, whose
// scale is the amax over the whole row: launch_row_amax writes each row's
// amax of |float(x)| over the shard's columns (amax [M] f32, one warp a
// row); once the caller has maxed it over the model group,
// launch_rowquant_given takes the codes with that amax, which are the
// whole row's codes of these columns bit for bit.
template <typename T>
cudaError_t launch_row_amax(const T* x, float* amax, int M, int dim,
                            cudaStream_t stream);
template <typename T>
cudaError_t launch_rowquant_given(const T* x, const float* amax, int8_t* x8,
                                  float* s_row, int M, int dim,
                                  cudaStream_t stream);

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
//   y = T((float(a8 . Bt^T) * s_row * s_col + b) + x)
// for a8 [M, K] and Bt [N, K] int8 through the maps ta (boxes of kGemmRows
// rows) and tb (boxes of bn rows, bn 64 or 128); s_row [M], s_col and b
// [N] f32; x and y [M, N] of T (bf16 or float), N even. GemmLoop<bn> over
// (ceil(N / bn), ceil(M / kGemmRows)) tiles on the stream; the epilogue
// stores pairs of T from registers. allow_fc2_residual_smem<T>() opts both
// tile widths into their shared memory; call it before the first launch
// of a call. Each returns the CUDA error.
template <typename T>
cudaError_t allow_fc2_residual_smem();
template <typename T>
cudaError_t launch_fc2_residual(const CUtensorMap& ta, const CUtensorMap& tb,
                                const float* s_row, const float* s_col,
                                const float* b, const T* x, T* y, int M,
                                int N, int K, int bn, cudaStream_t stream);
// Its tensor-parallel form for a row-parallel shard (K the shard's share):
// the int32 accumulator acc [M, N] = a8 . Bt^T, written as it is, which the
// model group sums exactly; launch_dequant_residual then runs the pass's
// epilogue once on the sum, y = T((dequant(acc) + b) + x) with the row
// scale of the whole row's amax, one card's y bit for bit.
cudaError_t allow_fc2_acc_smem();
cudaError_t launch_fc2_acc(const CUtensorMap& ta, const CUtensorMap& tb,
                           int* acc, int M, int N, int K, int bn,
                           cudaStream_t stream);

// K13's prologue (int8_attention.cu) for V [B, N, H, D] of T (bf16 or
// float), D 64 or 128: s_v [B * H, D] at the head of the f32 stats (the
// per-channel amax over the keys below n_valid, / 127) and v8 [B * H, D,
// n_pad] int8 (n_pad = N rounded up to 64), each channel's codes of the
// key tiles of 64 that n_valid reaches, permuted within each group of 32
// keys as v8_key_order (ops/int8_serving.py) gives, 0 at keys at or past
// n_valid; two launches on the stream. The bf16 K13 and K13 at f32
// (int8_attention_f32.cu) both launch it; returns the CUDA error.
template <typename T, int D>
cudaError_t launch_v_prologue(const T* v, float* stats, int8_t* v8, int B,
                              int N, int H, int n_valid, cudaStream_t s);

// Whether K13 (either instance) takes [B, N, H, D]: D 64 or 128, the
// grid's x and v8's rows B * H * ceil(N / 64) and B * H * D below 2^31.
bool int8_attn_takes(int B, int N, int H, int D);

}  // namespace nvt
