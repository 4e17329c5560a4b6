// The row-quantize pass of the int8 kernels, one definition in two
// instances. K10 (int8_qkv.cu) and K12 (int8_mlp.cu) launch it with the
// LayerNorm (launch_ln_rowquant):
//   u = LN(x) * gamma + beta                 f32, not rounded
//   (u8, s_row) = rowquant(u)                per-row symmetric int8
// K11 (int8_outproj.cu) launches it without (launch_rowquant): u =
// float(x), the attention output's values. Each has a bf16 and an f32
// instance (the element type T of x), the f32 one for the int8 serving of
// an f32 ViT; they differ in their loads alone.
// The JAX kernels' order of operations (int8_serving.py:122-127, 158-159):
// mean, mean of squared deviations, rsqrt(var + eps), xhat * gamma + beta,
// each rounded; scale = amax / 127 (1 where amax is 0), code = rint(u /
// scale) clamped to +-127, an IEEE division.
//
// What bounds it on the H100: bytes, 3 per element of x (bf16 in, int8
// out); 16.4 MB at the flagship block at batch 8 (M = 8008, dim 1024),
// 0.005 ms at 3.35 TB/s; 5 per element (41 MB, 0.012 ms) at f32. One warp a row; the row is read again from L1 or
// L2 for each statistic and for the codes, so no row is held whole in
// registers and any dim is taken. Measured (NVIDIA H100 80GB HBM3, 700.00
// W; scripts/torch_int8_qkv_device_times.py and
// scripts/torch_int8_mlp_device_times.py, one run): 20.6 us at that shape
// inside K10, 18.2 inside K12, 57.1 at batch 32, 25.9 at dim 1280; with
// the sweeps rolled as the compiler chose, 22.0, 18.6, 59.6 and 27.9.
#include "int8.cuh"

namespace nvt {
namespace {

// Lane l takes columns 128 i + 4 l .. + 3 of each step i, so each load of
// x (8 bytes of bf16, 16 of f32), gamma and beta (16 bytes) is one
// contiguous run across the warp. Each sweep is unrolled by 8 (dim 1024 in one step), so a lane's
// loads of the row are in flight together. Without kLn, the two sweeps of
// the statistics go and gamma and beta are not read (null).
template <typename T, bool kLn>
__global__ void __launch_bounds__(kLnRowWarps * 32)
    rowquant_kernel(const T* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, int8_t* __restrict__ u8,
                    float* __restrict__ s_row, int M, int dim, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowWarps + threadIdx.x / 32;
  if (row >= M) return;
  const T* xr = x + static_cast<size_t>(row) * dim;
  auto load = [&](int c, float (&v)[4]) { load4(xr + c, v); };
  float mean = 0.f, rstd = 1.f;
  if constexpr (kLn) {
    float s = 0.f;
#pragma unroll 8
    for (int c = lane * 4; c < dim; c += 128) {
      float v[4];
      load(c, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) s += v[i];
    }
    mean = warp_sum(s) / dim;
    float ss = 0.f;
#pragma unroll 8
    for (int c = lane * 4; c < dim; c += 128) {
      float v[4];
      load(c, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = v[i] - mean;
        ss += d * d;
      }
    }
    rstd = rsqrtf(warp_sum(ss) / dim + eps);
  }
  // u = LN(x) * gamma + beta (kLn) or float(x) at columns c .. c + 3.
  auto u_at = [&](int c, float (&u)[4]) {
    load(c, u);
    if constexpr (kLn) {
      const float4 gm = *reinterpret_cast<const float4*>(gamma + c);
      const float4 bt = *reinterpret_cast<const float4*>(beta + c);
      const float g4[4] = {gm.x, gm.y, gm.z, gm.w};
      const float b4[4] = {bt.x, bt.y, bt.z, bt.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        u[i] = __fadd_rn(__fmul_rn(__fmul_rn(u[i] - mean, rstd), g4[i]),
                         b4[i]);
    }
  };
  float amax = 0.f;
#pragma unroll 8
  for (int c = lane * 4; c < dim; c += 128) {
    float u[4];
    u_at(c, u);
#pragma unroll
    for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(u[i]));
  }
  const float scale = quant_scale(warp_max(amax));
  int8_t* out = u8 + static_cast<size_t>(row) * dim;
#pragma unroll 8
  for (int c = lane * 4; c < dim; c += 128) {
    float u[4];
    u_at(c, u);
    int codes[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) codes[i] = quant_code(u[i], scale, -127.f);
    *reinterpret_cast<uint32_t*>(out + c) = pack4(codes);
  }
  if (lane == 0) s_row[row] = scale;
}

// The pass split for a tensor-parallel shard of a row (launch_row_amax,
// launch_rowquant_given): each row's amax of |float(x)| over the shard's
// columns, with rowquant_kernel's sweep; then the codes with the amax the
// caller maxed over the model group, the whole row's.
template <typename T>
__global__ void __launch_bounds__(kLnRowWarps * 32)
    row_amax_kernel(const T* __restrict__ x, float* __restrict__ amax, int M,
                    int dim) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowWarps + threadIdx.x / 32;
  if (row >= M) return;
  const T* xr = x + static_cast<size_t>(row) * dim;
  float m = 0.f;
#pragma unroll 8
  for (int c = lane * 4; c < dim; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) m = fmaxf(m, fabsf(v[i]));
  }
  m = warp_max(m);
  if (lane == 0) amax[row] = m;
}

template <typename T>
__global__ void __launch_bounds__(kLnRowWarps * 32)
    rowquant_given_kernel(const T* __restrict__ x,
                          const float* __restrict__ amax,
                          int8_t* __restrict__ x8, float* __restrict__ s_row,
                          int M, int dim) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowWarps + threadIdx.x / 32;
  if (row >= M) return;
  const T* xr = x + static_cast<size_t>(row) * dim;
  const float scale = quant_scale(amax[row]);
  int8_t* out = x8 + static_cast<size_t>(row) * dim;
#pragma unroll 8
  for (int c = lane * 4; c < dim; c += 128) {
    float u[4];
    load4(xr + c, u);
    int codes[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) codes[i] = quant_code(u[i], scale, -127.f);
    *reinterpret_cast<uint32_t*>(out + c) = pack4(codes);
  }
  if (lane == 0) s_row[row] = scale;
}

}  // namespace

template <typename T>
cudaError_t launch_row_amax(const T* x, float* amax, int M, int dim,
                            cudaStream_t stream) {
  row_amax_kernel<T><<<(M + kLnRowWarps - 1) / kLnRowWarps, kLnRowWarps * 32,
                       0, stream>>>(x, amax, M, dim);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rowquant_given(const T* x, const float* amax, int8_t* x8,
                                  float* s_row, int M, int dim,
                                  cudaStream_t stream) {
  rowquant_given_kernel<T><<<(M + kLnRowWarps - 1) / kLnRowWarps,
                             kLnRowWarps * 32, 0, stream>>>(x, amax, x8,
                                                            s_row, M, dim);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln_rowquant(const T* x, const float* gamma,
                               const float* beta, int8_t* u8, float* s_row,
                               int M, int dim, float eps,
                               cudaStream_t stream) {
  rowquant_kernel<T, true><<<(M + kLnRowWarps - 1) / kLnRowWarps,
                             kLnRowWarps * 32, 0, stream>>>(
      x, gamma, beta, u8, s_row, M, dim, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rowquant(const T* x, int8_t* x8, float* s_row, int M,
                            int dim, cudaStream_t stream) {
  rowquant_kernel<T, false><<<(M + kLnRowWarps - 1) / kLnRowWarps,
                              kLnRowWarps * 32, 0, stream>>>(
      x, nullptr, nullptr, x8, s_row, M, dim, 0.f);
  return cudaGetLastError();
}

template cudaError_t launch_ln_rowquant<bf16>(const bf16*, const float*,
                                              const float*, int8_t*, float*,
                                              int, int, float, cudaStream_t);
template cudaError_t launch_ln_rowquant<float>(const float*, const float*,
                                               const float*, int8_t*, float*,
                                               int, int, float, cudaStream_t);
template cudaError_t launch_rowquant<bf16>(const bf16*, int8_t*, float*, int,
                                           int, cudaStream_t);
template cudaError_t launch_rowquant<float>(const float*, int8_t*, float*,
                                            int, int, cudaStream_t);
template cudaError_t launch_row_amax<bf16>(const bf16*, float*, int, int,
                                           cudaStream_t);
template cudaError_t launch_row_amax<float>(const float*, float*, int, int,
                                            cudaStream_t);
template cudaError_t launch_rowquant_given<bf16>(const bf16*, const float*,
                                                 int8_t*, float*, int, int,
                                                 cudaStream_t);
template cudaError_t launch_rowquant_given<float>(const float*, const float*,
                                                  int8_t*, float*, int, int,
                                                  cudaStream_t);

}  // namespace nvt
