// The ResNet stem's 3-D max-pool (k=3, s=2, p=1) with its argmax codes,
// and the gradient gathered back through those codes, bf16 and f32, NDHWC.
//
// Replaces the TPU kernels neurovit_tpu/ops/maxpool3d.py:62 (_fwd_kernel,
// launched at :155) and :188 (_bwd_kernel, launched at :236):
//
//   forward   out[b, od, oh, ow, c]  = max of the 3x3x3 window, -inf padded
//             code[b, od, oh, ow, c] = 9*kd + 3*kh + kw of its winner
//   backward  dx[b, d, h, w, c] = sum of g over the (<= 2x2x2) windows
//             whose code points at (d, h, w), summed in f32, rounded once
//
// The winner order is the TPU kernel's: at each (kh, kw) tap the depth
// combine runs first, the lowest kd keeping a tie; then the 9 taps follow
// in row-major order with strict '>', so the winner is the first (kh, kw)
// whose depth-max equals the window max. Values are compared in f32 and
// stored in the input dtype. Codes are stored as uint8 (0..26), a quarter
// of the TPU kernel's int32 bytes with the same values.
//
// What bounds it on the H100: bytes. The forward reads x once and writes
// out and the codes; the backward reads g and the codes and writes dx; no
// arithmetic worth counting. One thread per 8 channels of an output
// (forward) or input (backward) position, threads along C, which is
// contiguous in NDHWC: 64 channels are 128 bytes of bf16 per (d, h, w), so
// 8 threads cover them with 16-byte loads and a warp reads whole lines.
// The forward's 27 reads of a window and the backward's <= 8 reads of
// codes hit the same lines from neighbouring windows and are served from
// L1/L2; the backward reads g only where a code matches. The backward is a gather: each thread
// owns its dx element, so there are no atomics and the f32 sum is taken in
// increasing code order, as the plain version takes it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nvt {
namespace {

constexpr int kThreads = 256;

// A thread owns V consecutive channels of one position: V = 8 (16-byte
// bf16 loads and stores, 8-byte code loads) when C % 8 == 0, else 1.
// Threads of a block run along (w, channel group); blockIdx.y and
// blockIdx.z give h and (b, d), so no 64-bit index division is made.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (V == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x, v[2 * j + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}
template <int V>
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}
template <int V>
__device__ __forceinline__ void load_codes(const uint8_t* p, int* c) {
  if constexpr (V == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = (raw.x >> (8 * j)) & 0xff;
      c[j + 4] = (raw.y >> (8 * j)) & 0xff;
    }
  } else {
    c[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void store_codes(uint8_t* p, const int* c) {
  if constexpr (V == 8) {
    uint2 raw = make_uint2(0u, 0u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      raw.x |= static_cast<uint32_t>(c[j]) << (8 * j);
      raw.y |= static_cast<uint32_t>(c[j + 4]) << (8 * j);
    }
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    *p = static_cast<uint8_t>(c[0]);
  }
}

// jnp.maximum: NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__host__ __device__ __forceinline__ int out_dim(int n) {
  return (n + 2 - 3) / 2 + 1;
}

// Grid (ceil(OW * C / V / kThreads), OH, B * OD).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                       uint8_t* __restrict__ code, int D, int H, int W,
                       int C) {
  const int OD = out_dim(D), OH = out_dim(H), OW = out_dim(W);
  const int groups = C / V;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= OW * groups) return;
  const int ow = t / groups, c = (t % groups) * V;
  const int oh = blockIdx.y;
  const int b = blockIdx.z / OD, od = blockIdx.z % OD;
  const T* xb = x + static_cast<int64_t>(b) * D * H * W * C + c;
  float best[V];
  int best_code[V];
  for (int kh = 0; kh < 3; ++kh) {
    const int h = 2 * oh - 1 + kh;
    for (int kw = 0; kw < 3; ++kw) {
      const int w = 2 * ow - 1 + kw;
      // Depth combine at (h, w): the lowest kd keeps a tie; -inf outside.
      float v[V];
      int kd_win[V];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = -INFINITY, kd_win[j] = 0;
      if (h >= 0 && h < H && w >= 0 && w < W) {
        for (int kd = 0; kd < 3; ++kd) {
          const int d = 2 * od - 1 + kd;
          if (d < 0 || d >= D) continue;    // a -inf row changes nothing
          float row[V];
          load_f32<V>(xb + ((static_cast<int64_t>(d) * H + h) * W + w) * C,
                      row);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            if (kd == 0) {
              v[j] = row[j];
            } else {
              if (row[j] > v[j]) kd_win[j] = kd;
              v[j] = nan_max(v[j], row[j]);
            }
          }
        }
      }
      const int tap = 3 * kh + kw;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int tap_code = 9 * kd_win[j] + tap;
        if (tap == 0) {
          best[j] = v[j];
          best_code[j] = tap_code;
        } else {
          if (v[j] > best[j]) best_code[j] = tap_code;
          best[j] = nan_max(best[j], v[j]);
        }
      }
    }
  }
  const int64_t o =
      ((static_cast<int64_t>(blockIdx.z) * OH + oh) * OW + ow) * C + c;
  store_f32<V>(out + o, best);
  store_codes<V>(code + o, best_code);
}

// Along one axis, input p is covered by window o at offset k = p + 1 - 2o:
// even p by k = 1 only, odd p by k = 0 (o = (p+1)/2) and k = 2
// (o = (p-1)/2). Listed in increasing k; a window past the edge is -1.
__device__ __forceinline__ void cover(int p, int n_out, int* o, int* k) {
  if ((p & 1) == 0) {
    o[0] = p / 2;
    k[0] = 1;
    o[1] = -1;
    k[1] = 3;
  } else {
    o[0] = (p + 1) / 2 < n_out ? (p + 1) / 2 : -1;
    k[0] = 0;
    o[1] = (p - 1) / 2;
    k[1] = 2;
  }
}

// Grid (ceil(W * C / V / kThreads), H, B * D).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    maxpool_bwd_kernel(const uint8_t* __restrict__ code,
                       const T* __restrict__ g, T* __restrict__ dx, int D,
                       int H, int W, int C) {
  const int OD = out_dim(D), OH = out_dim(H), OW = out_dim(W);
  const int groups = C / V;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= W * groups) return;
  const int w = t / groups, c = (t % groups) * V;
  const int h = blockIdx.y;
  const int b = blockIdx.z / D, d = blockIdx.z % D;
  int od[2], kd[2], oh[2], kh[2], ow[2], kw[2];
  cover(d, OD, od, kd);
  cover(h, OH, oh, kh);
  cover(w, OW, ow, kw);
  // The candidates in increasing code order, summed in f32.
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  for (int a = 0; a < 2; ++a) {
    if (od[a] < 0) continue;
    for (int e = 0; e < 2; ++e) {
      if (oh[e] < 0) continue;
      for (int f = 0; f < 2; ++f) {
        if (ow[f] < 0) continue;
        const int64_t o = (((static_cast<int64_t>(b) * OD + od[a]) * OH +
                            oh[e]) * OW + ow[f]) * C + c;
        const int k = 9 * kd[a] + 3 * kh[e] + kw[f];
        int cs[V];
        load_codes<V>(code + o, cs);
        bool any = false;
#pragma unroll
        for (int j = 0; j < V; ++j) any |= cs[j] == k;
        if (!any) continue;
        float gv[V];
        load_f32<V>(g + o, gv);
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (cs[j] == k) acc[j] += gv[j];
      }
    }
  }
  store_f32<V>(dx + ((static_cast<int64_t>(blockIdx.z) * H + h) * W + w) * C +
                   c,
               acc);
}

template <typename T, int V>
int launch_fwd(const void* x, void* out, void* code, int B, int D, int H,
               int W, int C, void* stream) {
  const int per_row = out_dim(W) * (C / V);
  const dim3 grid((per_row + kThreads - 1) / kThreads, out_dim(H),
                  B * out_dim(D));
  maxpool_fwd_kernel<T, V><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<uint8_t*>(code), D, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_bwd(const void* code, const void* g, void* dx, int B, int D,
               int H, int W, int C, void* stream) {
  const int per_row = W * (C / V);
  const dim3 grid((per_row + kThreads - 1) / kThreads, H, B * D);
  maxpool_bwd_kernel<T, V><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(code), static_cast<const T*>(g),
      static_cast<T*>(dx), D, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd(const void* x, void* out, void* code, int B, int D, int H, int W,
        int C, void* stream) {
  return C % 8 == 0 ? launch_fwd<T, 8>(x, out, code, B, D, H, W, C, stream)
                    : launch_fwd<T, 1>(x, out, code, B, D, H, W, C, stream);
}

template <typename T>
int bwd(const void* code, const void* g, void* dx, int B, int D, int H,
        int W, int C, void* stream) {
  return C % 8 == 0 ? launch_bwd<T, 8>(code, g, dx, B, D, H, W, C, stream)
                    : launch_bwd<T, 1>(code, g, dx, B, D, H, W, C, stream);
}

// The grid's y and z dimensions hold at most 65535 blocks.
bool bad_shape(int B, int D, int H, int W, int C) {
  return B < 1 || D < 1 || H < 1 || W < 1 || C < 1 || H > 65535 ||
         static_cast<int64_t>(B) * D > 65535;
}

}  // namespace
}  // namespace nvt

// x [B, D, H, W, C]; out [B, OD, OH, OW, C] of x's dtype, code the same
// shape in uint8; O = (n - 1) / 2 + 1. is_bf16: bf16, else f32.
extern "C" int nvt_maxpool3d_fwd(const void* x, void* out, void* code,
                                 int B, int D, int H, int W, int C,
                                 int is_bf16, void* stream) {
  if (nvt::bad_shape(B, D, H, W, C))
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? nvt::fwd<__nv_bfloat16>(x, out, code, B, D, H, W, C,
                                           stream)
                 : nvt::fwd<float>(x, out, code, B, D, H, W, C, stream);
}

// code [B, OD, OH, OW, C] uint8 and g of that shape; dx [B, D, H, W, C] of
// g's dtype.
extern "C" int nvt_maxpool3d_bwd(const void* code, const void* g, void* dx,
                                 int B, int D, int H, int W, int C,
                                 int is_bf16, void* stream) {
  if (nvt::bad_shape(B, D, H, W, C))
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? nvt::bwd<__nv_bfloat16>(code, g, dx, B, D, H, W, C,
                                           stream)
                 : nvt::bwd<float>(code, g, dx, B, D, H, W, C, stream);
}
