// The rate of mma.sync's TF32 form on the card: every warp issues `chains`
// independent m16n8k8 MMAs (mma.sync.aligned.m16n8k8.row.col.f32.tf32.
// tf32.f32, the instruction of csrc/tf32x3.cuh) `iters` times on fixed
// operands, and scripts/torch_mma_tf32_peak.py divides their flops by the
// time. No shared memory, no loads: the tensor pipe alone.
#include <cuda_runtime.h>
#include <stdint.h>

template <int kChains>
__global__ void mma_tf32_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u ^ ((threadIdx.x + i) << 13);
  for (int i = 0; i < 2; ++i) b[i] = 0x3f000000u ^ ((threadIdx.x + i) << 13);
  float c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int h = 0; h < kChains; ++h)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[h][0]), "+f"(c[h][1]), "+f"(c[h][2]), "+f"(c[h][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int h = 0; h < kChains; ++h) s += c[h][0] + c[h][1] + c[h][2] + c[h][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// Launch blocks x threads with 4, 8 or 16 chains a warp; the launch's
// cudaError_t.
extern "C" int nvt_mma_tf32_loop(float* out, int blocks, int threads,
                                 int iters, int chains) {
  switch (chains) {
    case 4:
      mma_tf32_loop<4><<<blocks, threads>>>(out, iters);
      break;
    case 8:
      mma_tf32_loop<8><<<blocks, threads>>>(out, iters);
      break;
    case 16:
      mma_tf32_loop<16><<<blocks, threads>>>(out, iters);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
