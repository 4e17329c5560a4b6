// LayerNorm + per-row int8 quantization + int8 QKV projection (K10), on
// TMA + wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/int8_serving.py:154
// (_qkv_kernel, launched at :209 by int8_ln_qkv):
//   u = LN(x) * gamma + beta                 f32, NOT rounded to bf16
//   (u8, s_row) = rowquant(u)                per-row symmetric int8
//   [q | k | v] = T(float(u8 . W8^T) * s_row * s_col)
// T is x's type: bf16, or f32 in the f32 instance (nvt_int8_ln_qkv_f32,
// int8 serving of an f32 ViT), whose row pass reads f32 x and whose GEMM
// writes f32 q, k and v; otherwise its passes, scratch and shared memory
// are the bf16 instance's.
// W8 is the torch-layout int8 weight [3*inner, dim] (rows ordered (3,
// heads, dim_head)) with per-output-channel scales s_col [3*inner], so q,
// k and v each come out [M, inner] and view as [B, N, H, D]. W8 is K-major
// as it lies, so wgmma reads it with no transpose.
//
// What bounds it on the H100: 6 M dim inner int8 operations (0.0127 ms at
// 1,979 TOP/s for the flagship block at batch 8: M = 8008, dim 1024, inner
// 512). This design also moves about 59 MB (x 16.4, the codes written and
// read 16.4, q, k and v 24.6, W8 1.6): 0.018 ms at 3.35 TB/s. At f32 the
// bytes bound it: x 32.8 MB in and q, k and v 49.2 MB out, 0.0245 ms; this
// design moves about 99 MB (0.030 ms).
//
// Why two launches. The TPU kernel holds a 512-row block and all of W8 in
// VMEM, and quantizes each row before one [512, dim] x [dim, 3 inner] dot.
// On the card the column tiles of a row block are different blocks, and
// every one of them needs the row's scale, the amax of the whole f32 u row,
// before its first code. So the row quantization is a pass of its own:
//   1. ln_rowquant (int8_rowquant.cu, K12's pass 1 too): x -> u8 [M, dim],
//      s_row [M]; one warp a row, any dim.
//   2. qkv_gemm: hopper_gemm.cuh Mainloop<true, 128, BN, 3> over (3
//      ceil(inner / BN), ceil(M / 128)) tiles, A = u8, Bt = W8. Column tile
//      j serves output which = j / ceil(inner / BN) at its columns c0 = (j
//      mod ceil(inner / BN)) BN, from W8's rows which inner + c0 on, so a
//      tile never straddles q, k and v and each block writes one tensor.
//      The epilogue dequantizes each accumulator pair and stores it as a
//      pair of T from registers, masking the rows past M and the columns
//      past inner (where inner is not a multiple of BN, the last tile of a
//      section reads rows of the next; TMA zero-fills past 3 inner).
// BN is 128, or 64 where 128-wide tiles would give the card fewer blocks
// than its 132 SMs (batch 1 of the flagship). Three stages (97 KiB of ring
// at BN = 128) let two GEMM blocks share an SM, so one block's epilogue
// runs under the other's mainloop. Widths are multiples of 16 (TMA's
// 16-byte rows), of any size: no row is held whole in registers or shared
// memory.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; profiler device times from
// scripts/torch_int8_qkv_device_times.py, three runs): at batch 8 the two
// passes take 0.0588-0.0607 ms, ln_rowquant 20.4-20.6 us (22.0-22.1 before
// its sweeps were unrolled) and qkv_gemm 37.7-38.7, where K17 int8's GEMM
// kernel alone takes 39.9-40.1 us at the same [8016, 1024] x [1024, 1536]
// and torch._int_mm 211-213; at batch 32 0.1906-0.1909 ms. The single wmma
// kernel this replaces took 0.2395-0.2410 ms (0.7335-0.7347 at batch 32). Staging the output tile in the ring and
// storing it by TMA, as K4's fc1 does, took qkv_gemm 39.4 us at batch 8
// and 155.4 at batch 32 against 37.7 and 131.0 in the same run: the
// register stores of one block run under the other block's mainloop.
// The f32 instance (chip_smoke.py's f32 phase (g), two runs): 0.1344-
// 0.1483 ms by one-call events at batch 8.
//
// Rounding points are the JAX kernel's and the plain version's: LN's mean
// and mean of squared deviations in f32, rsqrt(var + eps), xhat * gamma +
// beta; scale = amax / 127 (1 where amax is 0); code = rint(u / scale)
// clamped to +-127, an IEEE division; dequant (float(acc) * s_row) * s_col,
// each product rounded (no contraction), then T.
#include "hopper_gemm.cuh"
#include "int8.cuh"

namespace nvt {
namespace {

constexpr int kBM = kGemmRows;           // the GEMM's output tile rows
template <int BN>
using Loop = GemmLoop<BN>;

// The GEMM's output tile columns over the [M, 3 inner] output
// (gemm_tile_n, int8.cuh).
int tile_n(int M, int inner) { return gemm_tile_n(M, 3 * inner); }

// Scratch of one call, one allocation: u8 [M, dim] then s_row [M] f32,
// each on a 256-byte boundary.
struct Scratch {
  size_t u8, s_row, bytes;
  Scratch(int M, int dim) {
    const size_t m = static_cast<size_t>(M);
    u8 = 0;
    s_row = round_up(m * dim, 256);
    bytes = round_up(s_row + m * sizeof(float), 256);
  }
};

// Pass 2: [q | k | v] = T(dequant(u8 . W8^T)). The thread's accumulator
// pairs lie as wgmma's m64nN layout puts them (hopper_gemm.cuh, Wgmma):
// rows r0 and r0 + 8, columns 8 j + 2 (t % 4) and + 1.
template <typename T, int BN>
__global__ void __launch_bounds__(Loop<BN>::kThreads)
    qkv_gemm_kernel(const __grid_constant__ CUtensorMap tu8,
                    const __grid_constant__ CUtensorMap tw8,
                    const float* __restrict__ s_row,
                    const float* __restrict__ s_col, T* __restrict__ q,
                    T* __restrict__ k, T* __restrict__ v, int M, int dim,
                    int inner) {
  extern __shared__ unsigned char smem[];
  const int tiles = (inner + BN - 1) / BN;   // column tiles of a section
  const int which = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * BN;
  const int n0 = which * inner + c0;         // W8's first row
  const int m0 = blockIdx.y * kBM;
  int acc[Loop<BN>::kAccRegs];
  if (!Loop<BN>::run(&tu8, &tw8, m0, n0, dim, smem, acc)) return;
  T* out = which == 0 ? q : (which == 1 ? k : v);
  const int t = threadIdx.x % 128;
  const int r0 = (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + r0 + 8 * half;
    if (row >= M) continue;
    const float s = s_row[row];
    T* orow = out + static_cast<size_t>(row) * inner;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j + cq;
      if (col >= inner) continue;   // inner is even: col + 1 < inner too
      const float2 sc =
          *reinterpret_cast<const float2*>(s_col + which * inner + col);
      store2(orow + col, dequant(acc[4 * j + 2 * half], s, sc.x),
             dequant(acc[4 * j + 2 * half + 1], s, sc.y));
    }
  }
}

template <typename T, int BN>
void launch_gemm(const CUtensorMap& tu8, const CUtensorMap& tw8,
                 const float* s_row, const float* s_col, T* q, T* k, T* v,
                 int M, int dim, int inner, cudaStream_t stream) {
  const dim3 grid(3 * ((inner + BN - 1) / BN), (M + kBM - 1) / kBM);
  qkv_gemm_kernel<T, BN><<<grid, Loop<BN>::kThreads, Loop<BN>::kSmemBytes,
                           stream>>>(tu8, tw8, s_row, s_col, q, k, v, M, dim,
                                     inner);
}

template <typename T>
cudaError_t launch_all(const T* x, const float* gamma, const float* beta,
                       const int8_t* w8, const float* s_col, T* q, T* k,
                       T* v, unsigned char* scratch, int M, int dim,
                       int inner, float eps, cudaStream_t stream) {
  const Scratch at(M, dim);
  int8_t* u8 = reinterpret_cast<int8_t*>(scratch + at.u8);
  float* s_row = reinterpret_cast<float*>(scratch + at.s_row);
  const int bn = tile_n(M, inner);
  // Every map is encoded, and both instances allowed their shared memory,
  // before the first launch: a failure leaves nothing half done.
  CUtensorMap tu8, tw8;
  cudaError_t err = hopper::encode_kmajor(&tu8, u8, M, dim, true, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw8, w8, 3 * inner, dim, true, bn);
  if (err == cudaSuccess)
    err = allow_smem(qkv_gemm_kernel<T, 64>, Loop<64>::kSmemBytes);
  if (err == cudaSuccess)
    err = allow_smem(qkv_gemm_kernel<T, 128>, Loop<128>::kSmemBytes);
  if (err != cudaSuccess) return err;

  err = launch_ln_rowquant(x, gamma, beta, u8, s_row, M, dim, eps, stream);
  if (err != cudaSuccess) return err;
  (bn == 64 ? launch_gemm<T, 64> : launch_gemm<T, 128>)(
      tu8, tw8, s_row, s_col, q, k, v, M, dim, inner, stream);
  return cudaGetLastError();
}

template <typename T>
int entry(const void* x, const void* gamma, const void* beta, const void* w8,
          const void* s_col, void* q, void* k, void* v, void* scratch, int M,
          int dim, int inner, float eps, void* stream) {
  if (M < 1 || dim < 16 || dim % 16 != 0 || inner < 16 || inner % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all<T>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const int8_t*>(w8),
      static_cast<const float*>(s_col), static_cast<T*>(q),
      static_cast<T*>(k), static_cast<T*>(v),
      static_cast<unsigned char*>(scratch), M, dim, inner, eps,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace
}  // namespace nvt

// x [M, dim] bf16; gamma, beta [dim] f32; w8 [3*inner, dim] int8; s_col
// [3*inner] f32; q, k, v [M, inner] bf16; scratch
// nvt_int8_qkv_scratch_bytes(M, dim, inner) bytes, 256-byte aligned. dim
// and inner are multiples of 16 (TMA's 16-byte rows), of any size.
extern "C" int nvt_int8_ln_qkv(const void* x, const void* gamma,
                               const void* beta, const void* w8,
                               const void* s_col, void* q, void* k, void* v,
                               void* scratch, int M, int dim, int inner,
                               float eps, void* stream) {
  return nvt::entry<nvt::bf16>(x, gamma, beta, w8, s_col, q, k, v, scratch,
                               M, dim, inner, eps, stream);
}

// The f32 instance: x, q, k and v f32, every other operand and the scratch
// as nvt_int8_ln_qkv's.
extern "C" int nvt_int8_ln_qkv_f32(const void* x, const void* gamma,
                                   const void* beta, const void* w8,
                                   const void* s_col, void* q, void* k,
                                   void* v, void* scratch, int M, int dim,
                                   int inner, float eps, void* stream) {
  return nvt::entry<float>(x, gamma, beta, w8, s_col, q, k, v, scratch, M,
                           dim, inner, eps, stream);
}

// Bytes of the scratch one call takes (ops/int8_serving.py, qkv_plan).
extern "C" long long nvt_int8_qkv_scratch_bytes(int M, int dim, int inner) {
  (void)inner;
  return static_cast<long long>(nvt::Scratch(M, dim).bytes);
}

// Dynamic shared memory of a block of the GEMM pass for M rows at inner,
// which follows its tile's width.
extern "C" long long nvt_int8_qkv_smem_bytes(int M, int inner) {
  return static_cast<long long>(
      nvt::gemm_smem_bytes(nvt::tile_n(M, inner)));
}
