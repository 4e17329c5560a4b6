// int8 residual MLP block (K12), serving only, on TMA + wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/int8_serving.py:173
// (_mlp_kernel, launched at :263 by int8_mlp_block):
//   u = LN(x) * gamma + beta                 f32, not rounded
//   (u8, s1_row) = rowquant(u)
//   h = float(u8 . W1^T) * s1_row * s1_col + b1     f32, not rounded
//   g = GELU(h)                              exact-erf GELU in f32
//   (g8, s2_row) = rowquant(g)               amax over the whole hid row
//   z = float(g8 . W2^T) * s2_row * s2_col + b2
//   y = T(z + x)                             T: x's type, bf16 or f32
// W1 [hid, dim] and W2 [dim, hid] are torch-layout int8 weights with
// per-output-channel scales s1_col [hid] and s2_col [dim]. Both are
// K-major as they lie, so wgmma reads them with no transpose.
//
// What bounds it on the H100: 4 M dim hid int8 operations (0.034 ms at
// 1,979 TOP/s for the flagship block at batch 8, M = 8008, dim 1024, hid
// 2048), and, in this design, the bytes of g's round trip through device
// memory: 8 bytes per hidden element written and read (131 MB at that
// shape, 0.039 ms at 3.35 TB/s) beside x, y and the codes.
//
// Why four launches. g must be quantized with the amax of its whole hid
// row, which spans hid / 128 column tiles of fc1; on Hopper those tiles
// are different blocks, and the f32 g of a row block does not fit in
// shared memory beside the GEMM ring. So the row's amax is a second,
// exact pass, with no atomics (the max does not depend on order, so every
// code is deterministic):
//   1. ln_rowquant: x -> u8 [M, dim], s1_row [M]; one warp per row, the
//      row read from L1/L2 once for each statistic, so any dim is taken.
//      The pass is K10's too (launch_ln_rowquant, int8_rowquant.cu).
//   2. fc1: hopper_gemm.cuh Mainloop<true, 128, 128, 3> over ceil(M / 128) x
//      ceil(hid / 128) tiles, A = u8, Bt = W1. The epilogue dequantizes,
//      adds b1, takes GELU, writes g f32 [M, hid] in 8-byte pairs and the
//      amax of |g| over the tile's 128 columns of each row into gmax [M,
//      ceil(hid / 128)] (a quad's shuffle, no atomics).
//   3. g_rowquant: s2_row from gmax's row, then g -> g8 [M, hid] reading
//      g once; one warp per row, any hid.
//   4. fc2: the same mainloop over ceil(M / 128) x ceil(dim / 128)
//      tiles, A = g8, Bt = W2; the epilogue is y = T((dequant + b2) + x),
//      K18's dequant epilogue with the bias and the residual. K11
//      (int8_outproj.cu) launches the same pass on its own codes
//      (launch_fc2_residual, int8.cuh).
// TMA zero-fills the boxes past M, dim and hid, so ragged edges need no
// masked loads; the epilogues mask rows >= M and columns past N. A split
// that keeps g in L2 (a persistent fc1 walking a row block's column
// tiles, or pass 3 folded into fc2's producer) is later work.
//
// The f32 instance (nvt_int8_mlp_f32, int8 serving of an f32 ViT) runs the
// same four passes: pass 1 reads f32 x (16-byte loads), passes 2 and 3 are
// the same kernels (g is f32 in both), and pass 4 reads f32 x and writes
// f32 y as 8-byte pairs from registers. No pass stages x or y in shared
// memory, so the scratch and the shared memory are the bf16 instance's.
// Its bound at the flagship block is the bf16 one's, 0.034 ms of int8
// operations; its x and y move 65.6 MB (0.020 ms).
//
// Rounding points are the JAX kernel's and the plain version's: LN's mean
// and mean of squared deviations in f32, rsqrt(var + eps), xhat * gamma +
// beta; scale = amax / 127 (1 where amax is 0); code = rint(v / scale)
// clamped to +-127, an IEEE division; dequant (float(acc) * s_row) *
// s_col then + b, each rounded (no contraction).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; profiler device times from
// scripts/torch_int8_mlp_device_times.py, two runs): at batch 8 the four
// passes take 0.1717-0.1735 ms, ln_rowquant 18.6-18.7 us, fc1 68.8-69.5,
// g_rowquant 29.7-30.1, fc2 54.6-55.2; K17 int8's GEMM kernel alone takes
// 49.3-49.7 us at fc1's shape and 35.1-38.4 at fc2's. The single wmma
// kernel this replaces took 0.7149 ms by one-call events. With a 4-stage
// ring (one GEMM block an SM) fc1 and fc2 took 88.8-91.4 and 65.9-68.1
// us; with 8-column lane chunks in the row passes and scalar gamma / beta
// loads, pass 1 took 39.4-40.7 and pass 3 36.9-37.8. The f32 instance
// (chip_smoke.py's f32 phase (g), two runs): 0.2664-0.2750 ms by one-call
// events at batch 8.
#include "hopper_gemm.cuh"
#include "int8.cuh"

namespace nvt {
namespace {

constexpr int kRowWarps = kLnRowWarps;   // rows a block of passes 1 and 3
// The GEMMs' output tile, 128 x 128. Three stages (97 KiB of ring) let two
// GEMM blocks share an SM, so one block's epilogue runs under the other's
// mainloop.
constexpr int kBM = kGemmRows, kBN = 128;
using Loop = GemmLoop<kBN>;

// Scratch of one call, one allocation: g first (f32, the largest), then
// u8, g8, gmax and the two row-scale vectors, each on a 256-byte boundary.
struct Scratch {
  size_t g, u8, g8, gmax, s1_row, s2_row, bytes;
  Scratch(int M, int dim, int hid) {
    const size_t m = static_cast<size_t>(M);
    const size_t tiles = static_cast<size_t>((hid + kBN - 1) / kBN);
    size_t at = 0;
    auto take = [&](size_t n) {
      const size_t here = at;
      at = round_up(at + n, 256);
      return here;
    };
    g = take(m * hid * sizeof(float));
    u8 = take(m * dim);
    g8 = take(m * hid);
    gmax = take(m * tiles * sizeof(float));
    s1_row = take(m * sizeof(float));
    s2_row = take(m * sizeof(float));
    bytes = at;
  }
};

// Pass 2: g = GELU(dequant(u8 . W1^T) + b1) and each row's amax of |g| over
// the tile's columns. The thread's accumulator pairs lie as wgmma's m64nN
// layout puts them (hopper_gemm.cuh, Wgmma): rows r0 and r0 + 8, columns
// 8 j + c0 and + 1; the four threads of a quad hold a row's 128 columns.
__global__ void __launch_bounds__(Loop::kThreads)
    fc1_gelu_kernel(const __grid_constant__ CUtensorMap tu8,
                    const __grid_constant__ CUtensorMap tw1,
                    const float* __restrict__ s1_row,
                    const float* __restrict__ s1_col,
                    const float* __restrict__ b1, float* __restrict__ g,
                    float* __restrict__ gmax, int M, int dim, int hid) {
  extern __shared__ unsigned char smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  int acc[Loop::kAccRegs];
  if (!Loop::run(&tu8, &tw1, m0, n0, dim, smem, acc)) return;
  const int t = threadIdx.x % 128;
  const int r0 = (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int c0 = 2 * (t % 4);
  const int tiles = gridDim.x;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + r0 + 8 * half;
    float m = 0.f;
    if (row < M) {
      const float s = s1_row[row];
      float* grow = g + static_cast<size_t>(row) * hid;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + c0;
        if (col >= hid) continue;   // hid is even: col + 1 < hid too
        const float2 sc = *reinterpret_cast<const float2*>(s1_col + col);
        const float2 bc = *reinterpret_cast<const float2*>(b1 + col);
        const float g0 = gelu_erf(
            __fadd_rn(dequant(acc[4 * j + 2 * half], s, sc.x), bc.x));
        const float g1 = gelu_erf(
            __fadd_rn(dequant(acc[4 * j + 2 * half + 1], s, sc.y), bc.y));
        *reinterpret_cast<float2*>(grow + col) = make_float2(g0, g1);
        m = fmaxf(m, fmaxf(fabsf(g0), fabsf(g1)));
      }
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    if (row < M && t % 4 == 0)
      gmax[static_cast<size_t>(row) * tiles + blockIdx.x] = m;
  }
}

// Pass 3: (g8, s2_row) = rowquant(g), the amax from gmax's row, g read once
// (lane l takes columns 128 i + 4 l .. + 3, one 16-byte load each).
__global__ void __launch_bounds__(kRowWarps * 32)
    g_rowquant_kernel(const float* __restrict__ g,
                      const float* __restrict__ gmax, int8_t* __restrict__ g8,
                      float* __restrict__ s2_row, int M, int hid, int tiles) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= M) return;
  float amax = 0.f;
  for (int i = lane; i < tiles; i += 32)
    amax = fmaxf(amax, gmax[static_cast<size_t>(row) * tiles + i]);
  const float scale = quant_scale(warp_max(amax));
  const float* grow = g + static_cast<size_t>(row) * hid;
  int8_t* out = g8 + static_cast<size_t>(row) * hid;
#pragma unroll 4
  for (int c = lane * 4; c < hid; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(grow + c);
    const int codes[4] = {quant_code(v.x, scale, -127.f),
                          quant_code(v.y, scale, -127.f),
                          quant_code(v.z, scale, -127.f),
                          quant_code(v.w, scale, -127.f)};
    *reinterpret_cast<uint32_t*>(out + c) = pack4(codes);
  }
  if (lane == 0) s2_row[row] = scale;
}

// The tensor-parallel split of pass 3 for a shard of the hidden columns:
// each row's amax over the shard's fc1 tiles (gmax_rows), then, once the
// caller has maxed it over the model group, the codes with that amax, the
// whole hid row's (g_rowquant_given).
__global__ void __launch_bounds__(kRowWarps * 32)
    gmax_rows_kernel(const float* __restrict__ gmax, float* __restrict__ amax,
                     int M, int tiles) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= M) return;
  float m = 0.f;
  for (int i = lane; i < tiles; i += 32)
    m = fmaxf(m, gmax[static_cast<size_t>(row) * tiles + i]);
  m = warp_max(m);
  if (lane == 0) amax[row] = m;
}

__global__ void __launch_bounds__(kRowWarps * 32)
    g_rowquant_given_kernel(const float* __restrict__ g,
                            const float* __restrict__ amax,
                            int8_t* __restrict__ g8,
                            float* __restrict__ s2_row, int M, int hid) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= M) return;
  const float scale = quant_scale(amax[row]);
  const float* grow = g + static_cast<size_t>(row) * hid;
  int8_t* out = g8 + static_cast<size_t>(row) * hid;
#pragma unroll 4
  for (int c = lane * 4; c < hid; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(grow + c);
    const int codes[4] = {quant_code(v.x, scale, -127.f),
                          quant_code(v.y, scale, -127.f),
                          quant_code(v.z, scale, -127.f),
                          quant_code(v.w, scale, -127.f)};
    *reinterpret_cast<uint32_t*>(out + c) = pack4(codes);
  }
  if (lane == 0) s2_row[row] = scale;
}

// Pass 4: y = T((dequant(g8 . W2^T) + b2) + x), BN columns a tile; K11
// launches it too, with A = its codes of a and Bt = its W8.
template <typename T, int BN>
__global__ void __launch_bounds__(GemmLoop<BN>::kThreads)
    fc2_residual_kernel(const __grid_constant__ CUtensorMap tg8,
                        const __grid_constant__ CUtensorMap tw2,
                        const float* __restrict__ s2_row,
                        const float* __restrict__ s2_col,
                        const float* __restrict__ b2,
                        const T* __restrict__ x, T* __restrict__ y,
                        int M, int dim, int hid) {
  extern __shared__ unsigned char smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  int acc[GemmLoop<BN>::kAccRegs];
  if (!GemmLoop<BN>::run(&tg8, &tw2, m0, n0, hid, smem, acc)) return;
  GemmLoop<BN>::for_each_pair(acc, [&](int r, int c, int v0, int v1) {
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= dim) return;   // dim is even: col + 1 < dim too
    const size_t at = static_cast<size_t>(row) * dim + col;
    const float s = s2_row[row];
    const float2 xf = load2(x + at);
    const float2 sc = *reinterpret_cast<const float2*>(s2_col + col);
    const float2 bc = *reinterpret_cast<const float2*>(b2 + col);
    const float z0 = __fadd_rn(dequant(v0, s, sc.x), bc.x);
    const float z1 = __fadd_rn(dequant(v1, s, sc.y), bc.y);
    store2(y + at, __fadd_rn(z0, xf.x), __fadd_rn(z1, xf.y));
  });
}

// Pass 4's tensor-parallel form: the int32 accumulator a8 . Bt^T of the
// shard's K, written as it is. The model group sums it exactly in int32,
// and dequant_residual_kernel runs pass 4's epilogue once on the sum.
template <int BN>
__global__ void __launch_bounds__(GemmLoop<BN>::kThreads)
    fc2_acc_kernel(const __grid_constant__ CUtensorMap tg8,
                   const __grid_constant__ CUtensorMap tw2,
                   int* __restrict__ acc_out, int M, int dim, int hid) {
  extern __shared__ unsigned char smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  int acc[GemmLoop<BN>::kAccRegs];
  if (!GemmLoop<BN>::run(&tg8, &tw2, m0, n0, hid, smem, acc)) return;
  GemmLoop<BN>::for_each_pair(acc, [&](int r, int c, int v0, int v1) {
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= dim) return;   // dim is even: col + 1 < dim too
    *reinterpret_cast<int2*>(acc_out + static_cast<size_t>(row) * dim +
                             col) = make_int2(v0, v1);
  });
}

// Pass 4's epilogue on the model group's int32 sum, fc2_residual_kernel's
// arithmetic: y = T((dequant(acc, s_row, s_col) + b) + x), s_row the
// scale of the whole row's amax. One thread a pair of columns.
template <typename T>
__global__ void __launch_bounds__(256)
    dequant_residual_kernel(const int* __restrict__ acc,
                            const float* __restrict__ amax,
                            const float* __restrict__ s_col,
                            const float* __restrict__ b,
                            const T* __restrict__ x, T* __restrict__ y,
                            int M, int dim) {
  const size_t pair = static_cast<size_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int half = dim / 2;
  if (pair >= static_cast<size_t>(M) * half) return;
  const int row = static_cast<int>(pair / half);
  const int col = static_cast<int>(pair % half) * 2;
  const size_t at = static_cast<size_t>(row) * dim + col;
  const float s = quant_scale(amax[row]);
  const int2 v = *reinterpret_cast<const int2*>(acc + at);
  const float2 xf = load2(x + at);
  const float2 sc = *reinterpret_cast<const float2*>(s_col + col);
  const float2 bc = *reinterpret_cast<const float2*>(b + col);
  const float z0 = __fadd_rn(dequant(v.x, s, sc.x), bc.x);
  const float z1 = __fadd_rn(dequant(v.y, s, sc.y), bc.y);
  store2(y + at, __fadd_rn(z0, xf.x), __fadd_rn(z1, xf.y));
}

// The scratch's pieces of one call (Scratch's layout).
struct Pieces {
  float *g, *gmax, *s1_row, *s2_row;
  int8_t *u8, *g8;
  Pieces(unsigned char* scratch, int M, int dim, int hid) {
    const Scratch at(M, dim, hid);
    g = reinterpret_cast<float*>(scratch + at.g);
    u8 = reinterpret_cast<int8_t*>(scratch + at.u8);
    g8 = reinterpret_cast<int8_t*>(scratch + at.g8);
    gmax = reinterpret_cast<float*>(scratch + at.gmax);
    s1_row = reinterpret_cast<float*>(scratch + at.s1_row);
    s2_row = reinterpret_cast<float*>(scratch + at.s2_row);
  }
};

template <typename T>
cudaError_t launch_all(const T* x, const float* gamma, const float* beta,
                       const int8_t* w1, const float* s1, const float* b1,
                       const int8_t* w2, const float* s2, const float* b2,
                       T* y, unsigned char* scratch, int M, int dim, int hid,
                       float eps, cudaStream_t stream) {
  const Scratch at(M, dim, hid);
  float* g = reinterpret_cast<float*>(scratch + at.g);
  int8_t* u8 = reinterpret_cast<int8_t*>(scratch + at.u8);
  int8_t* g8 = reinterpret_cast<int8_t*>(scratch + at.g8);
  float* gmax = reinterpret_cast<float*>(scratch + at.gmax);
  float* s1_row = reinterpret_cast<float*>(scratch + at.s1_row);
  float* s2_row = reinterpret_cast<float*>(scratch + at.s2_row);
  // Every map is encoded before the first launch: a failed encode leaves
  // nothing half done.
  CUtensorMap tu8, tw1, tg8, tw2;
  cudaError_t err = hopper::encode_kmajor(&tu8, u8, M, dim, true, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw1, w1, hid, dim, true, kBN);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tg8, g8, M, hid, true, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw2, w2, dim, hid, true, kBN);
  if (err == cudaSuccess) err = allow_smem(fc1_gelu_kernel, Loop::kSmemBytes);
  if (err == cudaSuccess) err = allow_fc2_residual_smem<T>();
  if (err != cudaSuccess) return err;

  const int row_blocks = (M + kRowWarps - 1) / kRowWarps;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int hid_tiles = (hid + kBN - 1) / kBN;
  err = launch_ln_rowquant(x, gamma, beta, u8, s1_row, M, dim, eps, stream);
  if (err != cudaSuccess) return err;
  fc1_gelu_kernel<<<dim3(hid_tiles, m_tiles), Loop::kThreads,
                    Loop::kSmemBytes, stream>>>(tu8, tw1, s1_row, s1, b1, g,
                                                gmax, M, dim, hid);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  g_rowquant_kernel<<<row_blocks, kRowWarps * 32, 0, stream>>>(
      g, gmax, g8, s2_row, M, hid, hid_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_fc2_residual(tg8, tw2, s2_row, s2, b2, x, y, M, dim, hid,
                             kBN, stream);
}

}  // namespace

template <typename T>
cudaError_t allow_fc2_residual_smem() {
  const cudaError_t err =
      allow_smem(fc2_residual_kernel<T, 64>, GemmLoop<64>::kSmemBytes);
  return err == cudaSuccess ? allow_smem(fc2_residual_kernel<T, 128>,
                                         GemmLoop<128>::kSmemBytes)
                            : err;
}

template <typename T>
cudaError_t launch_fc2_residual(const CUtensorMap& ta, const CUtensorMap& tb,
                                const float* s_row, const float* s_col,
                                const float* b, const T* x, T* y, int M,
                                int N, int K, int bn, cudaStream_t stream) {
  const dim3 grid((N + bn - 1) / bn, (M + kBM - 1) / kBM);
  if (bn == 64)
    fc2_residual_kernel<T, 64><<<grid, GemmLoop<64>::kThreads,
                                 GemmLoop<64>::kSmemBytes, stream>>>(
        ta, tb, s_row, s_col, b, x, y, M, N, K);
  else
    fc2_residual_kernel<T, 128><<<grid, GemmLoop<128>::kThreads,
                                  GemmLoop<128>::kSmemBytes, stream>>>(
        ta, tb, s_row, s_col, b, x, y, M, N, K);
  return cudaGetLastError();
}

cudaError_t allow_fc2_acc_smem() {
  const cudaError_t err =
      allow_smem(fc2_acc_kernel<64>, GemmLoop<64>::kSmemBytes);
  return err == cudaSuccess
             ? allow_smem(fc2_acc_kernel<128>, GemmLoop<128>::kSmemBytes)
             : err;
}

cudaError_t launch_fc2_acc(const CUtensorMap& ta, const CUtensorMap& tb,
                           int* acc, int M, int N, int K, int bn,
                           cudaStream_t stream) {
  const dim3 grid((N + bn - 1) / bn, (M + kBM - 1) / kBM);
  if (bn == 64)
    fc2_acc_kernel<64><<<grid, GemmLoop<64>::kThreads,
                         GemmLoop<64>::kSmemBytes, stream>>>(ta, tb, acc, M,
                                                             N, K);
  else
    fc2_acc_kernel<128><<<grid, GemmLoop<128>::kThreads,
                          GemmLoop<128>::kSmemBytes, stream>>>(ta, tb, acc,
                                                               M, N, K);
  return cudaGetLastError();
}

template cudaError_t allow_fc2_residual_smem<bf16>();
template cudaError_t allow_fc2_residual_smem<float>();
template cudaError_t launch_fc2_residual<bf16>(
    const CUtensorMap&, const CUtensorMap&, const float*, const float*,
    const float*, const bf16*, bf16*, int, int, int, int, cudaStream_t);
template cudaError_t launch_fc2_residual<float>(
    const CUtensorMap&, const CUtensorMap&, const float*, const float*,
    const float*, const float*, float*, int, int, int, int, cudaStream_t);

namespace {

template <typename T>
int entry(const void* x, const void* gamma, const void* beta, const void* w1,
          const void* s1, const void* b1, const void* w2, const void* s2,
          const void* b2, void* y, void* scratch, int M, int dim, int hid,
          float eps, void* stream) {
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all<T>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(y),
      static_cast<unsigned char*>(scratch), M, dim, hid, eps,
      static_cast<cudaStream_t>(stream)));
}

// The tensor-parallel split of a call on a shard of the hidden columns:
// passes 1 and 2 and each row's amax of g over the shard (hidden_entry),
// then, with the amax maxed over the model group, pass 3 with that amax and
// pass 4's tensor-parallel form (partial_entry), both on one scratch;
// pass 4's epilogue on the model group's sum (dequant_entry).
template <typename T>
int hidden_entry(const void* x, const void* gamma, const void* beta,
                 const void* w1, const void* s1, const void* b1, void* amax,
                 void* scratch, int M, int dim, int hid, float eps,
                 void* stream) {
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pieces p(static_cast<unsigned char*>(scratch), M, dim, hid);
  CUtensorMap tu8, tw1;
  cudaError_t err = hopper::encode_kmajor(&tu8, p.u8, M, dim, true, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw1, w1, hid, dim, true, kBN);
  if (err == cudaSuccess) err = allow_smem(fc1_gelu_kernel, Loop::kSmemBytes);
  if (err == cudaSuccess)
    err = launch_ln_rowquant(static_cast<const T*>(x),
                             static_cast<const float*>(gamma),
                             static_cast<const float*>(beta), p.u8, p.s1_row,
                             M, dim, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hid_tiles = (hid + kBN - 1) / kBN;
  fc1_gelu_kernel<<<dim3(hid_tiles, (M + kBM - 1) / kBM), Loop::kThreads,
                    Loop::kSmemBytes, s>>>(
      tu8, tw1, p.s1_row, static_cast<const float*>(s1),
      static_cast<const float*>(b1), p.g, p.gmax, M, dim, hid);
  if ((err = cudaGetLastError()) != cudaSuccess)
    return static_cast<int>(err);
  gmax_rows_kernel<<<(M + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, s>>>(
      p.gmax, static_cast<float*>(amax), M, hid_tiles);
  return static_cast<int>(cudaGetLastError());
}

int partial_entry(const void* amax, const void* w2, void* acc, void* scratch,
                  int M, int dim, int hid, void* stream) {
  if (M < 1 || dim < 16 || dim % 16 != 0 || hid < 16 || hid % 16 != 0 ||
      acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pieces p(static_cast<unsigned char*>(scratch), M, dim, hid);
  CUtensorMap tg8, tw2;
  cudaError_t err = hopper::encode_kmajor(&tg8, p.g8, M, hid, true, kBM);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw2, w2, dim, hid, true, kBN);
  if (err == cudaSuccess) err = allow_fc2_acc_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  g_rowquant_given_kernel<<<(M + kRowWarps - 1) / kRowWarps, kRowWarps * 32,
                            0, s>>>(p.g, static_cast<const float*>(amax),
                                    p.g8, p.s2_row, M, hid);
  if ((err = cudaGetLastError()) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(launch_fc2_acc(tg8, tw2, static_cast<int*>(acc), M,
                                         dim, hid, kBN, s));
}

template <typename T>
int dequant_entry(const void* acc, const void* amax, const void* s_col,
                  const void* b, const void* x, void* y, int M, int dim,
                  void* stream) {
  if (M < 1 || dim < 2 || dim % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t pairs = static_cast<size_t>(M) * (dim / 2);
  dequant_residual_kernel<T><<<static_cast<unsigned>((pairs + 255) / 256),
                               256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(acc), static_cast<const float*>(amax),
      static_cast<const float*>(s_col), static_cast<const float*>(b),
      static_cast<const T*>(x), static_cast<T*>(y), M, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace nvt

// K12's tensor-parallel form on a shard of the hidden columns (w1 [hid,
// dim] int8, s1 and b1 [hid] the shard's), first half: passes 1 and 2 into
// the scratch (nvt_int8_mlp_scratch_bytes(M, dim, hid)) and amax [M] f32,
// each row's amax of g over the shard's columns. x [M, dim] bf16.
extern "C" int nvt_int8_mlp_hidden(const void* x, const void* gamma,
                                   const void* beta, const void* w1,
                                   const void* s1, const void* b1, void* amax,
                                   void* scratch, int M, int dim, int hid,
                                   float eps, void* stream) {
  return nvt::hidden_entry<nvt::bf16>(x, gamma, beta, w1, s1, b1, amax,
                                      scratch, M, dim, hid, eps, stream);
}

// The f32 instance: x f32, every other operand as nvt_int8_mlp_hidden's.
extern "C" int nvt_int8_mlp_hidden_f32(const void* x, const void* gamma,
                                       const void* beta, const void* w1,
                                       const void* s1, const void* b1,
                                       void* amax, void* scratch, int M,
                                       int dim, int hid, float eps,
                                       void* stream) {
  return nvt::hidden_entry<float>(x, gamma, beta, w1, s1, b1, amax, scratch,
                                  M, dim, hid, eps, stream);
}

// Second half, on the first half's scratch (either dtype's): g's codes
// with amax [M], the model group's max (the whole hid row's), then acc [M,
// dim] int32 = g8 . W2^T with w2 [dim, hid] int8 the shard's columns. The
// model group sums acc in int32; nvt_int8_dequant_residual ends the pass.
extern "C" int nvt_int8_mlp_partial(const void* amax, const void* w2,
                                    void* acc, void* scratch, int M, int dim,
                                    int hid, void* stream) {
  return nvt::partial_entry(amax, w2, acc, scratch, M, dim, hid, stream);
}

// The epilogue of K11's and K12's last pass on the model group's int32 sum
// acc [M, dim]: y [M, dim] bf16 = (dequant(acc, scale(amax), s_col) + b) +
// x, amax [M] the whole row's, s_col and b [dim] f32, x [M, dim] bf16; the
// arithmetic of the one-card pass, so y is its y bit for bit.
extern "C" int nvt_int8_dequant_residual(const void* acc, const void* amax,
                                         const void* s_col, const void* b,
                                         const void* x, void* y, int M,
                                         int dim, void* stream) {
  return nvt::dequant_entry<nvt::bf16>(acc, amax, s_col, b, x, y, M, dim,
                                       stream);
}

// The f32 instance: x and y f32.
extern "C" int nvt_int8_dequant_residual_f32(const void* acc,
                                             const void* amax,
                                             const void* s_col, const void* b,
                                             const void* x, void* y, int M,
                                             int dim, void* stream) {
  return nvt::dequant_entry<float>(acc, amax, s_col, b, x, y, M, dim, stream);
}

// x [M, dim] bf16; gamma, beta [dim] f32; w1 [hid, dim] int8; s1, b1 [hid]
// f32; w2 [dim, hid] int8; s2, b2 [dim] f32; y [M, dim] bf16; scratch
// nvt_int8_mlp_scratch_bytes(M, dim, hid) bytes, 256-byte aligned. dim and
// hid are multiples of 16 (TMA's 16-byte rows), of any size.
extern "C" int nvt_int8_mlp(const void* x, const void* gamma, const void* beta,
                            const void* w1, const void* s1, const void* b1,
                            const void* w2, const void* s2, const void* b2,
                            void* y, void* scratch, int M, int dim, int hid,
                            float eps, void* stream) {
  return nvt::entry<nvt::bf16>(x, gamma, beta, w1, s1, b1, w2, s2, b2, y,
                               scratch, M, dim, hid, eps, stream);
}

// The f32 instance: x and y [M, dim] f32, every other operand and the
// scratch as nvt_int8_mlp's.
extern "C" int nvt_int8_mlp_f32(const void* x, const void* gamma,
                                const void* beta, const void* w1,
                                const void* s1, const void* b1, const void* w2,
                                const void* s2, const void* b2, void* y,
                                void* scratch, int M, int dim, int hid,
                                float eps, void* stream) {
  return nvt::entry<float>(x, gamma, beta, w1, s1, b1, w2, s2, b2, y,
                           scratch, M, dim, hid, eps, stream);
}

// Bytes of the scratch one call takes (ops/int8_serving.py, mlp_plan).
extern "C" long long nvt_int8_mlp_scratch_bytes(int M, int dim, int hid) {
  return static_cast<long long>(nvt::Scratch(M, dim, hid).bytes);
}

// Dynamic shared memory of a block of either GEMM pass.
extern "C" long long nvt_int8_mlp_smem_bytes() {
  return static_cast<long long>(nvt::Loop::kSmemBytes);
}
