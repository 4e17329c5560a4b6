// Per-row int8 quantization + int8 out-projection + bias + residual (K11),
// on TMA + wgmma.
//
// Replaces the TPU kernel neurovit_tpu/ops/int8_serving.py:167
// (_outproj_kernel, launched at :236 by int8_outproj_residual):
//   (a8, s_row) = rowquant(float(a))         per-row symmetric int8
//   z = float(a8 . W8^T) * s_row * s_col + b  f32
//   y = T(z + x)                             x added in f32, one rounding
// T is x's type: bf16, or f32 in the f32 instance (nvt_int8_outproj_f32,
// int8 serving of an f32 ViT), whose passes read f32 a and x and write f32
// y and are otherwise the bf16 ones; its scratch and shared memory are
// theirs (no pass stages a, x or y in shared memory).
// a [M, inner] is the attention output viewed as rows (no head transpose),
// W8 the torch-layout int8 weight [dim, inner] with scales s_col [dim]. W8
// is K-major as it lies, so wgmma reads it with no transpose.
//
// What bounds it on the H100: the bytes of a, x, y and W8 (41.5 MB for the
// flagship block at batch 8, M = 8008, inner 512, dim 1024: 0.0124 ms at
// 3.35 TB/s) above its 2 M inner dim int8 operations (0.0042 ms at 1,979
// TOP/s). This design also writes a8 and reads it again (49.7 MB, 0.0148
// ms). At f32 a, x and y take twice the bytes: 82.6 MB, 0.0247 ms.
//
// Why two launches. Every column tile of a row block needs the row's
// scale, the amax of the whole row of a, before its first code; on the
// card the column tiles are different blocks. So the row quantization is a
// pass of its own, and the product is K12's last pass:
//   1. rowquant (int8_rowquant.cu, K10's and K12's LN row quantizer
//      without the LayerNorm): a -> a8 [M, inner], s_row [M]; one warp a
//      row, reading the row from L1/L2 once for the amax and once for the
//      codes, so any inner is taken.
//   2. fc2_residual (int8_mlp.cu, K12's pass 4, launch_fc2_residual):
//      GemmLoop<BN> over (ceil(dim / BN), ceil(M / 128)) tiles, A = a8, Bt
//      = W8, K = inner; the epilogue dequantizes, adds b and x and rounds y
//      once, stored as pairs of T from registers.
// BN is 128, or 64 where 128-wide tiles would give the card fewer blocks
// than its 132 SMs (gemm_tile_n): at batch 1 of the flagship the 8 x 8
// tiles of 128 would leave half the SMs idle, and 16 x 8 tiles of 64 fill
// them, as K10's rule does at the same rows. TMA zero-fills the boxes past
// M, dim and inner; the epilogue masks rows >= M and columns >= dim.
// Widths are multiples of 16 (TMA's 16-byte rows), of any size.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; profiler device times from
// scripts/torch_outproj_device_times.py, four runs): at batch 8 the two
// passes take 0.0450-0.0459 ms, rowquant 8.8-9.0 us and fc2_residual
// 36.2-36.9, where K17 int8's GEMM kernel alone takes 21.0-21.1 us at the
// same [8016, 512] x [512, 1024]; at batch 1 0.0100 ms with 64-column
// tiles. The single wmma kernel this replaces took 0.0737 ms at batch 8
// and 0.0407 at batch 1. At K = 512 a tile has four k steps, too few to
// hide each block's ring fill and its epilogue. The f32 instance
// (chip_smoke.py's f32 phase (g), two runs): 0.1116-0.1163 ms by one-call
// events at batch 8.
//
// Rounding points are the JAX kernel's and the plain version's: scale =
// amax / 127 (1 where amax is 0); code = rint(a / scale) clamped to +-127,
// an IEEE division; dequant (float(acc) * s_row) * s_col, + b, + x, each
// rounded (no contraction), then bf16. The int32 sums are exact, so y is
// the plain version's bit for bit.
#include "int8.cuh"

namespace nvt {
namespace {

// Scratch of one call, one allocation: a8 [M, inner] then s_row [M] f32,
// each on a 256-byte boundary.
struct Scratch {
  size_t a8, s_row, bytes;
  Scratch(int M, int inner) {
    const size_t m = static_cast<size_t>(M);
    a8 = 0;
    s_row = round_up(m * inner, 256);
    bytes = round_up(s_row + m * sizeof(float), 256);
  }
};

template <typename T>
cudaError_t launch_all(const T* a, const T* x, const int8_t* w8,
                       const float* s_col, const float* bias, T* y,
                       unsigned char* scratch, int M, int inner, int dim,
                       cudaStream_t stream) {
  const Scratch at(M, inner);
  int8_t* a8 = reinterpret_cast<int8_t*>(scratch + at.a8);
  float* s_row = reinterpret_cast<float*>(scratch + at.s_row);
  const int bn = gemm_tile_n(M, dim);
  // Both maps are encoded, and both GEMM instances allowed their shared
  // memory, before the first launch: a failure leaves nothing half done.
  CUtensorMap ta8, tw8;
  cudaError_t err =
      hopper::encode_kmajor(&ta8, a8, M, inner, true, kGemmRows);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw8, w8, dim, inner, true, bn);
  if (err == cudaSuccess) err = allow_fc2_residual_smem<T>();
  if (err != cudaSuccess) return err;

  if ((err = launch_rowquant(a, a8, s_row, M, inner, stream)) != cudaSuccess)
    return err;
  return launch_fc2_residual(ta8, tw8, s_row, s_col, bias, x, y, M, dim,
                             inner, bn, stream);
}

template <typename T>
int entry(const void* a, const void* x, const void* w8, const void* s_col,
          const void* bias, void* y, void* scratch, int M, int inner, int dim,
          void* stream) {
  if (M < 1 || inner < 16 || inner % 16 != 0 || dim < 16 || dim % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all<T>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const int8_t*>(w8), static_cast<const float*>(s_col),
      static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<unsigned char*>(scratch), M, inner, dim,
      static_cast<cudaStream_t>(stream)));
}

// The tensor-parallel split on a row-parallel shard (a [M, inner] the
// shard's heads, w8 [dim, inner] its columns): each row's amax over the
// shard's columns (launch_row_amax, the first call); then, with the amax
// maxed over the model group, the codes (launch_rowquant_given) and K12's
// pass 4 in its tensor-parallel form, the int32 accumulator.
template <typename T>
int partial_entry(const void* a, const void* amax, const void* w8, void* acc,
                  void* scratch, int M, int inner, int dim, void* stream) {
  if (M < 1 || inner < 16 || inner % 16 != 0 || dim < 16 || dim % 16 != 0 ||
      acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch at(M, inner);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int8_t* a8 = reinterpret_cast<int8_t*>(base + at.a8);
  float* s_row = reinterpret_cast<float*>(base + at.s_row);
  const int bn = gemm_tile_n(M, dim);
  CUtensorMap ta8, tw8;
  cudaError_t err =
      hopper::encode_kmajor(&ta8, a8, M, inner, true, kGemmRows);
  if (err == cudaSuccess)
    err = hopper::encode_kmajor(&tw8, w8, dim, inner, true, bn);
  if (err == cudaSuccess) err = allow_fc2_acc_smem();
  if (err == cudaSuccess)
    err = launch_rowquant_given(static_cast<const T*>(a),
                                static_cast<const float*>(amax), a8, s_row, M,
                                inner, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_fc2_acc(ta8, tw8, static_cast<int*>(acc), M,
                                         dim, inner, bn, s));
}

template <typename T>
int amax_entry(const void* a, void* amax, int M, int inner, void* stream) {
  if (M < 1 || inner < 16 || inner % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_row_amax(
      static_cast<const T*>(a), static_cast<float*>(amax), M, inner,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace
}  // namespace nvt

// K11's tensor-parallel form on a shard of the heads, first call: amax [M]
// f32, each row's amax of |a| over the shard's columns, a [M, inner] bf16.
extern "C" int nvt_int8_row_amax(const void* a, void* amax, int M, int inner,
                                 void* stream) {
  return nvt::amax_entry<nvt::bf16>(a, amax, M, inner, stream);
}

// The f32 instance: a f32.
extern "C" int nvt_int8_row_amax_f32(const void* a, void* amax, int M,
                                     int inner, void* stream) {
  return nvt::amax_entry<float>(a, amax, M, inner, stream);
}

// Second call, with amax [M] the model group's max (the whole row's): a
// [M, inner] bf16, w8 [dim, inner] int8 (the shard's columns), acc [M,
// dim] int32 = a8 . w8^T; scratch as nvt_int8_outproj's. The model group
// sums acc in int32; nvt_int8_dequant_residual (int8_mlp.cu) ends the pass.
extern "C" int nvt_int8_outproj_partial(const void* a, const void* amax,
                                        const void* w8, void* acc,
                                        void* scratch, int M, int inner,
                                        int dim, void* stream) {
  return nvt::partial_entry<nvt::bf16>(a, amax, w8, acc, scratch, M, inner,
                                       dim, stream);
}

// The f32 instance: a f32.
extern "C" int nvt_int8_outproj_partial_f32(const void* a, const void* amax,
                                            const void* w8, void* acc,
                                            void* scratch, int M, int inner,
                                            int dim, void* stream) {
  return nvt::partial_entry<float>(a, amax, w8, acc, scratch, M, inner, dim,
                                   stream);
}

// a [M, inner], x [M, dim] bf16; w8 [dim, inner] int8; s_col, bias [dim]
// f32; y [M, dim] bf16; scratch nvt_int8_outproj_scratch_bytes(M, dim,
// inner) bytes, 256-byte aligned. inner and dim are multiples of 16 (TMA's
// 16-byte rows), of any size.
extern "C" int nvt_int8_outproj(const void* a, const void* x, const void* w8,
                                const void* s_col, const void* bias, void* y,
                                void* scratch, int M, int inner, int dim,
                                void* stream) {
  return nvt::entry<nvt::bf16>(a, x, w8, s_col, bias, y, scratch, M, inner,
                               dim, stream);
}

// The f32 instance: a, x and y f32, every other operand and the scratch as
// nvt_int8_outproj's.
extern "C" int nvt_int8_outproj_f32(const void* a, const void* x,
                                    const void* w8, const void* s_col,
                                    const void* bias, void* y, void* scratch,
                                    int M, int inner, int dim, void* stream) {
  return nvt::entry<float>(a, x, w8, s_col, bias, y, scratch, M, inner, dim,
                           stream);
}

// Bytes of the scratch one call takes (ops/int8_serving.py,
// int8_outproj_plan).
extern "C" long long nvt_int8_outproj_scratch_bytes(int M, int dim,
                                                    int inner) {
  (void)dim;
  return static_cast<long long>(nvt::Scratch(M, inner).bytes);
}

// Dynamic shared memory of a block of the GEMM pass for M rows at dim,
// which follows its tile's width.
extern "C" long long nvt_int8_outproj_smem_bytes(int M, int dim) {
  return static_cast<long long>(
      nvt::gemm_smem_bytes(nvt::gemm_tile_n(M, dim)));
}
