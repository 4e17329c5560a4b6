// f32 products on the tensor cores by 3xTF32, on mma.sync's TF32 form
// (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32): the f32 attention
// forward (flash_attention_f32.cu, K1 and K6 at f32) and backward
// (flash_attention_bwd_f32.cu, K5 and K6's backward at f32) run every one
// of their matrix products here.
//
// One TF32 product keeps 10 mantissa bits of each operand, too few for the JAX
// package's f32 path (neurovit_tpu/nn.py:28-32, ffma.cuh). So each operand x
// is split into big = rna_tf32(x) and small = x - big (exact in f32), and a
// product a.b is taken as three TF32 products, small(a).big(b) and
// big(a).small(b) first, then big(a).big(b) (the small terms are added while
// the sum is still small). rna_tf32 rounds as cvt.rna.tf32.f32 does (to
// nearest, ties away from zero), by an integer add and a mask, which the H100
// runs faster than the cvt. The tensor cores read a TF32 operand's top 19
// bits, so small enters truncated to 10 mantissa bits; rounding it with
// cvt.rna first would gain half a bit of small, 2^-23 of x, for one more
// instruction an operand (scripts/torch_attention_bwd_f32_variants.py times
// both). Dropped: small(a).small(b), about 2^-22 of |a b|, and small's last
// bits, about as much; so a product's error is a few times FFMA's. Each step
// of 8 along k costs three MMAs of 16 x 8 x 8; at the card's 495 TF32 TFLOP/s
// that is 165 TFLOP/s of f32 products at most, against the CUDA cores' 67, but
// mma.sync's TF32 form reaches 322 TFLOP/s on the H100
// (scripts/torch_mma_tf32_peak.py), so 107 in 3xTF32.
//
// The sums: an MMA rounds its f32 sum toward zero, so a product that ran a
// long k in one accumulator would drift by up to an ulp of the sum every
// step, all one way (dQ over 1001 keys is 378 MMAs deep; the variants
// script's one_accumulator). So a kernel runs a few steps into a fresh
// accumulator (mma3_rz from zeros) and adds it to the product's sum in
// f32, which rounds to nearest (add_to): a step's drift is then an ulp of
// that step's part alone.
//
// Why mma.sync and not wgmma: wgmma takes TF32 operands K-major only, and
// the attention backward's dV = (P m)^T dO, dK = dS^T Q and dQ = dS K each
// have an operand that lies MN-major in shared memory. mma.sync's operands
// are registers that the threads load themselves, so a fragment may come
// from a tile in either orientation (load_a and load_b_nk2 by ldmatrix,
// load_b_kn by 32-bit loads) or from the accumulator of the product before
// (a_from_acc), with no transpose.
//
// Fragments of m16n8k8 .tf32 (PTX ISA), lane = 4 g + t:
//   A 16 x 8 (m, k):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8 x 8 (k, n):   b0 (t, g), b1 (t + 4, g)
//   C 16 x 8 (m, n):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// ldmatrix .b16 hands lane 4 g + t the 32-bit word t of row g of each 8 x
// 4 f32 matrix whose row addresses lanes 8 i .. 8 i + 7 give: a0 .. a3 are
// four such matrices of an [m][k] tile, b0 and b1 two of an [n][k] tile.
// An accumulator is the A of a next product whose k runs over its 8
// columns in the order 0, 2, 4, 6, 1, 3, 5, 7 (k slot t is column 2t, slot
// t + 4 column 2t + 1: a0 = c0, a1 = c2, a2 = c1, a3 = c3); that product's
// B reads its k rows in the same order (load_b_kn). The order of a sum's
// terms within one MMA is the hardware's either way.
//
// Bank conflicts: a tile holds f32 rows ld floats apart with ld = 4 (mod
// 32) (D + 4 for the head dims, multiples of 32). Then the eight 16-byte
// rows of an ldmatrix matrix fall in eight distinct 16-byte bank groups,
// and the two 32-bit loads of load_b_kn (rows 2t and 2t + 1, column g) in
// banks 8 t + g and 8 t + 4 + g: 32 distinct banks each, one wavefront a
// load. The padding keeps rows 16-byte aligned for cp.async and ldmatrix.
#pragma once

#include "common.cuh"

namespace nvt {
namespace tf32x3 {

// A fragment: big and small parts of a0 .. a3; B: of b0, b1.
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// The bits x of a finite f32 rounded to TF32 (10 mantissa bits, to
// nearest, ties away from zero: cvt.rna.tf32.f32's result), low 13 bits 0.
__device__ __forceinline__ uint32_t rna_tf32(uint32_t x) {
  return (x + 0x1000u) & 0xffffe000u;
}

// The bits x of an f32 into big and small.
__device__ __forceinline__ void split(uint32_t x, uint32_t& big,
                                      uint32_t& small) {
  big = rna_tf32(x);
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// Four 8 x 4 f32 matrices from shared memory; lanes 8 i .. 8 i + 7 give
// the row addresses of matrix i (16-byte aligned).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// A from a tile stored [m][k] (k contiguous): rows m0 .. m0 + 15, columns
// k0 .. k0 + 7 (lane 8 i + r: row m0 + r + 8 (i % 2), column k0 + 4 (i /
// 2)).
__device__ __forceinline__ void load_a(FragA& a, const float* tile, int ld,
                                       int m0, int k0) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, tile + (m0 + (lane & 7) + 8 * (i & 1)) * ld + k0 + 4 * (i >> 1));
#pragma unroll
  for (int j = 0; j < 4; ++j) split(r[j], a.big[j], a.small[j]);
}

// The B of two 8-column tiles n0 and n0 + 8 from a tile stored [n][k]
// (K-major: K in S = Q K^T), columns k0 .. k0 + 7 (lane 8 i + r: row n0 +
// r + 8 (i / 2), column k0 + 4 (i % 2)).
__device__ __forceinline__ void load_b_nk2(FragB (&b)[2], const float* tile,
                                           int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, tile + (n0 + (lane & 7) + 8 * (i >> 1)) * ld + k0 + 4 * (i & 1));
#pragma unroll
  for (int j = 0; j < 4; ++j)
    split(r[j], b[j >> 1].big[j & 1], b[j >> 1].small[j & 1]);
}

// B from a tile stored [k][n] (MN-major: K in dQ = dS K), its k rows in an
// accumulator's order: rows k0 + 2t (slot t) and k0 + 2t + 1 (slot t + 4),
// column n0 + g.
__device__ __forceinline__ void load_b_kn(FragB& b, const float* tile,
                                          int ld, int k0, int n0) {
  const float* p = tile + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  split(__float_as_uint(p[0]), b.big[0], b.small[0]);
  split(__float_as_uint(p[ld]), b.big[1], b.small[1]);
}

// The same three loaders on a tile of kRows rows that TMA's 128-byte
// swizzle lays out (the f32 attention forward's Q, K and V boxes): column
// c of row r in panel c / 32 (kRows rows of 32 f32, 128 bytes a row),
// its 16-byte chunk (c % 32) / 4 at chunk ((c % 32) / 4) ^ (r % 8). The
// eight rows of an ldmatrix matrix (r % 8 = 0 .. 7 at one chunk) fall in
// eight distinct 16-byte bank groups, and load_b_kn_sw's lanes read the
// chunks (n0 % 32 / 4 + g / 4) ^ (2t or 2t + 1) at word g % 4: 32
// distinct banks. No bank conflict; the tile starts on 1024 bytes.
template <int kRows>
__device__ __forceinline__ int swz128(int r, int c) {
  return (c >> 5) * (kRows * 32) + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) +
         (c & 3);
}

template <int kRows>
__device__ __forceinline__ void load_a_sw(FragA& a, const float* tile, int m0,
                                          int k0) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, tile + swz128<kRows>(m0 + (lane & 7) + 8 * (i & 1),
                                  k0 + 4 * (i >> 1)));
#pragma unroll
  for (int j = 0; j < 4; ++j) split(r[j], a.big[j], a.small[j]);
}

template <int kRows>
__device__ __forceinline__ void load_b_nk2_sw(FragB& b0, FragB& b1,
                                              const float* tile, int n0,
                                              int k0) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, tile + swz128<kRows>(n0 + (lane & 7) + 8 * (i >> 1),
                                  k0 + 4 * (i & 1)));
  split(r[0], b0.big[0], b0.small[0]);
  split(r[1], b0.big[1], b0.small[1]);
  split(r[2], b1.big[0], b1.small[0]);
  split(r[3], b1.big[1], b1.small[1]);
}

template <int kRows>
__device__ __forceinline__ void load_b_kn_sw(FragB& b, const float* tile,
                                             int k0, int n0) {
  const int r = k0 + 2 * lane_t(), c = n0 + lane_g();
  split(__float_as_uint(tile[swz128<kRows>(r, c)]), b.big[0], b.small[0]);
  split(__float_as_uint(tile[swz128<kRows>(r + 1, c)]), b.big[1],
        b.small[1]);
}

// The accumulator c of a 16 x 8 product as the A of the next, its k slots
// in the order above.
__device__ __forceinline__ void a_from_acc(FragA& a, const float (&c)[4]) {
  split(__float_as_uint(c[0]), a.big[0], a.small[0]);
  split(__float_as_uint(c[2]), a.big[1], a.small[1]);
  split(__float_as_uint(c[1]), a.big[2], a.small[2]);
  split(__float_as_uint(c[3]), a.big[3], a.small[3]);
}

// c += a . b, one TF32 MMA (its sum rounded toward zero).
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in 3xTF32 in the MMA's accumulator: small . big, big . small,
// then big . big.
__device__ __forceinline__ void mma3_rz(float (&d)[4], const FragA& a,
                                        const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// d[j] += a . b[j] for kN accumulators at once in 3xTF32: each
// accumulator takes mma3_rz's three MMAs in its order, issued term by term
// across the accumulators, so that kN independent MMAs follow each other
// (the same sums as kN calls of mma3_rz).
template <int kN>
__device__ __forceinline__ void mma3_rz_n(float (&d)[kN][4], const FragA& a,
                                          const FragB (&b)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) mma_tf32(d[j], a.small, b[j].big);
#pragma unroll
  for (int j = 0; j < kN; ++j) mma_tf32(d[j], a.big, b[j].small);
#pragma unroll
  for (int j = 0; j < kN; ++j) mma_tf32(d[j], a.big, b[j].big);
}

__device__ __forceinline__ void zero(float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = 0.f;
}

// c += d in f32, rounded to nearest.
__device__ __forceinline__ void add_to(float (&c)[4], const float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

}  // namespace tf32x3
}  // namespace nvt
