// A Hopper GEMM mainloop: TMA loads into a shared-memory ring, wgmma from
// it, for sm_90a.
//
// Mainloop<kInt8, BM, BN> computes the BM x BN tile at (m0, n0) of
// A [M, K] . B^T, where both operands are K-major in device memory: A
// [M, K] and Bt [N, K] row-major, bf16 (f32 sums) or int8 (exact int32
// sums). Each operand has a CUtensorMap (encode_kmajor) whose box is 128
// bytes of K -- 64 bf16 or 128 int8 -- by the tile's rows, loaded with the
// 128-byte swizzle; TMA zero-fills the box past M, N and K, so a ragged
// tile needs no masked loads and contributes zeros.
//
// Mainloop<false, BM, BN, kStages, true> takes B MN-major instead: B [K, N]
// row-major (bf16), as a torch Linear weight [out, in] is for a product
// that contracts its out dimension (K9's dz . W2 and dh . W1). Its map
// (encode_mnmajor) has boxes of 64 rows of K by 64 columns (128 bytes);
// a stage holds BN / 64 such boxes side by side, and wgmma reads them with
// the transpose-B immediate through smem_desc_mn (SBO 1024 bytes between
// 8-row groups along K, LBO 8192 bytes between the 64-column boxes along
// N; a k16 step is 16 rows, 2048 bytes further). The stage's bytes, and
// so kSmemBytes, are those of the K-major mode.
//
// Roles: kConsumers = BM / 64 warpgroups (threads 0 .. 128 kConsumers - 1)
// each own 64 rows of the tile; one producer warp after them issues the
// loads. A stage holds one A box and one Bt box; kStages stages form a
// ring, each paired with a "full" mbarrier (the producer's expect_tx, then
// the bytes TMA lands) and an "empty" one (one arrival per consumer
// warpgroup once its wgmmas on the stage are done). A consumer warpgroup
// runs four wgmma.m64nBNk16 (bf16) or k32 (int8) per stage, each on
// descriptors whose start address moves 32 bytes along K inside the
// swizzled 128-byte rows (layout B128, SBO 1024 bytes: 8 rows of 128 B),
// commits them as one group and keeps it in flight while it issues the
// next stage's; it releases a stage once the group after it is issued and
// the stage's own group is done (wgmma.wait_group 1).
//
// The accumulator stays in registers in wgmma's m64nN layout; for_each_pair
// hands an epilogue each thread's values as (row, col), (row, col + 1)
// pairs, so a kernel adds its own epilogue on top of run().
//
// Dynamic shared memory: kSmemBytes (the ring, the barriers and 1 KiB of
// slack to align the ring to the swizzle's 1024 bytes).
//
// K4's fc1 (fused_mlp.cu) stages its output tiles in the freed ring and
// stores them with tma_store_2d.
//
// The attention forward (flash_attention.cu) builds its own loop from the
// same pieces and a few more: rank-4 tensor maps (encode_bf16_4d) loaded
// and stored by TMA (tma_load_4d, tma_store_4d), the descriptor of an
// MN-major B tile (smem_desc_mn64) and wgmma with A in registers
// (WgmmaRegA64). The attention backward (flash_attention_bwd.cu) adds
// m64n32k16 (Wgmma<false, 32>) and moves registers between warpgroups
// (setmaxnreg). The int8 attention (int8_attention.cu) adds s8 wgmma with A
// in registers (WgmmaRegAS8) on int8 tiles of 64-byte rows loaded with the
// 64-byte swizzle (encode_kmajor's row_bytes 64, smem_desc_sw64).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdio.h>

#include <type_traits>

#include "common.cuh"

namespace nvt {
namespace hopper {

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of TMA traffic in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Load the box at coordinates (c0 along K, c1 along rows) of `map` into
// shared memory at dst; the box's bytes complete on the barrier `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same for a rank-4 map, coordinates innermost first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Ask TMA to bring the box at coordinates (c0, c1) of a rank-2 map into
// L2, with no shared memory and no barrier: a later load of it hits L2.
__device__ __forceinline__ void tma_prefetch_l2_2d(const CUtensorMap* map,
                                                   int c0, int c1) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1)
      : "memory");
}

// Store the box at src to the coordinates of a rank-4 map; TMA writes no
// element outside the tensor. Make the generic proxy's writes to src
// visible first (fence_proxy_async), and keep src alive until
// tma_store_wait.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Store the box at src to the coordinates (c0 along K, c1 along rows) of a
// rank-2 map, as tma_store_4d.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until every committed store has read its shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a K-major operand tile in shared memory as TMA's 128-byte
// swizzle lays it out: rows of 128 bytes, 8-row groups 1024 bytes apart
// (SBO), layout type 1 (B128). The tile starts on a 1024-byte boundary, so
// the base offset is 0; LBO is unused for this layout (1 by convention).
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// The descriptor of the next k step: 32 bytes further along K.
constexpr uint64_t kDescStepK = 32 >> 4;

// Descriptor of an MN-major B stage of BN / 64 boxes, each K rows of 64
// bf16 columns (128-byte rows, 128-byte swizzle) and box_bytes long, side
// by side along N, as TMA lays out a row-major [K, N] tile: the stride of
// the 8-row groups along K is SBO (1024 bytes) and the stride of the
// 64-column groups along N is LBO (box_bytes; CUTLASS's
// make_gmma_desc<Major::MN>), layout B128. A k16 step is 16 rows further:
// 2048 bytes, a whole number of swizzle atoms, so the base offset stays 0.
__device__ __forceinline__ uint64_t smem_desc_mn(const void* tile,
                                                 uint32_t box_bytes) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(box_bytes >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// The descriptor of a 64-column MN-major tile (the attention's V, dO, Q
// and K): one group along N, so LBO is never read.
__device__ __forceinline__ uint64_t smem_desc_mn64(const void* tile) {
  return smem_desc_mn(tile, 1024);
}

// The MN-major descriptor of the next k16 step: 16 rows, 2048 bytes.
constexpr uint64_t kDescStepKMn = 2048 >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Lower (dec) or raise (inc) the registers of every thread of the calling
// warpgroup to N; an inc draws only on registers other warpgroups of the
// block released. The warpgroup's roles must part in one branch that never
// rejoins, or ptxas ignores the request (C7508).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Keep the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// D[64, N] += A[64, k] . B[N, k]^T from two shared-memory descriptors, both
// K-major: k = 16 bf16 (f32 sums) or 32 int8 (int32 sums). Thread t of the
// warpgroup holds d[4 j + i] at row 16 (t / 32) + (t % 32) / 4 + 8 (i / 2),
// column 8 j + 2 (t % 4) + i % 2.
template <bool kInt8, int N>
struct Wgmma;

template <>
struct Wgmma<false, 32> {
  __device__ __forceinline__ static void mma(
      float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, 1, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db));
  }
};

// Wgmma<false, 64>::mma<0> ignores d's values and writes A . B^T (the
// scale-d immediate 0): the first k step of a product, with no zeroing.
template <>
struct Wgmma<false, 64> {
  template <int kScaleD = 1>
  __device__ __forceinline__ static void mma(
      float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, %34, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "n"(kScaleD));
  }
};

template <>
struct Wgmma<false, 128> {
  __device__ __forceinline__ static void mma(
      float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, 1, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db));
  }
};

// D[64, N] += A[64, 16] . B[16, N] from two shared-memory descriptors, A
// K-major and B MN-major (the transpose-B immediate set): bf16, f32 sums.
// The accumulator's layout is Wgmma's.
template <int N>
struct WgmmaTB;

template <>
struct WgmmaTB<64> {
  __device__ __forceinline__ static void mma(
      float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, 1, 1, 1, 0, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db));
  }
};

template <>
struct WgmmaTB<128> {
  __device__ __forceinline__ static void mma(
      float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, 1, 1, 1, 0, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db));
  }
};

// D[64, 64] += A[64, 16] . B[16, 64] with A in registers and B an MN-major
// bf16 tile in shared memory (the transpose-B immediate set): f32 sums.
// Thread t of the warpgroup holds A as four bf16 pairs, row r = 16 (t / 32)
// + (t % 32) / 4, c = 2 (t % 4): a[0] (r, c), a[1] (r + 8, c), a[2] (r,
// c + 8), a[3] (r + 8, c + 8), each pair at columns (c, c + 1), the lower
// column in the low half. That is the accumulator layout above, so a k16
// chunk of an f32 accumulator, rounded to bf16 pairs, is an A operand.
struct WgmmaRegA64 {
  __device__ __forceinline__ static void mma(
      float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
  }
};

// Descriptor of a K-major int8 tile whose rows are 64 bytes (64 int8 of K),
// as TMA's 64-byte swizzle lays it out: 8-row groups 512 bytes apart (SBO),
// layout type 2 (B64). The tile starts on a 512-byte boundary; a k32 step
// is 32 bytes further along K (kDescStepK).
__device__ __forceinline__ uint64_t smem_desc_sw64(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(512 >> 4) << 32) | (uint64_t(2) << 62);
}

// D[64, N] += A[64, 32] . B[N, 32]^T with A in registers and B a K-major
// int8 tile in shared memory: s8 x s8, exact int32 sums. Thread t of the
// warpgroup holds A as four registers of four s8 each, row r = 16 (t / 32)
// + (t % 32) / 4, k = 4 (t % 4): a[0] (r, k .. k + 3), a[1] (r + 8, k ..),
// a[2] (r, 16 + k ..), a[3] (r + 8, 16 + k ..), the lowest k in the lowest
// byte. The accumulator's layout is Wgmma's.
template <int N>
struct WgmmaRegAS8;

template <>
struct WgmmaRegAS8<64> {
  __device__ __forceinline__ static void mma(
      int (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, 1;\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
  }
};

template <>
struct WgmmaRegAS8<128> {
  __device__ __forceinline__ static void mma(
      int (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, 1;\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
  }
};

template <>
struct Wgmma<true, 64> {
  __device__ __forceinline__ static void mma(
      int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, 1;\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db));
  }
};

template <>
struct Wgmma<true, 128> {
  __device__ __forceinline__ static void mma(
      int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, 1;\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db));
  }
};

// ---------------------------------------------------------------------------
// The mainloop
// ---------------------------------------------------------------------------

template <bool kInt8, int BM, int BN, int kStages = 4, bool kBMn = false>
struct Mainloop {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  static_assert(BM % 64 == 0 && (BN == 64 || BN == 128), "tile shape");
  static_assert(!(kInt8 && kBMn), "wgmma transposes 16-bit operands only");
  static constexpr int kConsumers = BM / 64;                // warpgroups
  static constexpr int kThreads = kConsumers * 128 + 32;    // + producer
  static constexpr int kBoxBytes = 128;                     // K per stage
  static constexpr int BK = kInt8 ? 128 : 64;               // elements
  static constexpr int kSteps = 4;                          // wgmmas/stage
  static constexpr int kABytes = BM * kBoxBytes;
  static constexpr int kBBytes = BN * kBoxBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBBoxBytes = BK * kBoxBytes;          // MN-major box
  static constexpr int kAccRegs = BN / 2;                   // 64 BN / 128
  static constexpr size_t kSmemBytes =
      1024 + size_t(kStages) * kStageBytes + 2 * kStages * sizeof(uint64_t);

  // Every thread of the block calls run(). The producer warp returns false
  // once it has issued every load; a consumer thread returns true with acc
  // holding its part of rows 64 w .. 64 w + 63 of the tile (w its
  // warpgroup), over K rounded up to BK (zeros past K).
  __device__ __forceinline__ static bool run(
      const CUtensorMap* ta, const CUtensorMap* tb, int m0, int n0, int K,
      unsigned char* smem_raw, Acc (&acc)[kAccRegs]) {
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        round_up(reinterpret_cast<size_t>(smem_raw), 1024));
    unsigned char* a_ring = smem;
    unsigned char* b_ring = smem + kStages * kABytes;
    uint64_t* full =
        reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
    uint64_t* empty = full + kStages;
    const int KT = (K + BK - 1) / BK;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumers);
      }
      mbar_init_fence();
    }
    __syncthreads();

    if (wg == kConsumers) {   // the producer warp: one thread issues
      if (threadIdx.x % 32 == 0) {
        tma_prefetch_map(ta);
        tma_prefetch_map(tb);
        for (int kt = 0; kt < KT; ++kt) {
          const int s = kt % kStages;
          if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(a_ring + s * kABytes, ta, &full[s], kt * BK, m0);
          if constexpr (kBMn) {
#pragma unroll
            for (int p = 0; p < BN / 64; ++p)
              tma_load_2d(b_ring + s * kBBytes + p * kBBoxBytes, tb,
                          &full[s], n0 + 64 * p, kt * BK);
          } else {
            tma_load_2d(b_ring + s * kBBytes, tb, &full[s], kt * BK, n0);
          }
        }
      }
      return false;
    }

#pragma unroll
    for (int i = 0; i < kAccRegs; ++i) {
      acc[i] = Acc(0);
      fence_operand(acc[i]);
    }
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint64_t da =
          smem_desc(a_ring + s * kABytes + wg * 64 * kBoxBytes);
      const uint64_t db =
          kBMn ? smem_desc_mn(b_ring + s * kBBytes, kBBoxBytes)
               : smem_desc(b_ring + s * kBBytes);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        if constexpr (kBMn)
          WgmmaTB<BN>::mma(acc, da + k * kDescStepK, db + k * kDescStepKMn);
        else
          Wgmma<kInt8, BN>::mma(acc, da + k * kDescStepK,
                                db + k * kDescStepK);
      }
      wgmma_commit();
      // Keep this stage's wgmmas in flight while the next stage's issue;
      // once the previous stage's are done, the producer may refill it.
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < kAccRegs; ++i) fence_operand(acc[i]);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAccRegs; ++i) fence_operand(acc[i]);
    return true;
  }

  // f(row, col, v0, v1) for each of the thread's accumulator pairs: v0 at
  // (row, col), v1 at (row, col + 1), in tile coordinates (col even).
  template <typename F>
  __device__ __forceinline__ static void for_each_pair(
      const Acc (&acc)[kAccRegs], F&& f) {
    const int t = threadIdx.x % 128;
    const int row = (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      f(row, 8 * j + col, acc[4 * j], acc[4 * j + 1]);
      f(row + 8, 8 * j + col, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
};

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no -lcuda); null if the driver does not have it.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major [rows, K] operand for Mainloop: boxes of
// 128 bytes of K by box_rows rows, 128-byte swizzle, zeros past the edges
// (row_bytes 64: boxes of 64 bytes of K, 64-byte swizzle, for
// smem_desc_sw64; row_bytes 32: boxes of 32 bytes, 32-byte swizzle, K13
// f32's v8 boxes). K * element size must be a multiple of 16 and ptr
// 16-byte aligned. A failed encode prints its CUresult and returns
// cudaErrorInvalidValue.
inline cudaError_t encode_kmajor(CUtensorMap* map, const void* ptr, int rows,
                                 int K, bool int8, int box_rows,
                                 int row_bytes = 128) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) {
    fprintf(stderr, "nvt: the driver has no cuTensorMapEncodeTiled\n");
    return cudaErrorNotSupported;
  }
  const size_t esize = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(K) * esize};
  const cuuint32_t box[2] = {cuuint32_t(row_bytes / esize),
                             cuuint32_t(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map,
      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      row_bytes == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) {
    fprintf(stderr,
            "nvt: cuTensorMapEncodeTiled failed with CUresult %d ([%d, %d] "
            "%s, box %d rows)\n",
            static_cast<int>(res), rows, K, int8 ? "int8" : "bf16", box_rows);
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// The tensor map of a row-major bf16 B [K, N] that Mainloop<..., true>
// reads MN-major: boxes of 64 columns (128 bytes) by 64 rows of K. N must
// be a multiple of 8 and ptr 16-byte aligned. Failures as encode_kmajor's.
inline cudaError_t encode_mnmajor(CUtensorMap* map, const void* ptr, int K,
                                  int N) {
  return encode_kmajor(map, ptr, K, N, false, 64);
}

// The tensor map of a rank-4 bf16 (or, with f32, f32) tensor: dims
// innermost first, byte strides of dims 1-3, a box of `box` elements per
// dim (box[0] times the element size <= 128), 128-byte swizzle, zeros past
// the edges on loads; a store writes nothing past them. Failures as
// encode_kmajor's.
inline cudaError_t encode_4d(CUtensorMap* map, const void* ptr,
                             const cuuint64_t (&dims)[4],
                             const cuuint64_t (&strides)[3],
                             const cuuint32_t (&box)[4], bool f32) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) {
    fprintf(stderr, "nvt: the driver has no cuTensorMapEncodeTiled\n");
    return cudaErrorNotSupported;
  }
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) {
    fprintf(stderr,
            "nvt: cuTensorMapEncodeTiled failed with CUresult %d (%s "
            "[%llu, %llu, %llu, %llu], box [%u, %u, %u, %u])\n",
            static_cast<int>(res), f32 ? "f32" : "bf16",
            static_cast<unsigned long long>(dims[3]),
            static_cast<unsigned long long>(dims[2]),
            static_cast<unsigned long long>(dims[1]),
            static_cast<unsigned long long>(dims[0]), box[3], box[2], box[1],
            box[0]);
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

inline cudaError_t encode_bf16_4d(CUtensorMap* map, const void* ptr,
                                  const cuuint64_t (&dims)[4],
                                  const cuuint64_t (&strides)[3],
                                  const cuuint32_t (&box)[4]) {
  return encode_4d(map, ptr, dims, strides, box, false);
}

}  // namespace hopper
}  // namespace nvt
