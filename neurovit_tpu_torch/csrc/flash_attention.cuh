// Pieces the attention forward (flash_attention.cu, K1/K6) and backward
// (flash_attention_bwd.cu, K5/K6's backward) share on TMA + wgmma: the
// tile geometry, the exp2 and the bf16 pairs of an accumulator, boxes of a
// rank-4 [.., D] tensor in either layout, the grid's order, and the quad's
// shared Philox window of a row of queries.
#pragma once

#include "hopper_gemm.cuh"

namespace nvt {
namespace flash {

constexpr int kBKV = 64;                     // keys per tile
constexpr int kRowBytes = 128;               // one swizzled row: 64 bf16
constexpr int kPanelBytes = 64 * kRowBytes;  // 64 rows x 64 columns
constexpr int kKStepBytes = 16 * kRowBytes;  // 16 rows of an MN-major tile
constexpr int kWindowBytes = 80;             // 5 Philox blocks of a row
constexpr float kScoreCap = 96.f;
// Blocks of 128 rows where they fill the card, else 64.
constexpr int kSMs = 132;

// Consumer warpgroups of a launch: two (128-row blocks) where those fill
// the card's SMs, else one.
inline int consumers(int B, int N, int H) {
  const long long tiles128 = static_cast<long long>(B) * H * ((N + 127) / 128);
  return tiles128 >= kSMs ? 2 : 1;
}

// The grid is one-dimensional: block x covers row tile x % tiles of head
// x / tiles, so a head's tiles run together and its operands stay in L2,
// and B * H is bounded by the grid's x (2^31 - 1), not its y.
struct GridTile {
  int bh, b, h, tile;
  __device__ GridTile(int tiles, int H) {
    const int x = blockIdx.x;
    bh = x / tiles;
    tile = x - bh * tiles;
    b = bh / H;
    h = bh - b * H;
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An f32 accumulator of wgmma's m64nN layout rounded to bf16 pairs:
// pa[2 j + R] holds acc[4 j + 2 R] and acc[4 j + 2 R + 1], so pa[4 c .. 4 c
// + 3] is the A operand of the tile's k16 chunk c (WgmmaRegA64).
template <int kN>
__device__ __forceinline__ void pack_pairs(const float (&acc)[kN],
                                           uint32_t (&pa)[kN / 2]) {
#pragma unroll
  for (int k = 0; k < kN / 2; ++k)
    pa[k] = pack_bf16x2(acc[2 * k], acc[2 * k + 1]);
}

// 2^x in one MUFU op, subnormal results flushed to 0: none occur, since
// x >= -96 and 2^-96 is a normal f32.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float capped_exp2(float s, float scale_log2e) {
  return exp2_ftz(fminf(fmaxf(s * scale_log2e, -kScoreCap), kScoreCap));
}

// Load the 64-row, 64-column box at (column c0, token row n) of one head.
template <bool kBhnd>
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int n, int h,
                                         int b) {
  if constexpr (kBhnd)
    hopper::tma_load_4d(dst, map, bar, c0, n, h, b);
  else
    hopper::tma_load_4d(dst, map, bar, c0, h, n, b);
}

// Store a 64 x 64 box to (column c0, token row n) of one head.
template <bool kBhnd>
__device__ __forceinline__ void store_box(const CUtensorMap* map,
                                          const void* src, int c0, int n,
                                          int h, int b) {
  if constexpr (kBhnd)
    hopper::tma_store_4d(map, src, c0, n, h, b);
  else
    hopper::tma_store_4d(map, src, c0, h, n, b);
}

// Write the thread's part of a 64-row accumulator as bf16 into the
// 128-byte swizzled panels at `dst` (the 16-byte chunk j of row r sits at
// chunk j ^ (r % 8)), each value v of row r0 + 8 R as f(v, R).
template <int kPanels, typename F>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const float (&acc)[kPanels][32],
                                           int r0, int quad, F&& f) {
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int R = 0; R < 2; ++R) {
        const int r = r0 + 8 * R;
        *reinterpret_cast<uint32_t*>(dst + p * kPanelBytes + r * kRowBytes +
                                     ((j ^ (r % 8)) * 16) + 4 * quad) =
            pack_bf16x2(f(acc[p][4 * j + 2 * R], R),
                        f(acc[p][4 * j + 2 * R + 1], R));
      }
}

// The dropout bytes of a thread's two query rows (r0 and r0 + 8 of its
// warpgroup's 64) over one 64-key tile. A tile of one row lies in a window
// of five 16-byte Philox blocks (rows start at i = row * N, not on a block
// edge), the first of which is the previous tile's last. Thread t % 4 of
// the quad computes block t % 4 + 1 of each of its two rows' windows,
// thread 3 keeps the window's last block for the next tile, and the quad
// exchanges the words through a per-row window of 80 bytes in shared
// memory, from which each thread reads its bytes by position: win[R][8 j +
// e] is the byte of key 8 j + 2 (t % 4) + e of the tile. Two Philox calls a
// thread a tile, and no data-dependent branch.
struct QuadWindows {
  uint64_t blk0[2];
  const unsigned char* win[2];
  unsigned char* xrow[2];
  uint4 carry[2];
  int quad;

  // xs: the warpgroup's 64 windows; row0: its first query row's index
  // (b * H + h) * N + q of the head's [N, N] scores.
  __device__ QuadWindows(unsigned char* xs, uint64_t row0, int N, int r0,
                         int quad_, bool drop, uint64_t seed)
      : quad(quad_) {
#pragma unroll
    for (int R = 0; R < 2; ++R) {
      const uint64_t i0 =
          (row0 + r0 + 8 * R) * static_cast<uint64_t>(N);
      blk0[R] = i0 >> 4;
      xrow[R] = xs + (r0 + 8 * R) * kWindowBytes;
      win[R] = xrow[R] + (i0 & 15) + 2 * quad;
      carry[R] = make_uint4(0, 0, 0, 0);
      if (drop && quad == 3) carry[R] = philox4x32_10(blk0[R], seed);
    }
  }

  // Fill the windows of key tile t (every tile in order from 0).
  __device__ __forceinline__ void fill(int t, uint64_t seed) {
    __syncwarp();   // the quad has read the previous tile's
#pragma unroll
    for (int R = 0; R < 2; ++R) {
      const uint4 w = philox4x32_10(blk0[R] + 4 * t + quad + 1, seed);
      *reinterpret_cast<uint4*>(xrow[R] + 16 * (quad + 1)) = w;
      if (quad == 3) {
        *reinterpret_cast<uint4*>(xrow[R]) = carry[R];
        carry[R] = w;
      }
    }
    __syncwarp();
  }
};

}  // namespace flash
}  // namespace nvt
