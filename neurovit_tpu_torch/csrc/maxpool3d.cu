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
// arithmetic worth counting. The design moves each of those bytes between
// device memory and the SM once (ops/maxpool3d.py pool_plan lays it out):
//
// - A work item is one batch item, a band of R output rows (the backward:
//   the 2R input rows below them), a tile of columns and channels (all of
//   them at the stem's shape) and a run of output depths. A persistent
//   grid of blocks takes items i, i + grid, ...; each walks its run of od
//   in order, a loop in place of the TPU's sequential depth axis, so there
//   is no grid limit along H or B * D.
// - The depth planes a step reads (the forward: the band's 2R + 1 input
//   rows at one depth; the backward: the band's R + 1 rows of g and of the
//   codes at one od) are staged in a ring of slots in shared memory, each
//   row by one cp.async.bulk (a 1-D bulk copy: no tensor map) completing on
//   the slot's mbarrier, issued as soon as a slot frees, the next item's
//   planes too, so copies are in flight while the block computes. Shapes
//   whose rows are not 16-byte runs (C = 3, say) stage the same layout by
//   ordinary loads.
// - Forward step od: each staged element's depth combine (planes 2od - 1,
//   2od, 2od + 1), written in place over plane 2od with its kd in a code
//   buffer, a thread to each (column, 8 channels) down the rows; plane
//   2od - 1's slot then refills while the 9-tap chain of each output runs
//   from shared memory, out and the codes stored 16 and 8 bytes a thread.
//   bf16 compares and maxima run two lanes an instruction. Plane 2od + 1
//   stays for the next step as its kd = 0.
// - Backward step od: dx of input depths 2od and 2od + 1 from planes od
//   and od + 1 in shared memory only, each element gathering its covering
//   windows' g where the code names it, in increasing code order, without
//   branches or atomics; dx stored 16 bytes a thread, so no store waits on
//   a load.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper_gemm.cuh"

namespace nvt {
namespace {

using hopper::fence_proxy_async;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_init_fence;
using hopper::mbar_wait;

// 384 threads: the stem's row is 45 columns x 8 channel groups = 360
// (column, group) pairs, one a thread.
constexpr int kThreads = 384;
// Shared memory past the barriers: the ring's Cursor.
constexpr int kCursorBytes = 128;
constexpr size_t kSmemLimit = 232448;

// A thread owns V consecutive channels: V = 8 (16-byte bf16 loads and
// stores, 8-byte codes) when the channels and their tile are multiples of
// 8, else 1.
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

// bf16 pairs as 32-bit words: compares and maxima two lanes an instruction
// (sm_90's set.gt.u32.bf16x2 and max.NaN.bf16x2), the same order as
// comparing in f32; the lanes' codes as 16-bit halves of a word.
constexpr uint32_t kNegInf2 = 0xff80ff80u;    // -inf, -inf

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, 4);
  return h;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// 0xffff in each lane where a > b (false when either is NaN).
__device__ __forceinline__ uint32_t gt_mask(uint32_t a, uint32_t b) {
  return __hgt2_mask(as_bf2(a), as_bf2(b));
}

// nan_max lane by lane.
__device__ __forceinline__ uint32_t max_nan(uint32_t a, uint32_t b) {
  return as_u32(__hmax2_nan(as_bf2(a), as_bf2(b)));
}

// Four words of 16-bit lanes (values < 256) <-> eight bytes, lane order.
__device__ __forceinline__ uint2 pack_lanes(const uint32_t* w) {
  return make_uint2(__byte_perm(w[0], w[1], 0x6420),
                    __byte_perm(w[2], w[3], 0x6420));
}

__device__ __forceinline__ void unpack_lanes(uint2 b, uint32_t* w) {
  w[0] = __byte_perm(b.x, 0, 0x4140);
  w[1] = __byte_perm(b.x, 0, 0x4342);
  w[2] = __byte_perm(b.y, 0, 0x4140);
  w[3] = __byte_perm(b.y, 0, 0x4342);
}

__host__ __device__ __forceinline__ int out_dim(int n) {
  return (n - 1) / 2 + 1;
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; the bytes complete on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A pass's walk of x [B, D, H, W, C] (ops/maxpool3d.py PoolPass): the tile
// (rows R, cols TW, chans CT), the depth chunks, the ring, and what follows
// from them. Items are numbered band fastest, then the column tile, the
// channel tile, the chunk and the batch item.
struct Walk {
  int B, D, H, W, C, OD, OH, OW;
  int rows, cols, chans, chunks, slots, bulk;
  int bands, wtiles, ctiles;
  long long items;
  int slot_rows;       // staged rows a slot holds
  int pitch, cpitch;   // bytes of a staged row: values, codes
  int slot_bytes;
};

// A work item's box, each range [lo, hi). Forward: it writes output rows
// [r0, r1) x columns [q0, q1) from input rows [sr0, sr1) x [sq0, sq1).
// Backward: it writes input rows [r0, r1) x [q0, q1) from output rows
// [sr0, sr1) x [sq0, sq1). Both: depths od0 .. od1 - 1, channels c0 ..
// c0 + cn - 1, and the depth planes p0 .. p1 - 1 it stages (the forward's
// input depths, the backward's output depths).
struct Item {
  int b, od0, od1, c0, cn, r0, r1, q0, q1, sr0, sr1, sq0, sq1, p0, p1;
};

template <bool kFwd>
__device__ __forceinline__ Item item_of(const Walk& k, long long i) {
  Item t;
  const int band = static_cast<int>(i % k.bands);
  i /= k.bands;
  const int wt = static_cast<int>(i % k.wtiles);
  i /= k.wtiles;
  const int ct = static_cast<int>(i % k.ctiles);
  i /= k.ctiles;
  const int chunk = static_cast<int>(i % k.chunks);
  t.b = static_cast<int>(i / k.chunks);
  t.od0 = static_cast<int>(static_cast<long long>(chunk) * k.OD / k.chunks);
  t.od1 = static_cast<int>(static_cast<long long>(chunk + 1) * k.OD /
                           k.chunks);
  t.c0 = ct * k.chans;
  t.cn = min(k.chans, k.C - t.c0);
  if constexpr (kFwd) {
    t.r0 = band * k.rows;
    t.r1 = min(k.OH, t.r0 + k.rows);
    t.q0 = wt * k.cols;
    t.q1 = min(k.OW, t.q0 + k.cols);
    t.sr0 = max(0, 2 * t.r0 - 1);
    t.sr1 = min(k.H, 2 * t.r1);
    t.sq0 = max(0, 2 * t.q0 - 1);
    t.sq1 = min(k.W, 2 * t.q1);
    t.p0 = max(0, 2 * t.od0 - 1);
    t.p1 = min(k.D, 2 * t.od1);
  } else {
    t.r0 = 2 * k.rows * band;
    t.r1 = min(k.H, t.r0 + 2 * k.rows);
    t.q0 = 2 * k.cols * wt;
    t.q1 = min(k.W, t.q0 + 2 * k.cols);
    t.sr0 = t.r0 / 2;
    t.sr1 = min(k.OH, t.r1 / 2 + 1);
    t.sq0 = t.q0 / 2;
    t.sq1 = min(k.OW, t.q1 / 2 + 1);
    t.p0 = t.od0;
    t.p1 = min(t.od1 + 1, k.OD);
  }
  return t;
}

// Stage rows [sr0, sr1) x columns [sq0, sq1) x channels [c0, c0 + cn) of
// the [n, rows, cols, C] tensor `src` at depth plane `p` of batch item b
// (n depths a batch item) into `dst`, a row every `pitch` bytes, a column
// every `chans` elements. Bulk: whole rows (all columns and channels) are
// one copy each, else each column's channel run is; threads 0 .. kLanes -
// 1 only, a copy a thread. Else every thread copies elements, and the
// caller synchronises.
template <typename E, int kLanes>
__device__ __forceinline__ void stage_rows(const Walk& k, const Item& t,
                                           const E* src, int n, int rows,
                                           int cols, int p, uint8_t* dst,
                                           int pitch, uint64_t* bar) {
  const int nr = t.sr1 - t.sr0, nc = t.sq1 - t.sq0;
  const E* plane = src + ((static_cast<int64_t>(t.b) * n + p) * rows) *
                             cols * k.C;
  const bool whole = k.chans == k.C;
  if (k.bulk) {
    const uint32_t seg = static_cast<uint32_t>(
        (whole ? nc * k.C : t.cn) * sizeof(E));
    const int per_row = whole ? 1 : nc;
    for (int e = threadIdx.x; e < nr * per_row; e += kLanes) {
      const int r = e / per_row, j = e - r * per_row;
      bulk_load(dst + r * pitch + j * k.chans * sizeof(E),
                plane + (static_cast<int64_t>(t.sr0 + r) * cols + t.sq0 +
                         j) * k.C + t.c0,
                seg, bar);
    }
    return;
  }
  const int per_row = nc * t.cn;
  for (int e = threadIdx.x; e < nr * per_row; e += blockDim.x) {
    const int r = e / per_row, rem = e - r * per_row;
    const int j = rem / t.cn, c = rem - j * t.cn;
    reinterpret_cast<E*>(dst + r * pitch)[j * k.chans + c] =
        plane[(static_cast<int64_t>(t.sr0 + r) * cols + t.sq0 + j) * k.C +
              t.c0 + c];
  }
}

// A slot of the ring and the parity of the phase in which its plane lands.
// Steps move it a plane or two, so no division is made on the way.
struct Slot {
  int idx;
  uint32_t parity;

  __device__ Slot next(int slots) const {
    return idx + 1 == slots ? Slot{0, parity ^ 1u} : Slot{idx + 1, parity};
  }
  __device__ Slot prev(int slots) const {
    return idx == 0 ? Slot{slots - 1, parity ^ 1u} : Slot{idx - 1, parity};
  }
  __device__ Slot plus(int n, int slots) const {    // n >= 0
    const int q = idx + n;
    return Slot{q % slots, parity ^ (static_cast<uint32_t>(q / slots) & 1u)};
  }
};

// Where staging stands, in shared memory, so that no thread keeps it in
// registers: the next item (decoded) and its next plane, the slot that
// plane goes to, and the planes staged so far. Thread 0 alone moves it.
struct Cursor {
  long long item, loaded;
  int plane, slot;
  Item next;
};
static_assert(sizeof(Cursor) <= kCursorBytes, "the cursor's shared memory");

// The ring: this block's stream of depth planes, item after item, each in
// the slot after the one before, its barriers at `full` and its Cursor
// after them. `loaded` planes are staged or in flight, `released` are read
// for the last time. refill() fills every free slot, the next items'
// planes too, each item decoded once. With bulk copies threads 0 .. kLanes
// - 1 of warp 0 stage (thread 0 arms the slot's barrier, each issues
// copies; 32 in K14, whose plane is 2R + 1 rows, 1 in K15, whose plane is
// 2R + 2 small ones and whose registers are the scarcer) and the others
// wait on the slot's barrier; with ordinary loads every thread copies, a
// plane at a time. Construct it before the block's first __syncthreads.
template <bool kFwd, typename T, int kLanes>
struct Ring {
  const Walk& k;
  uint8_t* smem;
  uint64_t* full;
  Cursor* cur;
  long long released = 0;

  __device__ Ring(const Walk& walk, uint8_t* s, uint64_t* bars)
      : k(walk), smem(s), full(bars),
        cur(reinterpret_cast<Cursor*>(bars + walk.slots)) {
    if (threadIdx.x == 0) {
      if (k.bulk) {
        for (int i = 0; i < k.slots; ++i) mbar_init(&full[i], 1);
        mbar_init_fence();
      }
      cur->item = blockIdx.x, cur->loaded = 0;
      cur->plane = cur->slot = 0;
      if (cur->item < k.items) cur->next = item_of<kFwd>(k, cur->item);
    }
  }

  __device__ uint8_t* at(Slot s) const { return smem + s.idx * k.slot_bytes; }

  // One plane into the next slot, if one is free; false if none is.
  template <typename Src>
  __device__ bool stage_one(const Src& src) {
    if (cur->loaded >= released + k.slots || cur->item >= k.items)
      return false;
    const Item& t = cur->next;
    uint8_t* dst = smem + cur->slot * k.slot_bytes;
    uint64_t* bar = &full[cur->slot];
    if (k.bulk) {
      const uint32_t elems = static_cast<uint32_t>(t.sr1 - t.sr0) *
                             (t.sq1 - t.sq0) * t.cn;
      if (threadIdx.x == 0)
        mbar_expect_tx(bar, elems * (kFwd ? sizeof(T) : sizeof(T) + 1));
      if (kLanes > 1) __syncwarp(0xffffffffu >> (32 - kLanes));
    }
    src(t, t.p0 + cur->plane, dst, bar);
    return true;
  }

  __device__ void advance() {
    ++cur->loaded;
    if (++cur->slot == k.slots) cur->slot = 0;
    if (++cur->plane == cur->next.p1 - cur->next.p0) {
      cur->plane = 0;
      cur->item += gridDim.x;
      if (cur->item < k.items) cur->next = item_of<kFwd>(k, cur->item);
    }
  }

  // Before the first step and after every step: fill the freed slots.
  template <typename Src>
  __device__ void refill(const Src& src) {
    if (k.bulk) {
      if (threadIdx.x >= kLanes) return;
      while (stage_one(src)) {
        if (kLanes > 1) __syncwarp(0xffffffffu >> (32 - kLanes));
        if (threadIdx.x == 0) advance();
        if (kLanes > 1) __syncwarp(0xffffffffu >> (32 - kLanes));
      }
      return;
    }
    __syncthreads();    // the cursor as thread 0 left it
    while (stage_one(src)) {
      __syncthreads();
      if (threadIdx.x == 0) advance();
      __syncthreads();
    }
  }

  __device__ void wait(Slot s) const {
    if (k.bulk) mbar_wait(&full[s.idx], s.parity);
  }
};

// The depth combine of V channels at one staged (h, w): x0 (null outside
// the tensor: -inf), x1, x2 (null outside), the value written over x1 and
// each lane's kd into kd.
template <typename T, int V>
__device__ __forceinline__ void combine(const T* x0, T* x1, const T* x2,
                                        uint8_t* kd) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && V == 8) {
    const uint4 a = x0 ? *reinterpret_cast<const uint4*>(x0)
                       : make_uint4(kNegInf2, kNegInf2, kNegInf2, kNegInf2);
    const uint4 b = *reinterpret_cast<const uint4*>(x1);
    uint32_t v[4] = {a.x, a.y, a.z, a.w}, row[4] = {b.x, b.y, b.z, b.w};
    uint32_t code[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      code[i] = gt_mask(row[i], v[i]) & 0x00010001u;
      v[i] = max_nan(v[i], row[i]);
    }
    if (x2) {
      const uint4 c = *reinterpret_cast<const uint4*>(x2);
      const uint32_t r2[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t m = gt_mask(r2[i], v[i]);
        code[i] = (m & 0x00020002u) | (code[i] & ~m);
        v[i] = max_nan(v[i], r2[i]);
      }
    }
    *reinterpret_cast<uint4*>(x1) = make_uint4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint2*>(kd) = pack_lanes(code);
  } else {
    float v[V], row[V];
    int code[V];
    if (x0) {
      load_f32<V>(x0, v);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = -INFINITY;
    }
    load_f32<V>(x1, row);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      code[q] = row[q] > v[q] ? 1 : 0;
      v[q] = nan_max(v[q], row[q]);
    }
    if (x2) {
      load_f32<V>(x2, row);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (row[q] > v[q]) code[q] = 2;
        v[q] = nan_max(v[q], row[q]);
      }
    }
    store_f32<V>(x1, v);
    store_codes<V>(kd, code);
  }
}

// The 9-tap chain of output (oh, ow), channels c .. c + V - 1 of the
// item, from the combined plane `comb` and its kd codes; out and the codes
// to `out` and `code`.
template <typename T, int V>
__device__ __forceinline__ void taps(const T* comb, const uint8_t* kd_buf,
                                     const Walk& k, const Item& t, int oh,
                                     int ow, int c, int pitch_e, T* out,
                                     uint8_t* code) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && V == 8) {
    uint32_t best[4], best_code[4];
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int h = 2 * oh - 1 + kh;
      const bool hv = h >= t.sr0 && h < t.sr1;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int w = 2 * ow - 1 + kw;
        const uint32_t tap = (3 * kh + kw) * 0x00010001u;
        uint32_t v[4], tc[4];
        if (hv && w >= t.sq0 && w < t.sq1) {
          const int r = h - t.sr0, j = w - t.sq0;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              comb + r * pitch_e + j * k.chans + c);
          v[0] = raw.x, v[1] = raw.y, v[2] = raw.z, v[3] = raw.w;
          unpack_lanes(*reinterpret_cast<const uint2*>(
                           kd_buf + r * k.cpitch + j * k.chans + c),
                       tc);
#pragma unroll
          for (int i = 0; i < 4; ++i) tc[i] = tc[i] * 9u + tap;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = kNegInf2, tc[i] = tap;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (kh == 0 && kw == 0) {
            best[i] = v[i];
            best_code[i] = tc[i];
          } else {
            const uint32_t m = gt_mask(v[i], best[i]);
            best_code[i] = (tc[i] & m) | (best_code[i] & ~m);
            best[i] = max_nan(best[i], v[i]);
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(out) =
        make_uint4(best[0], best[1], best[2], best[3]);
    *reinterpret_cast<uint2*>(code) = pack_lanes(best_code);
  } else {
    float best[V];
    int best_code[V];
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int h = 2 * oh - 1 + kh;
      const bool hv = h >= t.sr0 && h < t.sr1;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int w = 2 * ow - 1 + kw;
        const int tap = 3 * kh + kw;
        float v[V];
        int kd[V];
        if (hv && w >= t.sq0 && w < t.sq1) {
          const int r = h - t.sr0, j = w - t.sq0;
          load_f32<V>(comb + r * pitch_e + j * k.chans + c, v);
          load_codes<V>(kd_buf + r * k.cpitch + j * k.chans + c, kd);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q) v[q] = -INFINITY, kd[q] = 0;
        }
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int tap_code = 9 * kd[q] + tap;
          if (tap == 0) {
            best[q] = v[q];
            best_code[q] = tap_code;
          } else {
            if (v[q] > best[q]) best_code[q] = tap_code;
            best[q] = nan_max(best[q], v[q]);
          }
        }
      }
    }
    store_f32<V>(out, best);
    store_codes<V>(code, best_code);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
    pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                    uint8_t* __restrict__ code, const Walk k) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* kd_buf = smem + static_cast<size_t>(k.slots) * k.slot_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      kd_buf + static_cast<size_t>(k.slot_rows) * k.cpitch);
  Ring<true, T, 32> ring(k, smem, full);
  __syncthreads();
  const auto src = [&](const Item& t, int d, uint8_t* dst, uint64_t* bar) {
    stage_rows<T, 32>(k, t, x, k.D, k.H, k.W, d, dst, k.pitch, bar);
  };
  const int pitch_e = k.pitch / static_cast<int>(sizeof(T));
  ring.refill(src);
  long long base = 0;    // stream index of the item's plane p0
  Slot base_slot{0, 0u};
  for (long long i = blockIdx.x; i < k.items; i += gridDim.x) {
    const Item t = item_of<true>(k, i);
    const int nr = t.sr1 - t.sr0, nc = t.sq1 - t.sq0, groups = t.cn / V;
    Slot cur = base_slot.plus(2 * t.od0 - t.p0, k.slots);    // plane 2od
    for (int od = t.od0; od < t.od1; ++od, cur = cur.next(k.slots).next(
                                               k.slots)) {
      const int d1 = 2 * od;    // kd = 1, always inside
      const bool has0 = d1 > 0, has2 = d1 + 1 < k.D;
      const Slot prev = cur.prev(k.slots), next = cur.next(k.slots);
      if (has0) ring.wait(prev);
      ring.wait(cur);
      if (has2) ring.wait(next);
      T* p1 = reinterpret_cast<T*>(ring.at(cur));
      const T* p0 = has0 ? reinterpret_cast<const T*>(ring.at(prev)) : p1;
      const T* p2 = has2 ? reinterpret_cast<const T*>(ring.at(next)) : p1;
      // Depth combine of every staged (h, w): the lowest kd keeps a tie;
      // the value over plane 2od, kd into kd_buf. A thread takes one
      // (column, channel group) down every staged row.
      for (int q = threadIdx.x; q < nc * groups; q += kThreads) {
        const int j = q / groups, cg = q - j * groups;
        const int col = j * k.chans + cg * V;
        for (int r = 0; r < nr; ++r) {
          const int off = r * pitch_e + col;
          combine<T, V>(has0 ? p0 + off : nullptr, p1 + off,
                        has2 ? p2 + off : nullptr,
                        kd_buf + r * k.cpitch + col);
        }
      }
      // Plane 2od - 1 is read for the last time: its slot refills while
      // the taps run (the async proxy's copy after this step's generic
      // reads of it).
      if (has0) ring.released = base + d1 - t.p0;
      fence_proxy_async();
      __syncthreads();
      if (has0) ring.refill(src);
      // The 9 taps of each output in row-major order, strict '>'; -inf
      // (code kd = 0) outside the tensor.
      const int orow = (t.q1 - t.q0) * groups;
      for (int e = threadIdx.x; e < (t.r1 - t.r0) * orow; e += kThreads) {
        const int i_r = e / orow, rem = e - i_r * orow;
        const int jo = rem / groups, cg = rem - jo * groups;
        const int oh = t.r0 + i_r, ow = t.q0 + jo;
        const int64_t o = (((static_cast<int64_t>(t.b) * k.OD + od) * k.OH +
                            oh) * k.OW + ow) * k.C + t.c0 + cg * V;
        taps<T, V>(p1, kd_buf, k, t, oh, ow, cg * V, pitch_e, out + o,
                   code + o);
      }
      // Planes up to 2od are read for the last time (all of the item's at
      // its last step); the async proxy's copies into them come after
      // this step's generic writes.
      ring.released = base + (od + 1 == t.od1 ? t.p1 - t.p0 : d1 - t.p0 + 1);
      fence_proxy_async();
      __syncthreads();
      ring.refill(src);
    }
    base += t.p1 - t.p0;
    base_slot = base_slot.plus(t.p1 - t.p0, k.slots);
  }
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

// 0xff in each byte of x that is zero, 0 in the others (exact: no carry
// crosses a byte).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  const uint32_t t = ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu;
  return (~t >> 7) * 0xffu;
}

// Add to acc, lane by lane, the g of V channels of one window where its
// code is `want`, and 0 elsewhere (acc + 0 is acc: acc is never -0). No
// branch, so a thread's loads of all its windows issue together.
template <typename T, int V>
__device__ __forceinline__ void gather(const uint8_t* codes, const T* g,
                                       int want, float* acc) {
  if constexpr (V == 8) {
    const uint2 cw = *reinterpret_cast<const uint2*>(codes);
    const uint32_t w4 = 0x01010101u * static_cast<uint32_t>(want);
    const uint32_t z[2] = {zero_bytes(cw.x ^ w4), zero_bytes(cw.y ^ w4)};
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g);
      const uint32_t gw[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // Lanes 2i and 2i + 1: bytes 2i and 2i + 1 of the codes.
        const uint32_t m =
            __byte_perm(z[i / 2], 0, (i & 1) ? 0x3322 : 0x1100);
        const uint32_t sel = gw[i] & m;
        acc[2 * i] += __uint_as_float(sel << 16);
        acc[2 * i + 1] += __uint_as_float(sel & 0xffff0000u);
      }
    } else {
      float gv[8];
      load_f32<8>(g, gv);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t m = __byte_perm(z[q / 4], 0, (q % 4) * 0x1111);
        acc[q] += __uint_as_float(__float_as_uint(gv[q]) & m);
      }
    }
  } else {
    if (*codes == want) {
      float gv;
      load_f32<1>(g, &gv);
      acc[0] += gv;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    pool_bwd_kernel(const uint8_t* __restrict__ code,
                    const T* __restrict__ g, T* __restrict__ dx,
                    const Walk k) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(k.slots) * k.slot_bytes);
  Ring<false, T, 1> ring(k, smem, full);
  __syncthreads();
  const int codes_at = k.slot_rows * k.pitch;    // a slot: g, then codes
  const auto src = [&](const Item& t, int od, uint8_t* dst, uint64_t* bar) {
    stage_rows<T, 1>(k, t, g, k.OD, k.OH, k.OW, od, dst, k.pitch, bar);
    stage_rows<uint8_t, 1>(k, t, code, k.OD, k.OH, k.OW, od, dst + codes_at,
                           k.cpitch, bar);
  };
  ring.refill(src);
  long long base = 0;
  Slot cur{0, 0u};       // plane od
  for (long long i = blockIdx.x; i < k.items; i += gridDim.x) {
    const Item t = item_of<false>(k, i);
    const int nr = t.r1 - t.r0, nc = t.q1 - t.q0, groups = t.cn / V;
    for (int od = t.od0; od < t.od1; ++od, cur = cur.next(k.slots)) {
      const bool hi = od + 1 < k.OD;    // plane od + 1: kd = 0 of 2od + 1
      const Slot next = cur.next(k.slots);
      ring.wait(cur);
      if (hi) ring.wait(next);
      const uint8_t* lo = ring.at(cur);
      const uint8_t* up = hi ? ring.at(next) : lo;
      const int nd = 2 * od + 1 < k.D ? 2 : 1;
      // A thread takes one (column, channel group) down both depths and
      // every row; the covering windows in increasing code order. Depth:
      // input 2od by kd = 1 of plane od; 2od + 1 by kd = 0 of plane od + 1
      // (if any), then kd = 2 of plane od. The even columns (one window
      // along w) come first, then the odd ones (two), so a warp's threads
      // have the same windows.
      const int evens = (nc + 1) / 2;
      for (int q = threadIdx.x; q < nc * groups; q += kThreads) {
        const int rank = q / groups, cg = q - rank * groups;
        const int w =
            t.q0 + (rank < evens ? 2 * rank : 2 * (rank - evens) + 1);
        int ow[2], kw[2];
        cover(w, k.OW, ow, kw);
        int col[2];
#pragma unroll
        for (int f = 0; f < 2; ++f)
          col[f] = (ow[f] - t.sq0) * k.chans + cg * V;
        // Both depths and two rows at a time unrolled: independent loads
        // and sums for the scheduler to interleave.
#pragma unroll
        for (int dd = 0; dd < 2; ++dd) {
          if (dd >= nd) break;
          const uint8_t* pd[2] = {dd ? up : lo, lo};
          const int kd[2] = {dd ? 0 : 1, 2};
          const bool dv[2] = {dd == 0 || hi, dd == 1};
          T* dst = dx + (((static_cast<int64_t>(t.b) * k.D + 2 * od + dd) *
                          k.H + t.r0) * k.W + w) * k.C + t.c0 + cg * V;
#pragma unroll 2
          for (int r = 0; r < nr; ++r, dst += static_cast<int64_t>(k.W) *
                                             k.C) {
            int oh[2], kh[2];
            cover(t.r0 + r, k.OH, oh, kh);
            float acc[V];
#pragma unroll
            for (int q2 = 0; q2 < V; ++q2) acc[q2] = 0.f;
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              if (!dv[a]) continue;
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                if (oh[b] < 0) continue;
                const int row = oh[b] - t.sr0;
                const uint8_t* cs = pd[a] + codes_at + row * k.cpitch;
                const T* gs = reinterpret_cast<const T*>(pd[a] +
                                                         row * k.pitch);
#pragma unroll
                for (int f = 0; f < 2; ++f) {
                  if (ow[f] < 0) continue;
                  gather<T, V>(cs + col[f], gs + col[f],
                               9 * kd[a] + 3 * kh[b] + kw[f], acc);
                }
              }
            }
            store_f32<V>(dst, acc);
          }
        }
      }
      ring.released = base + (od + 1 == t.od1 ? t.p1 - t.p0 : od - t.p0 + 1);
      __syncthreads();
      ring.refill(src);
    }
    base += t.p1 - t.p0;
    if (t.p1 - t.p0 > t.od1 - t.od0) cur = cur.next(k.slots);   // od1's
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Whether every staged segment starts on 16 bytes and is a multiple of 16
// long: whole rows of row_elems, or runs of `chans` at a stride of C.
bool bulk_ok(int64_t row_elems, int C, int chans, bool whole_rows,
             int elt) {
  if (whole_rows && chans == C) return row_elems * elt % 16 == 0;
  return static_cast<int64_t>(C) * elt % 16 == 0 &&
         static_cast<int64_t>(chans) * elt % 16 == 0;
}

// The walk of pass kFwd and its shared memory, or false where the fields
// do not describe one (ops/maxpool3d.py pool_plan makes them).
bool make_walk(bool fwd, int B, int D, int H, int W, int C, int elt,
               int rows, int cols, int chans, int chunks, int slots,
               int bulk, Walk* k, size_t* smem) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || C < 1 || rows < 1 || cols < 1 ||
      chans < 1 || chans > C || chunks < 1 || slots < (fwd ? 3 : 2))
    return false;
  k->B = B, k->D = D, k->H = H, k->W = W, k->C = C;
  k->OD = out_dim(D), k->OH = out_dim(H), k->OW = out_dim(W);
  if (chunks > k->OD || rows > k->OH || cols > k->OW) return false;
  k->rows = rows, k->cols = cols, k->chans = chans, k->chunks = chunks;
  k->slots = slots, k->bulk = bulk;
  k->bands = ceil_div(k->OH, rows);
  k->wtiles = ceil_div(k->OW, cols);
  k->ctiles = ceil_div(C, chans);
  k->items = static_cast<long long>(B) * chunks * k->ctiles * k->wtiles *
             k->bands;
  const bool whole = cols >= k->OW;
  int64_t srows, scols;
  if (fwd) {
    srows = std::min(H, 2 * rows + 1), scols = std::min(W, 2 * cols + 1);
    if (bulk && !bulk_ok(static_cast<int64_t>(W) * C, C, chans, whole, elt))
      return false;
  } else {
    srows = std::min(k->OH, rows + 1), scols = std::min(k->OW, cols + 1);
    if (bulk && !(bulk_ok(static_cast<int64_t>(k->OW) * C, C, chans, whole,
                          elt) &&
                  bulk_ok(static_cast<int64_t>(k->OW) * C, C, chans, whole,
                          1)))
      return false;
  }
  const size_t pitch = round_up(scols * chans * elt, 16);
  const size_t cpitch = round_up(scols * chans, 16);
  const size_t slot = srows * (fwd ? pitch : pitch + cpitch);
  *smem = slots * slot + (fwd ? srows * cpitch : 0) + 8 * slots +
          kCursorBytes;
  if (*smem > kSmemLimit) return false;
  k->slot_rows = static_cast<int>(srows);
  k->pitch = static_cast<int>(pitch), k->cpitch = static_cast<int>(cpitch);
  k->slot_bytes = static_cast<int>(slot);
  return true;
}

template <typename T, int V>
int launch_fwd(const void* x, void* out, void* code, const Walk& k,
               size_t smem, int grid, cudaStream_t stream) {
  const auto kernel = pool_fwd_kernel<T, V>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<uint8_t*>(code), k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_bwd(const void* code, const void* g, void* dx, const Walk& k,
               size_t smem, int grid, cudaStream_t stream) {
  const auto kernel = pool_bwd_kernel<T, V>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(code), static_cast<const T*>(g),
      static_cast<T*>(dx), k);
  return static_cast<int>(cudaGetLastError());
}

bool vec8(const Walk& k) { return k.C % 8 == 0 && k.chans % 8 == 0; }

}  // namespace
}  // namespace nvt

// x [B, D, H, W, C]; out [B, OD, OH, OW, C] of x's dtype, code the same
// shape in uint8; O = (n - 1) / 2 + 1. is_bf16: bf16, else f32. rows ..
// grid: ops/maxpool3d.py pool_plan's K14 walk (rows, cols, chans, chunks,
// slots, bulk, grid).
extern "C" int nvt_maxpool3d_fwd(const void* x, void* out, void* code,
                                 int B, int D, int H, int W, int C,
                                 int is_bf16, int rows, int cols, int chans,
                                 int chunks, int slots, int bulk, int grid,
                                 void* stream) {
  nvt::Walk k;
  size_t smem;
  if (grid < 1 || !nvt::make_walk(true, B, D, H, W, C, is_bf16 ? 2 : 4, rows,
                                  cols, chans, chunks, slots, bulk, &k,
                                  &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return nvt::vec8(k)
               ? nvt::launch_fwd<__nv_bfloat16, 8>(x, out, code, k, smem,
                                                   grid, s)
               : nvt::launch_fwd<__nv_bfloat16, 1>(x, out, code, k, smem,
                                                   grid, s);
  return nvt::vec8(k)
             ? nvt::launch_fwd<float, 8>(x, out, code, k, smem, grid, s)
             : nvt::launch_fwd<float, 1>(x, out, code, k, smem, grid, s);
}

// code [B, OD, OH, OW, C] uint8 and g of that shape; dx [B, D, H, W, C] of
// g's dtype; rows .. grid: pool_plan's K15 walk.
extern "C" int nvt_maxpool3d_bwd(const void* code, const void* g, void* dx,
                                 int B, int D, int H, int W, int C,
                                 int is_bf16, int rows, int cols, int chans,
                                 int chunks, int slots, int bulk, int grid,
                                 void* stream) {
  nvt::Walk k;
  size_t smem;
  if (grid < 1 || !nvt::make_walk(false, B, D, H, W, C, is_bf16 ? 2 : 4,
                                  rows, cols, chans, chunks, slots, bulk, &k,
                                  &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return nvt::vec8(k)
               ? nvt::launch_bwd<__nv_bfloat16, 8>(code, g, dx, k, smem,
                                                   grid, s)
               : nvt::launch_bwd<__nv_bfloat16, 1>(code, g, dx, k, smem,
                                                   grid, s);
  return nvt::vec8(k)
             ? nvt::launch_bwd<float, 8>(code, g, dx, k, smem, grid, s)
             : nvt::launch_bwd<float, 1>(code, g, dx, k, smem, grid, s);
}

// The shared memory a block of each pass takes at these walk fields (what
// the launch asks for), or -1 where the fields describe no walk.
extern "C" long long nvt_maxpool3d_smem_bytes(int fwd, int H, int W, int C,
                                              int is_bf16, int rows,
                                              int cols, int chans,
                                              int slots) {
  nvt::Walk k;
  size_t smem;
  if (!nvt::make_walk(fwd != 0, 1, 1, H, W, C, is_bf16 ? 2 : 4, rows, cols,
                      chans, 1, slots, 0, &k, &smem))
    return -1;
  return static_cast<long long>(smem);
}
