// f32 GEMMs on the tensor cores by 3xTF32 on wgmma, for sm_90a: the
// mainloop of K4's f32 fc1 and fc2 (fused_mlp_f32.cu; K3 at f32,
// fused_outproj_f32.cu, is one launch of fc2, launch_fc2_residual below)
// and K2's f32 QKV product (fused_qkv_f32.cu), of the f32 backwards'
// products K8's dattn =
// dz . Wout (fused_outproj_bwd_f32.cu), K9's da = dz . W2
// (fused_mlp_bwd_f32.cu) and the du GEMM dh . W1 or dqkv . Wqkv of K9 and
// K7 (tf32x3_ln_bwd.cuh), and their weight pre-passes.
//
// Loop<kStages, kFreshStages>::run computes the 128 x 128 tile at (m0,
// n0) of A [M, K] . Bt^T in f32 from three K-major f32 operands in device
// memory: A [M, K] as it is (u, g, dz, dh or dqkv), and Bt [N, K] already
// split into Bt_big and Bt_small by a pre-pass (big = rna_tf32(w) and
// small = w - big, tf32x3.cuh's split, both [N, K]). wgmma takes TF32
// operands K-major only. The forwards' weights W1, W2 and Wqkv are torch
// Linear weights [N, K], K-major for their products as they lie:
// split_kernel splits them element by element. The backwards contract a
// weight's out dimension (Wout, W2, W1, Wqkv [K, N]), MN-major for their
// products: split_t_kernel turns each once a call. Weights change with
// every optimizer step, so nothing is kept across calls.
//
// Each operand has an f32 tensor map (encode_kmajor_f32) whose box is 128
// bytes of K -- 32 f32 -- by 128 rows, loaded with the 128-byte swizzle;
// TMA zero-fills the box past M, N and K, so ragged tiles need no masked
// loads and contribute zeros (small of 0 is 0). A stage holds the three
// boxes (48 KiB); kStages stages form a ring with "full" and "empty"
// mbarriers, one producer warp issuing the loads, as hopper_gemm.cuh's
// Mainloop.
//
// The products: wgmma.mma_async.m64n128k8.f32.tf32.tf32 with A in
// registers and B from a shared-memory descriptor. Its k8 step is 32
// bytes along the swizzled 128-byte row, as the bf16 k16 step is, so a
// stage is four k8 steps whose B descriptors move 32 bytes each
// (hopper::smem_desc, kDescStepK). A's fragment of a k8 step is the
// m16n8k8 .tf32 fragment of mma.sync (tf32x3.cuh) on each warp's 16 rows
// of the warpgroup's 64 (CUTLASS's ALayout_64x8 of the _RS_TN TF32 atoms):
// warp w, lane 4 g + t holds a0 (16 w + g, t), a1 (16 w + g + 8, t), a2
// (16 w + g, t + 4), a3 (16 w + g + 8, t + 4). ALoader takes the four with
// one ldmatrix .x4 (.b16 on f32 data: lane 4 g + t gets the 32-bit word t
// of row g of each 8 x 4 matrix whose row addresses lanes 8 i .. 8 i + 7
// give; matrix i is rows 8 (i % 2) .. + 7, k columns 4 (i / 2) .. + 3 of
// the step). In the swizzled box, the 16-byte chunk c of row R lies at
// chunk c ^ (R % 8), so the eight rows a matrix reads fall in eight
// distinct 16-byte bank groups: no bank conflict. Each fragment is split
// in registers (tf32x3::split) and the warpgroup issues, per k8 step,
// small(A) . big(B), big(A) . small(B), then big(A) . big(B), the order of
// tf32x3.cuh, as one commit group. The split registers are read by wgmmas
// still in flight, so two steps' fragments alternate: step j + 1's are
// loaded and split while step j's group runs, into the registers of step j
// - 1, whose group has completed (wgmma.wait_group 1); they are kept live
// (fence_operand) until then.
//
// The sums: a wgmma rounds its f32 sum toward zero (tf32x3.cuh), and K8's
// K = 1024 is 384 TF32 products deep. So kFreshStages stages (12 wgmmas a
// stage) sum into a fresh accumulator, the first with scale-d 0, which is
// then added in f32 (to nearest) to the tile's sum; kFreshStages = 0 sums
// every product in the tile's accumulator (one_accumulator in
// scripts/torch_outproj_bwd_f32_variants.py). Two 64 x 128 accumulators,
// 128 registers a thread, plus two steps' 16 split fragments. Each stage
// ends when its last group completes (wgmma.wait_group 0): the fresh sum
// is added, the stage released.
//
// Roles: two consumer warpgroups own rows 0 .. 63 and 64 .. 127 of the
// tile; each waits for its stage's group before it releases the stage and
// adds the fresh sum, and the other warpgroup's wgmmas keep the tensor
// cores busy meanwhile. A producer warpgroup after them, one thread of it,
// issues the loads.
#pragma once

#include "hopper_gemm.cuh"
#include "tf32x3.cuh"

namespace nvt {
namespace tf32x3_wgmma {

constexpr int kBM = 128, kBN = 128;          // block tile
constexpr int kBK = 32;                      // f32 of K a stage: 128 bytes
constexpr int kSteps = kBK / 8;              // k8 steps a stage
constexpr int kConsumers = kBM / 64;         // warpgroups
// One producer warp after them. A thread then gets at most 168 registers
// (three warps share one of the SM's four 16K-register files), which
// holds the two accumulators and two k8 steps' split fragments.
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kBoxBytes = 128 * 128;         // 128 rows of 128 bytes
constexpr int kStageBytes = 3 * kBoxBytes;   // A, Bt_big, Bt_small
constexpr int kAccRegs = kBN / 2;            // a thread's share of 64 x BN

// Dynamic shared memory of a block: the ring, the barriers and 1 KiB of
// slack to align the ring to the swizzle's 1024 bytes.
template <int kStages>
constexpr size_t smem_bytes() {
  return 1024 + size_t(kStages) * kStageBytes + 2 * kStages * sizeof(uint64_t);
}

// D[64, 128] (+)= A[64, 8] . B[128, 8]^T, A in registers (TF32 bits, the
// layout above), B a K-major TF32 tile in shared memory; kScaleD 0 ignores
// d's values. The accumulator's layout is hopper::Wgmma's.
template <int kScaleD>
__device__ __forceinline__ void mma_rs(float (&d)[kAccRegs],
                                       const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, %69, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(kScaleD));
}

// The A fragments of one k8 step from a stage's A box (1024-byte aligned,
// 128 rows of 128 bytes, 128-byte swizzle), split into big and small.
// Lane 8 i + r of warp w of warpgroup wg gives ldmatrix the row R = 64 wg
// + 16 w + r + 8 (i % 2), chunk 2 j + i / 2 of k8 step j: byte R * 128 +
// ((2 j + i / 2) ^ r) * 16, as R % 8 = r.
struct ALoader {
  uint32_t row_bytes, hi, r;

  __device__ ALoader() {
    const int lane = threadIdx.x & 31, i = lane >> 3;
    const int row = 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x / 32) & 3) +
                    (lane & 7) + 8 * (i & 1);
    row_bytes = row * 128;
    hi = i >> 1;
    r = lane & 7;
  }

  __device__ __forceinline__ void load(tf32x3::FragA& a, uint32_t box,
                                       int j) const {
    const uint32_t addr = box + row_bytes + ((((2u * j) | hi) ^ r) << 4);
    uint32_t x[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
        : "r"(addr));
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32x3::split(x[e], a.big[e], a.small[e]);
  }
};

__device__ __forceinline__ void fence_frag(tf32x3::FragA& a) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hopper::fence_operand(a.big[e]);
    hopper::fence_operand(a.small[e]);
  }
}

template <int kStages, int kFreshStages>
struct Loop {
  static_assert(kStages >= 2 && kFreshStages >= 0, "ring and sums");
  static constexpr size_t kSmemBytes = smem_bytes<kStages>();

  // A k8 step's three wgmmas into d, the first with scale-d 0 if kFirst.
  template <bool kFirst>
  __device__ __forceinline__ static void issue(float (&d)[kAccRegs],
                                               const tf32x3::FragA& a,
                                               uint64_t db, uint64_t ds) {
    if (kFirst)
      mma_rs<0>(d, a.small, db);
    else
      mma_rs<1>(d, a.small, db);
    mma_rs<1>(d, a.big, ds);
    mma_rs<1>(d, a.big, db);
  }

  // Every thread of the block calls run(). The producer warp returns false
  // once it has issued every load; a consumer thread returns true with acc
  // holding its part of rows 64 wg .. 64 wg + 63 of the tile.
  __device__ __forceinline__ static bool run(const CUtensorMap* ta,
                                             const CUtensorMap* tbig,
                                             const CUtensorMap* tsmall,
                                             int m0, int n0, int K,
                                             unsigned char* smem_raw,
                                             float (&acc)[kAccRegs]) {
    using namespace hopper;
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        round_up(reinterpret_cast<size_t>(smem_raw), 1024));
    unsigned char* a_ring = smem;
    unsigned char* big_ring = smem + kStages * kBoxBytes;
    unsigned char* small_ring = smem + 2 * kStages * kBoxBytes;
    uint64_t* full =
        reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
    uint64_t* empty = full + kStages;
    const int KT = (K + kBK - 1) / kBK;
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
        tma_prefetch_map(tbig);
        tma_prefetch_map(tsmall);
        for (int kt = 0; kt < KT; ++kt) {
          const int s = kt % kStages;
          if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(a_ring + s * kBoxBytes, ta, &full[s], kt * kBK, m0);
          tma_load_2d(big_ring + s * kBoxBytes, tbig, &full[s], kt * kBK, n0);
          tma_load_2d(small_ring + s * kBoxBytes, tsmall, &full[s], kt * kBK,
                      n0);
        }
      }
      return false;
    }

    // part: the fresh accumulator (unused at kFreshStages 0).
    float part[kAccRegs];
#pragma unroll
    for (int i = 0; i < kAccRegs; ++i) {
      acc[i] = 0.f;
      part[i] = 0.f;
      fence_operand(acc[i]);
    }
    const ALoader loader;
    const uint32_t a_base = smem_u32(a_ring);
    // Two k8 steps' split fragments: step j + 1's are loaded while step
    // j's wgmmas run, into the buffer that step j - 1's group, now
    // complete, read.
    tf32x3::FragA a[2] = {};
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint64_t db = smem_desc(big_ring + s * kBoxBytes);
      const uint64_t ds = smem_desc(small_ring + s * kBoxBytes);
      // Whether this stage opens a fresh accumulator.
      const bool fresh = kt % (kFreshStages > 1 ? kFreshStages : 1) == 0;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        tf32x3::FragA& f = a[j & 1];
        loader.load(f, a_base + s * kBoxBytes, j);
        fence_frag(f);
        wgmma_fence();
        const uint64_t step = j * kDescStepK;
        if constexpr (kFreshStages == 0)
          issue<false>(acc, f, db + step, ds + step);
        else if (j == 0 && fresh)
          issue<true>(part, f, db + step, ds + step);
        else
          issue<false>(part, f, db + step, ds + step);
        wgmma_commit();
        if (j + 1 < kSteps) {
          wgmma_wait<1>();
          fence_frag(a[(j + 1) & 1]);
        }
      }
      wgmma_wait<0>();
      fence_frag(a[0]);
      fence_frag(a[1]);
#pragma unroll
      for (int i = 0; i < kAccRegs; ++i) fence_operand(acc[i]);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
      if constexpr (kFreshStages > 0) {
#pragma unroll
        for (int i = 0; i < kAccRegs; ++i) fence_operand(part[i]);
        if ((kt + 1) % (kFreshStages > 1 ? kFreshStages : 1) == 0 ||
            kt == KT - 1) {
#pragma unroll
          for (int i = 0; i < kAccRegs; ++i) {
            acc[i] += part[i];
            fence_operand(acc[i]);
            fence_operand(part[i]);
          }
        }
      }
    }
    return true;
  }

  // f(row, col, v0, v1) for each of the thread's accumulator pairs: v0 at
  // (row, col), v1 at (row, col + 1), in tile coordinates (col even).
  template <typename F>
  __device__ __forceinline__ static void for_each_pair(
      const float (&acc)[kAccRegs], F&& f) {
    const int t = threadIdx.x % 128;
    const int row = (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      f(row, 8 * j + col, acc[4 * j], acc[4 * j + 1]);
      f(row + 8, 8 * j + col, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }

  // f(row, col, v) for the thread's pairs two by two, the pairs of steps j
  // = 2 p and 2 p + 1 of for_each_pair in one row: v = (x, y) at (row,
  // col), (row, col + 1) and (z, w) at (row, col + 8), (row, col + 9),
  // col = 16 p + 2 (t % 4). The four lie in one 16-column group of the
  // tile, so in one 16-byte Philox block of a dropout site whose width is
  // a multiple of 16 (keep_quad).
  template <typename F>
  __device__ __forceinline__ static void for_each_quad(
      const float (&acc)[kAccRegs], F&& f) {
    const int t = threadIdx.x % 128;
    const int row = (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = 2 * (t % 4);
#pragma unroll
    for (int p = 0; p < kBN / 16; ++p) {
      f(row, 16 * p + col, make_float4(acc[8 * p], acc[8 * p + 1],
                                       acc[8 * p + 4], acc[8 * p + 5]));
      f(row + 8, 16 * p + col, make_float4(acc[8 * p + 2], acc[8 * p + 3],
                                           acc[8 * p + 6], acc[8 * p + 7]));
    }
  }
};

// The keep factors (inv_keep or 0) of the elements i, i + 1, i + 8 and i +
// 9 of a dropout site (i % 16 even and below 8: a for_each_quad group):
// bytes i % 16, + 1, + 8 and + 9 of Philox(i / 16) (nn.keep_mask), one
// Philox call for the four.
__device__ __forceinline__ float4 keep_quad(uint64_t i, uint64_t seed,
                                            uint32_t keep_q, float inv_keep) {
  const uint4 w = philox4x32_10(i >> 4, seed);
  const bool second = (i >> 2) & 1u;
  const uint32_t lo = second ? w.y : w.x, hi = second ? w.w : w.z;
  const int s = 8 * static_cast<int>(i & 3u);
  return make_float4(((lo >> s) & 0xffu) < keep_q ? inv_keep : 0.f,
                     ((lo >> (s + 8)) & 0xffu) < keep_q ? inv_keep : 0.f,
                     ((hi >> s) & 0xffu) < keep_q ? inv_keep : 0.f,
                     ((hi >> (s + 8)) & 0xffu) < keep_q ? inv_keep : 0.f);
}

// Columns col, col + 1, col + 8 and col + 9 of row-major p from offset
// at = row * width + col (a for_each_quad group), as two float2 loads or
// stores.
__device__ __forceinline__ float4 load_quad(const float* p, size_t at) {
  const float2 a = *reinterpret_cast<const float2*>(p + at);
  const float2 b = *reinterpret_cast<const float2*>(p + at + 8);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store_quad(float* p, size_t at, float4 v) {
  *reinterpret_cast<float2*>(p + at) = make_float2(v.x, v.y);
  *reinterpret_cast<float2*>(p + at + 8) = make_float2(v.z, v.w);
}

// The body of a GEMM kernel with its own epilogue: the 128 x 128 tile at
// grid (column tile, row tile) of A [M, K] . Bt^T by Loop L, then
// epi(row, col, v) for each for_each_quad group inside [M, N] (N % 16 ==
// 0, so a group lies wholly inside or wholly outside), in the output's
// coordinates.
template <typename L, typename Epi>
__device__ __forceinline__ void gemm_tile(const CUtensorMap* ta,
                                          const CUtensorMap* tbig,
                                          const CUtensorMap* tsmall, int M,
                                          int N, int K, unsigned char* smem,
                                          const Epi& epi) {
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[kAccRegs];
  if (!L::run(ta, tbig, tsmall, m0, n0, K, smem, acc)) return;
  L::for_each_quad(acc, [&](int row, int col, float4 v) {
    row += m0;
    col += n0;
    if (row < M && col < N) epi(row, col, v);
  });
}

// The weight pre-pass: w [rows, cols] row-major f32 (a torch Linear weight
// [out, in]) into big and small [cols, rows], its transpose split by
// tf32x3::split (big + small == w exactly). A block of 32 x 8 threads
// turns a 32 x 32 tile through shared memory (33 floats a row: reads and
// writes conflict-free), each thread four elements; rows and cols any
// size. Bounded by its bytes: w read once, big and small written once.
constexpr int kSplitTile = 32, kSplitRows = 8;

template <int kTile = kSplitTile>
__global__ void __launch_bounds__(kTile * kSplitRows)
    split_t_kernel(const float* __restrict__ w, float* __restrict__ big,
                   float* __restrict__ small, int rows, int cols) {
  __shared__ float tile[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
#pragma unroll
  for (int i = ty; i < kTile; i += kSplitRows) {
    const int r = r0 + i, c = c0 + tx;
    if (r < rows && c < cols) tile[i][tx] = w[static_cast<size_t>(r) * cols + c];
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < kTile; i += kSplitRows) {
    const int c = c0 + i, r = r0 + tx;
    if (c < cols && r < rows) {
      uint32_t b, s;
      tf32x3::split(__float_as_uint(tile[tx][i]), b, s);
      const size_t at = static_cast<size_t>(c) * rows + r;
      big[at] = __uint_as_float(b);
      small[at] = __uint_as_float(s);
    }
  }
}

inline cudaError_t launch_split_t(const float* w, float* big, float* small,
                                  int rows, int cols, cudaStream_t stream) {
  const dim3 grid((cols + kSplitTile - 1) / kSplitTile,
                  (rows + kSplitTile - 1) / kSplitTile);
  split_t_kernel<kSplitTile><<<grid, kSplitTile * kSplitRows, 0, stream>>>(
      w, big, small, rows, cols);
  return cudaGetLastError();
}

// The forwards' weight pre-pass: w [n] f32 (a torch Linear weight [out,
// in], K-major for the forwards' products as it lies) into big and small
// of the same layout, tf32x3::split of each element (big + small == w
// exactly). A thread takes 16-byte vectors (n % 4 == 0, all three 16-byte
// aligned), a grid-stride walk. Bounded by its bytes: w read once, big and
// small written once.
constexpr int kSplitThreads = 256, kSplitBlocks = 1056;   // 8 an SM

// A template, as split_t_kernel is, so that every source including this
// header may instantiate it.
template <int kT = kSplitThreads>
__global__ void __launch_bounds__(kT)
    split_kernel(const float4* __restrict__ w, float4* __restrict__ big,
                 float4* __restrict__ small, size_t n4) {
  for (size_t i = blockIdx.x * size_t(kT) + threadIdx.x; i < n4;
       i += size_t(gridDim.x) * kT) {
    const float4 v = w[i];
    uint32_t b[4], s[4];
    tf32x3::split(__float_as_uint(v.x), b[0], s[0]);
    tf32x3::split(__float_as_uint(v.y), b[1], s[1]);
    tf32x3::split(__float_as_uint(v.z), b[2], s[2]);
    tf32x3::split(__float_as_uint(v.w), b[3], s[3]);
    big[i] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                         __uint_as_float(b[2]), __uint_as_float(b[3]));
    small[i] = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                           __uint_as_float(s[2]), __uint_as_float(s[3]));
  }
}

// Blocks of the pre-pass over n f32 (ops/tf32x3.py split_launch).
inline int split_blocks(size_t n) {
  const size_t need = (n / 4 + kSplitThreads - 1) / kSplitThreads;
  return static_cast<int>(need < kSplitBlocks ? need : kSplitBlocks);
}

inline cudaError_t launch_split(const float* w, float* big, float* small,
                                size_t n, cudaStream_t stream) {
  split_kernel<kSplitThreads><<<split_blocks(n), kSplitThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(w), reinterpret_cast<float4*>(big),
      reinterpret_cast<float4*>(small), n / 4);
  return cudaGetLastError();
}

// The tensor map of a row-major f32 [rows, K] operand for Loop: boxes of
// 32 f32 (128 bytes) of K by box_rows rows, 128-byte swizzle, zeros past
// the edges. K % 4 == 0 and ptr 16-byte aligned. A failed encode prints
// its CUresult and returns cudaErrorInvalidValue.
inline cudaError_t encode_kmajor_f32(CUtensorMap* map, const float* ptr,
                                     int rows, int K, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode =
      hopper::tensor_map_encoder();
  if (encode == nullptr) {
    fprintf(stderr, "nvt: the driver has no cuTensorMapEncodeTiled\n");
    return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(K) * sizeof(float)};
  const cuuint32_t box[2] = {cuuint32_t(kBK), cuuint32_t(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) {
    fprintf(stderr,
            "nvt: cuTensorMapEncodeTiled failed with CUresult %d ([%d, %d] "
            "f32, box %d rows)\n",
            static_cast<int>(res), rows, K, box_rows);
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// K4 f32's last pass, fc2_residual (fused_mlp_f32.cu), which K3 f32
// (fused_outproj_f32.cu) launches as its one GEMM: y [M, N] = x + (A .
// Bt^T + bias) * keep factors, x added in f32, on Loop<4, 1> over
// (ceil(N / 128), ceil(M / 128)) tiles, A [M, K] and Bt [N, K] (big and
// small) by their maps (encode_kmajor_f32, boxes of kBM and kBN rows);
// the mask of element (row, col) nn.keep_mask's bit at row * N + col under
// seed, applied where keep_q > 0. allow_fc2_residual_smem() opts the
// kernel into its fc2_residual_smem_bytes() of shared memory; call it
// before the first launch.
cudaError_t allow_fc2_residual_smem();
cudaError_t launch_fc2_residual(const CUtensorMap& ta,
                                const CUtensorMap& tbig,
                                const CUtensorMap& tsmall, const float* bias,
                                const float* x, float* y, int M, int N, int K,
                                float inv_keep, uint32_t keep_q, uint64_t seed,
                                cudaStream_t stream);
size_t fc2_residual_smem_bytes();
// The same pass's tensor-parallel form for a row-parallel shard (K the
// shard's share): y = (A . Bt^T [+ bias]) * keep factors [+ x], bias and x
// null on all but the model group's first shard, the mask the whole
// pass's; the f32 sum of the shards' y is the whole pass. Its own kernel,
// of the same shared memory, allowed by allow_fc2_partial_smem().
cudaError_t allow_fc2_partial_smem();
cudaError_t launch_fc2_partial(const CUtensorMap& ta, const CUtensorMap& tbig,
                               const CUtensorMap& tsmall, const float* bias,
                               const float* x, float* y, int M, int N, int K,
                               float inv_keep, uint32_t keep_q, uint64_t seed,
                               cudaStream_t stream);

}  // namespace tf32x3_wgmma
}  // namespace nvt
