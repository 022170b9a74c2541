// Flash attention, forward and backward, in float32, for Hopper (sm_90a): the
// forward on the CUDA cores, the backward on the tensor cores.
//
// Replaces the TPU kernels pointasnl_tpu/ops/pallas/flash_attention.py:
// _flash_fwd_kernel (the forward) and _flash_bwd_kernel (the backward).
//
// Contract: q (B, M, C), k (B, N, C), v (B, N, D) float32, contiguous,
// 1 <= C, D <= 256, N >= 1.
//   forward:  o = softmax(q k^T * scale) v  (B, M, D), and each row's
//             logsumexp lse = max + log(sum) (B, M), float32.
//   backward: from q, k, v, o, lse and dO, with p = exp(q k^T * scale - lse)
//             recomputed, delta = rowsum(dO * o), dS = p * (dO v^T - delta)
//             * scale:  dQ = dS k, dK = dS^T q, dV = p^T dO.
// The scores are each q . k product rounded to float32 and then multiplied
// by the float32 scale, as the TPU kernel computes them; exp and log are the
// accurate expf and logf (no fast-math intrinsics).
//
// What bounds it on the card: operations. The forward does 2 B M N (C + D)
// flops and reads K and V once per query tile and key range; the backward
// 2 B M N (3C + 2D).
// At the seg step's level 1 (B4, M 1280, N 10240, C = D = 32) that is
// 6.7 GFLOP forward and 16.8 backward against a few MB of operands. The
// forward's flops run on the CUDA cores at the float32 rate (67 TFLOP/s:
// 0.100 ms); the backward's run three times each on the tensor cores at the
// TF32 rate (495 TFLOP/s: 0.102 ms), and would take 0.250 ms at the float32
// rate.
//
// The forward's design (FlashAttention-2's shape on the CUDA cores, in
// float32: the forward's tolerance, 1e-5 of the output's scale, is ten
// times tighter than the backward's, so no TF32):
//   - A block owns 64 query rows (4 warps of 16) and streams a range of the
//     keys in chunks of 64 (32 at P = 128, 16 at P = 256), K and V copied
//     into shared memory by cp.async, 16 bytes a copy where the rows allow
//     it, two stages in flight. Rows are padded to P + 4 floats, so the
//     float4 loads of 4 or 8 different rows hit different banks.
//   - Each thread computes a register tile of scores, 4 rows x 8 keys (4
//     or 2 at the wider P), by outer-product FFMAs: each float4 loaded from
//     shared memory feeds 16 or 32 FMAs, not 4. A row's 8 lanes share its
//     running max by xor shuffles; each p is exponentiated once, by the lane
//     that scored it, and goes through its warp's buffer in shared memory,
//     32 keys at a time, to P V, a second register tile (4 rows x P / 8
//     columns; a block takes at most 128 columns, so P = 256 runs two blocks
//     a tile). At P = 32 a thread holds 128 registers and a block 53 KB of
//     shared memory: four blocks an SM.
//   - The keys of a query tile are split into ranges (fwd_split), up to 16,
//     until the blocks come near ten an SM, so that a level with few tiles
//     still fills the card (level 1: 80 tiles, 16 ranges of 640 keys; at
//     levels 3 and 4, one range took 0.036 and 0.024 ms against 0.013 and
//     0.012 split). A range holds at most 65536 keys, whatever the fill: a
//     thread sums its range's products in order, and their rounding grows
//     with their count (over 2228224 keys, |o - plain| was 4.7e-5 of the
//     output's scale in one range, 1.2e-5 in 9, 4.2e-6 in 34; over 131072
//     keys 1.2e-5 in one range, 6.5e-6 in 2: PERF.md). With more than one
//     range, each block writes its range's max, sum and unnormalised
//     output, and flash_fwd_merge_kernel merges them in range order. No
//     atomics: every run gives the same bits.
//   - A chunk's keys past its range score -inf: they add exactly 0 and leave
//     the running max as it was (the TPU kernel masks them to -3e38).
//
// The backward's design. Its four products are (64 x P) (P x 64) tiles, so
// they run on the tensor cores, mma.sync m16n8k8 in TF32 with float32
// accumulation. (wgmma would need the operands in shared memory in its own
// swizzled layout, and at C = 32 a tile's products are too short to hide its
// asynchrony; mma.sync keeps P and dS in registers between products.)
//   - Float32 accuracy from TF32: each operand is split x = hi + lo, hi
//     rounded to TF32, and a b = hi hi + hi lo + lo hi in three passes (the
//     lo lo term is ~2^-22 of the product). One pass keeps ~11 bits: built
//     with FLASH_BWD_TF32_PASSES=1, every gradient of chip_smoke.py's flash
//     cases misses FLASH_GRAD_RTOL's limit, 4-14 times over at the seg
//     levels, where three passes stay within 0.3 of it (PERF.md).
//   - The FlashAttention-2 split, in one launch: a block owns 64 keys and
//     streams every query row, accumulating dK and dV, or owns 64 query rows
//     and streams a range of the keys, accumulating dQ. Each recomputes s and
//     dP, so the two do 2 B M N (4C + 3D) flops against the 3C + 2D that the
//     bound counts. The keys are split into as many ranges as make a query
//     block stream about as many rows as a key block (8 at level 1, where
//     N = 8 M; unsplit, the 80 query blocks streamed 160 steps each while the
//     640 key blocks streamed 20); the ranges' partial dQ go to scratch and a
//     small kernel adds them in range order. No atomics: every output
//     element is written by one lane, the same bits every run. delta comes
//     first, from its own small kernel.
//   - The streamed rows arrive through shared memory, two stages of cp.async
//     in flight, while the block's own rows stay in shared memory all along.
//     Rows are padded to P + 4 floats, so each fragment load hits 32 banks.
//   - Each p = exp(s * scale - lse) is computed once, by the lane that holds
//     it in its accumulator fragment. That fragment of an n8 tile is the A
//     fragment of the next product's k8 step, with k in the order 0, 2, 4,
//     6, 1, 3, 5, 7; the streamed B rows are read in the same order, so P and
//     dS go from one product to the next without a shuffle.
//   - C = D = 128 and 256 split the accumulators' columns over 2 and 4
//     blocks (each recomputing s and dP) and stream fewer rows a step, so
//     registers and shared memory stay within an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWidth = 256;

// ---------------------------------------------------------------------------
// The backward: delta = rowsum(dO * o), then dQ, dK and dV on the tensor cores.

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kOwn = kBwdWarps * 16;  // rows a block owns: 16 a warp, the mma's M
constexpr int kMaxSplits = 16;        // key ranges a query tile's dQ is split into

// Tiles of the backward, for C and D zero-padded to P (16, 32, 64, 128 or 256).
template <int P>
struct Bwd {
  static constexpr int kStride = P + 4;  // floats a row in shared memory: no bank conflicts
  static constexpr int kStream = P <= 32 ? 64 : 2048 / P;  // rows streamed a step: 64 ... 8
  static constexpr int kCols = P < 64 ? P : 64;  // accumulator columns a block
  static constexpr int kChunks = P / kCols;      // blocks a tile, one for each column chunk
  static constexpr int kOwnFloats = 2 * kOwn * kStride;
  // A stage: the two streamed operands, then (keys' blocks only) lse and delta.
  static constexpr int kStageFloats = 2 * kStream * kStride + 2 * kStream;
  static constexpr size_t kSmem = (size_t)(kOwnFloats + 2 * kStageFloats) * sizeof(float);
};

// x = hi + lo: hi is x rounded to tf32 (10 mantissa bits, ties away from
// zero), lo the exact float32 rest, whose low 13 bits the tensor core drops.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The backward ships with 3 passes. A build with -DFLASH_BWD_TF32_PASSES=1
// keeps the hi hi pass alone, to measure what the tolerance catches
// (scripts/torch_flash_tf32_passes.py).
#ifndef FLASH_BWD_TF32_PASSES
#define FLASH_BWD_TF32_PASSES 3
#endif
static_assert(FLASH_BWD_TF32_PASSES == 1 || FLASH_BWD_TF32_PASSES == 3,
              "the flash backward takes 1 or 3 TF32 passes");

// d += a b in three tf32 passes, the small terms first: lo hi, hi lo, hi hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  if (FLASH_BWD_TF32_PASSES == 3) {
    mma_tf32(d, alo, bh0, bh1);
    mma_tf32(d, ahi, bl0, bl1);
  }
  mma_tf32(d, ahi, bh0, bh1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + count) of a (*, width) matrix into dst,
// `stride` floats a row, columns below width; 16 bytes a copy where the
// rows allow it.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int count,
                                           int width, int stride) {
  src += (size_t)row0 * width;
  if ((width & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int per_row = width >> 2;
    for (int u = threadIdx.x; u < count * per_row; u += kBwdThreads) {
      const int r = u / per_row, c4 = (u - r * per_row) << 2;
      cp_async16(dst + r * stride + c4, src + (size_t)r * width + c4);
    }
  } else {
    for (int u = threadIdx.x; u < count * width; u += kBwdThreads) {
      const int r = u / width, c = u - r * width;
      cp_async4(dst + r * stride + c, src + (size_t)r * width + c);
    }
  }
}

// Rows [row0, row0 + kOwn) of a (rows, width) matrix into dst, zero past
// `rows` and `width`.
template <int P>
__device__ __forceinline__ void load_own(float* dst, const float* src, int row0, int rows,
                                         int width) {
  for (int i = threadIdx.x; i < kOwn * P; i += kBwdThreads) {
    const int r = i / P, c = i % P;
    const int g = row0 + r;
    dst[r * Bwd<P>::kStride + c] = (g < rows && c < width) ? src[(size_t)g * width + c] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// The forward: float32 FFMA, a register tile of scores a thread.

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kFwdWarps * 32;
static_assert(kFwdThreads == kBwdThreads, "stage_rows strides by the backward's block");
constexpr int kFwdMaxSplits = 16;         // key ranges a query tile is split into to fill the card
constexpr int kFwdTargetBlocks = 1320;    // blocks the split aims at: ten for each of 132 SMs
constexpr int kFwdMaxRangeKeys = 65536;   // the most keys a range holds (accuracy)

// Tiles of the forward, for C and D zero-padded to P (16, 32, 64, 128 or 256).
template <int P>
struct Fwd {
  // Query rows a thread (8 at P = 32 took 232 registers, two blocks an SM,
  // and was no faster), 16 a warp, 64 a block.
  static constexpr int kRPT = 4;
  static constexpr int kRows = kFwdWarps * 4 * kRPT;
  static constexpr int kStride = P + 4;  // floats a row of q, k, v in shared memory
  static constexpr int kKeys = P <= 64 ? 64 : 4096 / P;  // keys a chunk: 64, 32 or 16
  static constexpr int kKPT = kKeys / 8;                // keys of a chunk a thread scores
  static constexpr int kCols = P < 128 ? P : 128;        // output columns a block
  static constexpr int kChunks = P / kCols;              // blocks a tile, one a column chunk
  static constexpr int kCPT = kCols / 8;                 // output columns a thread
  // A thread's columns come in runs of kRun, one run in each 8 kRun columns,
  // so that the 8 lanes of a row read one contiguous span of v at a time.
  static constexpr int kRun = kCPT < 4 ? kCPT : 4;
  static __device__ __forceinline__ int col(int h, int cc) {
    return cc / kRun * 8 * kRun + h * kRun + cc % kRun;
  }
  static constexpr int kQFloats = kRows * kStride;
  static constexpr int kStageFloats = 2 * kKeys * kStride;   // a chunk of k, then of v
  // p goes to P V in rounds of kPKeys keys, through a buffer of each warp's
  // p: a key's 4 kRPT rows, padded to kPStride floats so that the 8 lanes of
  // a row write 8 banks apart.
  static constexpr int kPKeys = kKeys < 32 ? kKeys : 32;
  static constexpr int kPStride = 4 * kRPT + 4;
  static constexpr int kPFloats = kFwdWarps * kPKeys * kPStride;
  static constexpr size_t kSmem = (size_t)(kQFloats + 2 * kStageFloats + kPFloats) * sizeof(float);
};

#ifdef FLASH_FWD_PLAN_SWEEP
// Built with -DFLASH_FWD_PLAN_SWEEP (scripts/torch_kernel_turns.py --plans):
// every forward splits its tiles' keys into this many ranges (0: the plan's).
int g_fwd_force_splits = 0;
#endif

// How the forward splits a query tile's keys: into `splits` ranges of
// split_keys keys (a whole number of chunks), as many as bring B * ceil(M /
// kRows) * kChunks tiles times the ranges near kFwdTargetBlocks, at most
// kFwdMaxSplits; and a range never holds more than kFwdMaxRangeKeys keys,
// whatever the card's fill: a thread sums a range's products in order, and
// their rounding grows with their count.
template <int P>
void fwd_split(int b, int m, int n, int& splits, int& split_keys) {
  using T = Fwd<P>;
  static_assert(kFwdMaxRangeKeys % T::kKeys == 0, "a range holds whole chunks");
  const int chunks = (n + T::kKeys - 1) / T::kKeys;
  const int tiles = b * ((m + T::kRows - 1) / T::kRows) * T::kChunks;
  int want = (kFwdTargetBlocks + tiles - 1) / tiles;
  want = want < kFwdMaxSplits ? want : kFwdMaxSplits;
  int split_chunks = (chunks + want - 1) / want;
  split_chunks = split_chunks < kFwdMaxRangeKeys / T::kKeys ? split_chunks
                                                             : kFwdMaxRangeKeys / T::kKeys;
#ifdef FLASH_FWD_PLAN_SWEEP
  if (g_fwd_force_splits > 0) {
    want = g_fwd_force_splits < chunks ? g_fwd_force_splits : chunks;
    split_chunks = (chunks + want - 1) / want;
  }
#endif
  splits = (chunks + split_chunks - 1) / split_chunks;
  split_keys = split_chunks * T::kKeys;
}

// One block of the forward: batch element blockIdx.y, query tile, key range
// and column chunk from blockIdx.x. Thread (warp w, lane 8 g + h) scores rows
// 4 kRPT w + g + 4 i (i < kRPT) against keys h + 8 j (j < kKPT) of each chunk, and
// accumulates those rows' outputs in its kCPT columns (Fwd::col) of its
// column chunk. A row's max and sum go by xor shuffles over its 8 lanes; its
// p go through the warp's buffer in shared memory to the P V product. With
// one range the block writes o and lse; with more, its range's (max, sum,
// unnormalised o) go to `part`, which flash_fwd_merge_kernel merges.
template <int P>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 float* __restrict__ part, int m, int n, int c, int d, float scale, int splits,
                 int split_keys) {
  using T = Fwd<P>;
  constexpr int S = T::kStride, KPT = T::kKPT, CPT = T::kCPT, BN = T::kKeys, RPT = T::kRPT;
  constexpr int PS = T::kPStride;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sq = smem;
  float* stages = sq + T::kQFloats;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 3, h = lane & 7;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x % T::kChunks;
  const int split = blockIdx.x / T::kChunks % splits;
  const int row0 = blockIdx.x / T::kChunks / splits * T::kRows;
  const int key0 = split * split_keys, key1 = min(n, key0 + split_keys);
  const int col0 = chunk * T::kCols;  // the column chunk's first column
  const float* K = k + (size_t)b * n * c;
  const float* V = v + (size_t)b * n * d;

  // Zero q and the stages (columns past C or D, rows past M, and rows past
  // a ragged last chunk add exactly 0), then copy this tile's q.
  for (int i = threadIdx.x; i < T::kQFloats + 2 * T::kStageFloats; i += kFwdThreads) smem[i] = 0.0f;
  __syncthreads();
  stage_rows(sq, q + (size_t)b * m * c, row0, min(T::kRows, m - row0), c, S);
  cp_async_commit();
  const int steps = (key1 - key0 + BN - 1) / BN;
  auto issue = [&](int step) {
    float* st = stages + (step & 1) * T::kStageFloats;
    const int r0 = key0 + step * BN;
    const int cnt = min(BN, key1 - r0);
    stage_rows(st, K, r0, cnt, c, S);
    stage_rows(st + BN * S, V, r0, cnt, d, S);
    cp_async_commit();
  };

  float acc[RPT][CPT], mx[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    mx[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.0f;
  }
  const float* qw = sq + (warp * 4 * RPT + g) * S;  // row i at qw + 4 i S
  float* pw = stages + 2 * T::kStageFloats + warp * T::kPKeys * PS;  // [key][4 RPT rows]

  issue(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      issue(step + 1);  // into the other stage, which the last step has released
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = stages + (step & 1) * T::kStageFloats;
    const float* sv = sk + BN * S;

    // s = q k^T, RPT rows x KPT keys: each shared float4 feeds 4 RPT or
    // 4 KPT FMAs.
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
#pragma unroll
    for (int c4 = 0; c4 < P; c4 += 4) {
      float4 qa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qa[i] = *reinterpret_cast<const float4*>(qw + 4 * i * S + c4);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kb = *reinterpret_cast<const float4*>(sk + (h + 8 * j) * S + c4);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          s[i][j] = fmaf(qa[i].x, kb.x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb.y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb.z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb.w, s[i][j]);
        }
      }
    }

    // Online softmax: keys past the range score -inf, add exactly 0 and
    // leave the max as it was; each p is exponentiated once.
    const int kbase = key0 + step * BN + h;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = kbase + 8 * j < key1 ? s[i][j] * scale : -INFINITY;
        cmax = fmaxf(cmax, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
      const float mnew = fmaxf(mx[i], cmax);  // finite: the chunk holds a key
      const float alpha = expf(mx[i] - mnew);  // 0 at the first chunk (mx = -inf)
      mx[i] = mnew;
      l[i] *= alpha;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= alpha;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = expf(s[i][j] - mnew);
        l[i] += s[i][j];
      }
    }
    // acc += p v over the chunk's keys, in key order, kPKeys at a time.
    constexpr int kJ = T::kPKeys / 8;  // a round's keys a thread scored
#pragma unroll
    for (int round = 0; round < BN / T::kPKeys; ++round) {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int i = 0; i < RPT; i += 4)
          *reinterpret_cast<float4*>(pw + (h + 8 * j) * PS + RPT * g + i) =
              make_float4(s[i][round * kJ + j], s[i + 1][round * kJ + j],
                          s[i + 2][round * kJ + j], s[i + 3][round * kJ + j]);
      __syncwarp();
#pragma unroll 8
      for (int kk = 0; kk < T::kPKeys; ++kk) {
        float pr[RPT];
#pragma unroll
        for (int i = 0; i < RPT; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(pw + kk * PS + RPT * g + i);
          pr[i] = x.x;
          pr[i + 1] = x.y;
          pr[i + 2] = x.z;
          pr[i + 3] = x.w;
        }
        const float* vr = sv + (round * T::kPKeys + kk) * S + col0;
        float vv[CPT];
#pragma unroll
        for (int cc = 0; cc < CPT; cc += T::kRun) {
          if constexpr (T::kRun == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vr + T::col(h, cc));
            vv[cc] = x.x;
            vv[cc + 1] = x.y;
            vv[cc + 2] = x.z;
            vv[cc + 3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(vr + T::col(h, cc));
            vv[cc] = x.x;
            vv[cc + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = fmaf(pr[i], vv[cc], acc[i][cc]);
      }
      __syncwarp();  // the round's p are read; the next round may write them
    }
    __syncthreads();  // this stage is read; the next step's copy may refill it
  }

  // A row's sum over its 8 lanes (a butterfly: every lane ends with the same
  // sum); then o and lse, or this range's part.
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  // A part: (splits, B, M, D) unnormalised o, then (splits, B, M, 2) max and sum.
  const size_t rows = (size_t)gridDim.y * m;
  const bool split_up = splits > 1;
  float* out = split_up ? part + split * rows * d : o;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + warp * 4 * RPT + g + 4 * i;
    if (row >= m) continue;
    const size_t r = (size_t)b * m + row;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int col = col0 + T::col(h, cc);
      if (col < d) out[r * d + col] = split_up ? acc[i][cc] : acc[i][cc] / l[i];
    }
    if (h == 0 && chunk == 0) {
      if (split_up) {
        float* ml = part + (size_t)splits * rows * d + 2 * (split * rows + r);
        ml[0] = mx[i];
        ml[1] = l[i];
      } else {
        lse[r] = mx[i] + logf(l[i]);
      }
    }
  }
}

// o and lse from the ranges' parts, merged in range order: one thread an
// element of o (the row's first also writes its lse).
__global__ void flash_fwd_merge_kernel(const float* __restrict__ part, float* __restrict__ o,
                                       float* __restrict__ lse, long long rows, int d,
                                       int splits) {
  const float* ml = part + (size_t)splits * rows * d;
  const long long count = rows * d, stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < count; e += stride) {
    const long long r = e / d;
    float top = -INFINITY;
    for (int sp = 0; sp < splits; ++sp) top = fmaxf(top, ml[2 * (sp * rows + r)]);
    float sum = 0.0f, num = 0.0f;
    for (int sp = 0; sp < splits; ++sp) {
      const float f = expf(ml[2 * (sp * rows + r)] - top);
      sum = fmaf(ml[2 * (sp * rows + r) + 1], f, sum);
      num = fmaf(part[sp * count + e], f, num);
    }
    o[e] = num / sum;
    if (e - r * d == 0) lse[r] = top + logf(sum);
  }
}

// dq = the sum of the splits' partial dQ, in split order.
__global__ void flash_bwd_dq_sum_kernel(const float* __restrict__ part, float* __restrict__ dq,
                                        long long count, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    float s = part[i];
    for (int sp = 1; sp < splits; ++sp) s += part[sp * count + i];
    dq[i] = s;
  }
}

__global__ void flash_bwd_delta_kernel(const float* __restrict__ o,
                                       const float* __restrict__ dout,
                                       float* __restrict__ delta, int rows, int d) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* a = o + (size_t)r * d;
  const float* g = dout + (size_t)r * d;
  float s = 0.0f;
  for (int i = 0; i < d; ++i) s = fmaf(g[i], a[i], s);
  delta[r] = s;
}

// One block of the backward. kDQ: it owns 64 query rows and streams the
// keys [s_begin, s_end), accumulating dQ = dS K. Otherwise it owns 64 keys
// and streams every query row, accumulating dK = dS^T q and dV = P^T dO. The
// two roles are one computation with the operands swapped: X1, X2 are the
// block's own rows of (q, dO) or (k, v), Y1, Y2 the streamed rows of (k, v)
// or (q, dO); S = X1 Y1^T, dP = X2 Y2^T, then acc1 += dS Y1, written to
// out1 (dQ or its split's part, or dK), and (keys) acc2 += P Y2, written to
// dv, over the accumulators' column chunk [col0, col0 + kCols).
template <int P, bool kDQ>
__device__ __forceinline__ void bwd_tile(const float* __restrict__ q, const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         const float* __restrict__ dout,
                                         float* __restrict__ out1, float* __restrict__ dv, int m,
                                         int n, int c, int d, float scale, int tile, int chunk,
                                         int s_begin, int s_end) {
  using T = Bwd<P>;
  constexpr int S = T::kStride;
  constexpr int kJ = T::kStream / 8;  // n8 tiles of S and dP
  constexpr int kN = T::kCols / 8;    // n8 tiles of the accumulators
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* x1 = smem;
  float* x2 = x1 + kOwn * S;
  float* stages = smem + T::kOwnFloats;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group and thread in group
  const int own_rows = kDQ ? m : n, stream_rows = kDQ ? n : m;
  const float* X1 = (kDQ ? q : k) + (size_t)b * own_rows * c;
  const float* X2 = (kDQ ? dout : v) + (size_t)b * own_rows * d;
  const float* Y1 = (kDQ ? k : q) + (size_t)b * stream_rows * c;
  const float* Y2 = (kDQ ? v : dout) + (size_t)b * stream_rows * d;
  const float* L = lse + (size_t)b * m;
  const float* Dl = delta + (size_t)b * m;
  const int own0 = tile * kOwn, col0 = chunk * T::kCols;

  // Zero the stages (a ragged last step leaves finite rows of an earlier
  // step past its end, which the mask below drops), and load the own rows.
  for (int i = threadIdx.x; i < 2 * T::kStageFloats; i += kBwdThreads) stages[i] = 0.0f;
  load_own<P>(x1, X1, own0, own_rows, c);
  load_own<P>(x2, X2, own0, own_rows, d);
  float lse_row[2] = {0.0f, 0.0f}, delta_row[2] = {0.0f, 0.0f};
  if (kDQ) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = own0 + warp * 16 + g + 8 * h;
      if (row < m) {
        lse_row[h] = L[row];
        delta_row[h] = Dl[row];
      }
    }
  }
  __syncthreads();

  const int steps = (s_end - s_begin + T::kStream - 1) / T::kStream;
  auto issue = [&](int step) {
    float* st = stages + (step & 1) * T::kStageFloats;
    const int r0 = s_begin + step * T::kStream;
    const int cnt = min(T::kStream, s_end - r0);
    stage_rows(st, Y1, r0, cnt, c, S);
    stage_rows(st + T::kStream * S, Y2, r0, cnt, d, S);
    if (!kDQ) {
      for (int i = threadIdx.x; i < cnt; i += kBwdThreads) {
        cp_async4(st + 2 * T::kStream * S + i, L + r0 + i);
        cp_async4(st + 2 * T::kStream * S + T::kStream + i, Dl + r0 + i);
      }
    }
    cp_async_commit();
  };

  float acc1[kN][4], acc2[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[j][i] = acc2[j][i] = 0.0f;
  const float* a1 = x1 + warp * 16 * S;
  const float* a2 = x2 + warp * 16 * S;

  issue(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      issue(step + 1);  // into the other stage, which the last step has released
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* y1 = stages + (step & 1) * T::kStageFloats;
    const float* y2 = y1 + T::kStream * S;
    const float* sl = y2 + T::kStream * S;
    const float* sd = sl + T::kStream;

    // S = X1 Y1^T and dP = X2 Y2^T, (16 own rows) x (kStream streamed) a warp.
    float s[kJ][4], dp[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < P / 8; ++kk) {
      uint32_t hi[4], lo[4];
      const float* a = a1 + g * S + kk * 8 + t;
      split(a[0], hi[0], lo[0]);
      split(a[8 * S], hi[1], lo[1]);
      split(a[4], hi[2], lo[2]);
      split(a[8 * S + 4], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float* bp = y1 + (j * 8 + g) * S + kk * 8 + t;
        mma3(s[j], hi, lo, bp[0], bp[4]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < P / 8; ++kk) {
      uint32_t hi[4], lo[4];
      const float* a = a2 + g * S + kk * 8 + t;
      split(a[0], hi[0], lo[0]);
      split(a[8 * S], hi[1], lo[1]);
      split(a[4], hi[2], lo[2]);
      split(a[8 * S + 4], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float* bp = y2 + (j * 8 + g) * S + kk * 8 + t;
        mma3(dp[j], hi, lo, bp[0], bp[4]);
      }
    }

    // p = exp(s * scale - lse), once an element; dS = p (dP - delta) scale.
    // A fragment element i sits at own row g + 8 (i / 2) and streamed row
    // 8 j + 2 t + (i % 2); streamed rows past the end get p = 0.
    const int r0 = s_begin + step * T::kStream;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = j * 8 + 2 * t + (i & 1);
        const float lv = kDQ ? lse_row[i >> 1] : sl[col];
        const float dv_ = kDQ ? delta_row[i >> 1] : sd[col];
        const float p = r0 + col < s_end ? expf(s[j][i] * scale - lv) : 0.0f;
        dp[j][i] = p * (dp[j][i] - dv_) * scale;
        s[j][i] = p;
      }
    }

    // acc1 += dS Y1, acc2 += P Y2 over the streamed rows. The C fragment of
    // an n8 tile is the A fragment of a k8 step whose k runs over the
    // streamed rows in the order 0, 2, 4, 6, 1, 3, 5, 7, so B is read in
    // that order too: no shuffle.
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      uint32_t dh[4], dl[4], ph[4], pl[4];
      split(dp[j][0], dh[0], dl[0]);
      split(dp[j][2], dh[1], dl[1]);
      split(dp[j][1], dh[2], dl[2]);
      split(dp[j][3], dh[3], dl[3]);
      if (!kDQ) {
        split(s[j][0], ph[0], pl[0]);
        split(s[j][2], ph[1], pl[1]);
        split(s[j][1], ph[2], pl[2]);
        split(s[j][3], ph[3], pl[3]);
      }
#pragma unroll
      for (int nt = 0; nt < kN; ++nt) {
        const int off = (j * 8 + 2 * t) * S + col0 + nt * 8 + g;
        mma3(acc1[nt], dh, dl, y1[off], y1[off + S]);
        if (!kDQ) mma3(acc2[nt], ph, pl, y2[off], y2[off + S]);
      }
    }
    __syncthreads();  // this stage is read; the next step's copy may refill it
  }

  // acc1 is dQ (query blocks) or dK, both of width c; acc2 is dV, width d.
  out1 += (size_t)b * own_rows * c;
  float* out2 = dv + (size_t)b * n * d;
#pragma unroll
  for (int nt = 0; nt < kN; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = own0 + warp * 16 + g + 8 * (i >> 1);
      const int col = col0 + nt * 8 + 2 * t + (i & 1);
      if (row < own_rows) {
        if (col < c) out1[(size_t)row * c + col] = acc1[nt][i];
        if (!kDQ && col < d) out2[(size_t)row * d + col] = acc2[nt][i];
      }
    }
  }
}

// Blocks [0, q_blocks * splits * kChunks) own query tiles (dQ), the rest
// key tiles (dK, dV). A query tile's keys are split into ranges of
// split_rows, so that its blocks stream about as many rows as a key tile's
// (the queries): with splits > 1 each writes its partial dQ to its part of
// dq_part (splits, B, M, C), which flash_bwd_dq_sum_kernel adds in order.
template <int P>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lse,
                 const float* __restrict__ delta, const float* __restrict__ dout,
                 float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dq_part, int m, int n, int c, int d, float scale,
                 int q_blocks, int splits, int split_rows) {
  constexpr int kC = Bwd<P>::kChunks;
  const int x = blockIdx.x;
  if (x < q_blocks * splits * kC) {
    const int chunk = x % kC, split = x / kC % splits, tile = x / kC / splits;
    const int s0 = split * split_rows;
    float* out = splits > 1 ? dq_part + (size_t)split * gridDim.y * m * c : dq;
    bwd_tile<P, true>(q, k, v, lse, delta, dout, out, dv, m, n, c, d, scale, tile, chunk, s0,
                      min(n, s0 + split_rows));
  } else {
    const int y = x - q_blocks * splits * kC;
    bwd_tile<P, false>(q, k, v, lse, delta, dout, dk, dv, m, n, c, d, scale, y / kC, y % kC, 0,
                       m);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int P>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse, float* part, int b,
        int m, int n, int c, int d, float scale, cudaStream_t stream) {
  using T = Fwd<P>;
  int splits, split_keys;
  fwd_split<P>(b, m, n, splits, split_keys);
  if (splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_kernel<P>, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + T::kRows - 1) / T::kRows * splits * T::kChunks, b);
  flash_fwd_kernel<P><<<grid, kFwdThreads, T::kSmem, stream>>>(q, k, v, o, lse, part, m, n, c, d,
                                                               scale, splits, split_keys);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  // Same stream: the parts are written before they are merged.
  const long long count = (long long)b * m * d, blocks = (count + 255) / 256;
  flash_fwd_merge_kernel<<<(int)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, stream>>>(
      part, o, lse, (long long)b * m, d, splits);
  return (int)cudaGetLastError();
}

// How a query tile's keys are split: into `splits` ranges of split_rows
// keys, so that a dQ block streams about as many steps as a key block.
template <int P>
void bwd_split(int m, int n, int& splits, int& split_rows) {
  constexpr int S = Bwd<P>::kStream;
  const int q_steps = (n + S - 1) / S, k_steps = (m + S - 1) / S;
  int want = (q_steps + k_steps - 1) / k_steps;
  want = want < 1 ? 1 : want > kMaxSplits ? kMaxSplits : want;
  split_rows = (q_steps + want - 1) / want * S;
  splits = (n + split_rows - 1) / split_rows;
}

template <int P>
long long bwd_scratch(int b, int m, int n, int c) {
  int splits, split_rows;
  bwd_split<P>(m, n, splits, split_rows);
  return splits > 1 ? (long long)splits * b * m * c : 0;
}

template <int P>
int bwd(const float* q, const float* k, const float* v, const float* o, const float* lse,
        const float* dout, float* dq, float* dk, float* dv, float* delta, float* dq_part, int b,
        int m, int n, int c, int d, float scale, cudaStream_t stream) {
  using T = Bwd<P>;
  int splits, split_rows;
  bwd_split<P>(m, n, splits, split_rows);
  if (splits > 1 && dq_part == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_bwd_kernel<P>, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int rows = b * m;
  flash_bwd_delta_kernel<<<(rows + 255) / 256, 256, 0, stream>>>(o, dout, delta, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Same stream: delta is written before the backward kernel reads it, and
  // the partial dQ before they are added.
  const int q_blocks = (m + kOwn - 1) / kOwn, k_blocks = (n + kOwn - 1) / kOwn;
  const dim3 grid((q_blocks * splits + k_blocks) * T::kChunks, b);
  flash_bwd_kernel<P><<<grid, kBwdThreads, T::kSmem, stream>>>(
      q, k, v, lse, delta, dout, dq, dk, dv, dq_part, m, n, c, d, scale, q_blocks, splits,
      split_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long count = (long long)b * m * c;
  const long long want = (count + 255) / 256;
  flash_bwd_dq_sum_kernel<<<(int)(want < 132 * 16 ? want : 132 * 16), 256, 0, stream>>>(
      dq_part, dq, count, splits);
  return (int)cudaGetLastError();
}

// The padded width of both directions: the next power of two >= C, D and 16.
int padded_width(int c, int d) {
  const int w = c > d ? c : d;
  if (w < 1 || w > kMaxWidth) return 0;
  int p = 16;
  while (p < w) p *= 2;
  return p;
}

}  // namespace

extern "C" {

int pasnl_flash_max_width() { return kMaxWidth; }

// Floats of scratch the forward needs for its key ranges' parts, splits *
// B * M * (D + 2) where a tile's keys are split (0: none, or a width past
// 256).
long long pasnl_flash_fwd_scratch(int b, int m, int n, int c, int d) {
  int splits = 0, split_keys = 0;
  switch (padded_width(c, d)) {
    case 16: fwd_split<16>(b, m, n, splits, split_keys); break;
    case 32: fwd_split<32>(b, m, n, splits, split_keys); break;
    case 64: fwd_split<64>(b, m, n, splits, split_keys); break;
    case 128: fwd_split<128>(b, m, n, splits, split_keys); break;
    case 256: fwd_split<256>(b, m, n, splits, split_keys); break;
    default: break;
  }
  return splits > 1 ? (long long)splits * b * m * (d + 2) : 0;
}

#ifdef FLASH_FWD_PLAN_SWEEP
void pasnl_flash_fwd_force_splits(int splits) { g_fwd_force_splits = splits; }
#endif

int pasnl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* part,
                    int b, int m, int n, int c, int d, float scale, void* stream) {
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float *of = (float*)o, *lf = (float*)lse, *pf = (float*)part;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (padded_width(c, d)) {
    case 16: return fwd<16>(qf, kf, vf, of, lf, pf, b, m, n, c, d, scale, s);
    case 32: return fwd<32>(qf, kf, vf, of, lf, pf, b, m, n, c, d, scale, s);
    case 64: return fwd<64>(qf, kf, vf, of, lf, pf, b, m, n, c, d, scale, s);
    case 128: return fwd<128>(qf, kf, vf, of, lf, pf, b, m, n, c, d, scale, s);
    case 256: return fwd<256>(qf, kf, vf, of, lf, pf, b, m, n, c, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Floats of scratch the backward needs for its partial dQ (0: none).
long long pasnl_flash_bwd_scratch(int b, int m, int n, int c, int d) {
  switch (padded_width(c, d)) {
    case 16: return bwd_scratch<16>(b, m, n, c);
    case 32: return bwd_scratch<32>(b, m, n, c);
    case 64: return bwd_scratch<64>(b, m, n, c);
    case 128: return bwd_scratch<128>(b, m, n, c);
    case 256: return bwd_scratch<256>(b, m, n, c);
    default: return 0;
  }
}

int pasnl_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                    const void* dout, void* dq, void* dk, void* dv, void* delta, void* dq_part,
                    int b, int m, int n, int c, int d, float scale, void* stream) {
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  const float *of = (const float*)o, *lf = (const float*)lse, *df = (const float*)dout;
  float *dqf = (float*)dq, *dkf = (float*)dk, *dvf = (float*)dv, *dlf = (float*)delta;
  float* pf = (float*)dq_part;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (padded_width(c, d)) {
    case 16:
      return bwd<16>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, dlf, pf, b, m, n, c, d, scale, s);
    case 32:
      return bwd<32>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, dlf, pf, b, m, n, c, d, scale, s);
    case 64:
      return bwd<64>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, dlf, pf, b, m, n, c, d, scale, s);
    case 128:
      return bwd<128>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, dlf, pf, b, m, n, c, d, scale, s);
    case 256:
      return bwd<256>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, dlf, pf, b, m, n, c, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
