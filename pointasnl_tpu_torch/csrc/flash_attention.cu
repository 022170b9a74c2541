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
// flops and reads K and V once per query tile; the backward 2 B M N (3C + 2D).
// At the seg step's level 1 (B4, M 1280, N 10240, C = D = 32) that is
// 6.7 GFLOP forward and 16.8 backward against a few MB of operands. The
// forward's flops run on the CUDA cores at the float32 rate (67 TFLOP/s:
// 0.100 ms); the backward's run three times each on the tensor cores at the
// TF32 rate (495 TFLOP/s: 0.102 ms), and would take 0.250 ms at the float32
// rate.
//
// The forward's design:
//   - A row is held by G lanes (G = P / 16, P the next power of two >= C, D
//     and 16): each lane keeps 16 channels of q and 16 of the output
//     accumulator in registers, so C = D = 128 costs 32 registers of row state
//     a lane, and the q . k dot ends in log2(G) xor shuffles. C and D are
//     zero-padded to P in shared memory, which adds exactly 0 to every dot.
//   - Every warp of a block holds the same rows and takes its own share of
//     each staged chunk of keys (a split over N inside the block), so a block
//     of 8 warps covers only 32 / G rows: level 1 runs 320 blocks of 256
//     threads on 132 SMs. The 8 partial states are merged at the end in a
//     fixed order, so every run gives the same bits.
//   - A chunk's keys past N are skipped: they add exactly 0 and leave the
//     running max as it was (the TPU kernel masks them to -3e38).
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

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 16;  // channels of a row a lane holds
constexpr int kMaxWidth = 256;

template <int G>
struct Tile {
  static constexpr int P = kPerLane * G;      // padded C and D
  static constexpr int kRows = 32 / G;        // rows (or keys) a warp, and a block, holds
  static constexpr int kSub = G >= 8 ? 8 : 16;  // keys (or rows) a warp takes from a chunk
  static constexpr int kChunk = kWarps * kSub;  // keys (or rows) staged at once
};

template <int G>
__device__ __forceinline__ float group_sum(float x) {
  // Butterfly over the G lanes of a row: every lane ends with the same sum
  // (float addition is commutative, so each step's two orders agree).
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dst[r * P + c] = src[(row0 + r) * width + c], zero past `rows` or `width`.
template <int P>
__device__ __forceinline__ void stage(float* __restrict__ dst, const float* __restrict__ src,
                                      int row0, int rows, int width, int count) {
  for (int i = threadIdx.x; i < count * P; i += kThreads) {
    const int r = i / P, c = i % P;
    const int g = row0 + r;
    dst[i] = (g < rows && c < width) ? src[(size_t)g * width + c] : 0.0f;
  }
}

__device__ __forceinline__ void load_row(float (&dst)[kPerLane], const float* __restrict__ src,
                                         bool live, int c0, int width) {
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    dst[i] = (live && c0 + i < width) ? src[c0 + i] : 0.0f;
}

template <int G>
__device__ __forceinline__ float dot_row(const float (&a)[kPerLane], const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerLane / 4; ++i) {
    const float4 x = b4[i];
    s = fmaf(a[4 * i + 0], x.x, s);
    s = fmaf(a[4 * i + 1], x.y, s);
    s = fmaf(a[4 * i + 2], x.z, s);
    s = fmaf(a[4 * i + 3], x.w, s);
  }
  return group_sum<G>(s);
}

__device__ __forceinline__ void axpy_row(float (&acc)[kPerLane], float a,
                                         const float* __restrict__ x) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
  for (int i = 0; i < kPerLane / 4; ++i) {
    const float4 y = x4[i];
    acc[4 * i + 0] = fmaf(a, y.x, acc[4 * i + 0]);
    acc[4 * i + 1] = fmaf(a, y.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(a, y.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(a, y.w, acc[4 * i + 3]);
  }
}

// One block: batch element blockIdx.y, rows blockIdx.x * kRows + lane / G.
template <int G>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int m, int n, int c, int d, float scale) {
  using T = Tile<G>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sk = smem;
  float* sv = sk + T::kChunk * T::P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = (lane % G) * kPerLane;
  const int row = blockIdx.x * T::kRows + lane / G;
  const int b = blockIdx.y;
  const bool live = row < m;
  const size_t qrow = (size_t)b * m + (live ? row : 0);

  float qr[kPerLane], acc[kPerLane];
  load_row(qr, q + qrow * c, live, c0, c);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;
  float mx = -INFINITY, l = 0.0f;

  const float* kb = k + (size_t)b * n * c;
  const float* vb = v + (size_t)b * n * d;
  for (int base = 0; base < n; base += T::kChunk) {
    __syncthreads();  // the previous chunk is consumed
    stage<T::P>(sk, kb, base, n, c, T::kChunk);
    stage<T::P>(sv, vb, base, n, d, T::kChunk);
    __syncthreads();
    const int j0 = warp * T::kSub;
    const int cnt = min(T::kSub, n - base - j0);
    if (cnt <= 0) continue;
    float s[T::kSub];
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < T::kSub; ++j) {
      const float x = dot_row<G>(qr, sk + (j0 + j) * T::P + c0) * scale;
      s[j] = j < cnt ? x : -INFINITY;
      cmax = fmaxf(cmax, s[j]);
    }
    const float mnew = fmaxf(mx, cmax);  // finite: the chunk holds a key
    const float alpha = expf(mx - mnew);  // 0 at the first keys (mx = -inf)
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < T::kSub; ++j) {
      if (j < cnt) {
        const float p = expf(s[j] - mnew);
        l += p;
        axpy_row(acc, p, sv + (j0 + j) * T::P + c0);
      }
    }
    mx = mnew;
  }

  // Merge the warps' online-softmax states, warp 0 first.
  __syncthreads();
  float* red = smem;  // [warp][kPerLane + 2][32]
  float* mine = red + warp * (kPerLane + 2) * 32 + lane;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) mine[i * 32] = acc[i];
  mine[kPerLane * 32] = mx;
  mine[(kPerLane + 1) * 32] = l;
  __syncthreads();
  if (warp != 0 || !live) return;
  float top = -INFINITY;
  for (int w = 0; w < kWarps; ++w) top = fmaxf(top, red[(w * (kPerLane + 2) + kPerLane) * 32 + lane]);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;
  for (int w = 0; w < kWarps; ++w) {
    const float* st = red + w * (kPerLane + 2) * 32 + lane;
    const float f = expf(st[kPerLane * 32] - top);  // 0 for a warp that saw no key
    sum = fmaf(st[(kPerLane + 1) * 32], f, sum);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] = fmaf(st[i * 32], f, acc[i]);
  }
  float* orow = o + qrow * d;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    if (c0 + i < d) orow[c0 + i] = acc[i] / sum;
  if (c0 == 0) lse[qrow] = top + logf(sum);
}

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

size_t fwd_smem(int p, int chunk) {
  const size_t stage = (size_t)2 * chunk * p * sizeof(float);
  const size_t merge = (size_t)kWarps * (kPerLane + 2) * 32 * sizeof(float);
  return stage > merge ? stage : merge;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int G>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse, int b, int m,
        int n, int c, int d, float scale, cudaStream_t stream) {
  using T = Tile<G>;
  const size_t smem = fwd_smem(T::P, T::kChunk);
  cudaError_t err = allow_smem(flash_fwd_kernel<G>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + T::kRows - 1) / T::kRows, b);
  flash_fwd_kernel<G><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, m, n, c, d, scale);
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

int lanes_for(int c, int d) {
  const int w = c > d ? c : d;
  if (w < 1 || w > kMaxWidth) return 0;
  int g = 1;
  while (kPerLane * g < w) g *= 2;
  return g;
}

// The backward's padded width: the next power of two >= C, D and 16.
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

int pasnl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                    int m, int n, int c, int d, float scale, void* stream) {
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float *of = (float*)o, *lf = (float*)lse;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes_for(c, d)) {
    case 1: return fwd<1>(qf, kf, vf, of, lf, b, m, n, c, d, scale, s);
    case 2: return fwd<2>(qf, kf, vf, of, lf, b, m, n, c, d, scale, s);
    case 4: return fwd<4>(qf, kf, vf, of, lf, b, m, n, c, d, scale, s);
    case 8: return fwd<8>(qf, kf, vf, of, lf, b, m, n, c, d, scale, s);
    case 16: return fwd<16>(qf, kf, vf, of, lf, b, m, n, c, d, scale, s);
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
