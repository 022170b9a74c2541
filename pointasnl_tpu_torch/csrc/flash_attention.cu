// Flash attention, forward and backward, in float32 on the CUDA cores, for
// Hopper (sm_90a).
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
// 6.7 GFLOP forward and 16.8 backward against a few MB of operands.
//
// What the design does about it:
//   - A row is held by G lanes (G = P / 16, P the next power of two >= C, D
//     and 16): each lane keeps 16 channels of q and 16 of the output
//     accumulator in registers, so C = D = 128 costs 32 registers of row state
//     a lane, and the q . k dot ends in log2(G) xor shuffles. C and D are
//     zero-padded to P in shared memory, which adds exactly 0 to every dot.
//   - Every warp of a block holds the same rows and takes its own share of
//     each staged chunk of keys (a split over N inside the block), so a block
//     of 8 warps covers only 32 / G rows: level 1 runs 320 blocks of 256
//     threads on 132 SMs. The 8 partial results are merged at the end in a
//     fixed order (online-softmax states in the forward, sums in the
//     backward), so every run gives the same bits.
//   - The backward is the FlashAttention-2 split: one kernel over query tiles
//     accumulates dQ (and writes delta), one over key tiles accumulates dK and
//     dV over every query row in registers. No atomics: each output element
//     is written by one lane of one block.
//   - A chunk's keys past N are skipped: they add exactly 0 and leave the
//     running max as it was (the TPU kernel masks them to -3e38).

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

// dQ over query tiles, laid out as the forward; writes delta = rowsum(dO * o).
template <int G>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ lse, const float* __restrict__ dout,
                    float* __restrict__ dq, float* __restrict__ delta,
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

  float qr[kPerLane], dor[kPerLane], acc[kPerLane];
  load_row(qr, q + qrow * c, live, c0, c);
  load_row(acc, o + qrow * d, live, c0, d);  // o, for delta only
  load_row(dor, dout + qrow * d, live, c0, d);
  float dl = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) dl = fmaf(dor[i], acc[i], dl);
  dl = group_sum<G>(dl);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;
  const float L = live ? lse[qrow] : 0.0f;

  const float* kb = k + (size_t)b * n * c;
  const float* vb = v + (size_t)b * n * d;
  for (int base = 0; base < n; base += T::kChunk) {
    __syncthreads();
    stage<T::P>(sk, kb, base, n, c, T::kChunk);
    stage<T::P>(sv, vb, base, n, d, T::kChunk);
    __syncthreads();
    const int j0 = warp * T::kSub;
    const int cnt = min(T::kSub, n - base - j0);
#pragma unroll
    for (int j = 0; j < T::kSub; ++j) {
      if (j < cnt) {
        const float s = dot_row<G>(qr, sk + (j0 + j) * T::P + c0) * scale;
        const float dp = dot_row<G>(dor, sv + (j0 + j) * T::P + c0);
        const float p = expf(s - L);
        const float ds = p * (dp - dl) * scale;
        axpy_row(acc, ds, sk + (j0 + j) * T::P + c0);
      }
    }
  }

  __syncthreads();
  float* red = smem;  // [warp][kPerLane][32]
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) red[(warp * kPerLane + i) * 32 + lane] = acc[i];
  __syncthreads();
  if (warp != 0 || !live) return;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum += red[(w * kPerLane + i) * 32 + lane];
    if (c0 + i < c) dq[qrow * c + c0 + i] = sum;
  }
  if (c0 == 0) delta[qrow] = dl;
}

// dK and dV over key tiles: a row's G lanes hold one key, the block's warps
// split the query rows.
template <int G>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ lse,
                      const float* __restrict__ delta, const float* __restrict__ dout,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int m, int n, int c, int d, float scale) {
  using T = Tile<G>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sq = smem;
  float* sdo = sq + T::kChunk * T::P;
  float* sl = sdo + T::kChunk * T::P;
  float* sdl = sl + T::kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = (lane % G) * kPerLane;
  const int key = blockIdx.x * T::kRows + lane / G;
  const int b = blockIdx.y;
  const bool live = key < n;
  const size_t krow = (size_t)b * n + (live ? key : 0);

  float kr[kPerLane], vr[kPerLane], dkr[kPerLane], dvr[kPerLane];
  load_row(kr, k + krow * c, live, c0, c);
  load_row(vr, v + krow * d, live, c0, d);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) dkr[i] = dvr[i] = 0.0f;

  const float* qb = q + (size_t)b * m * c;
  const float* db = dout + (size_t)b * m * d;
  for (int base = 0; base < m; base += T::kChunk) {
    __syncthreads();
    stage<T::P>(sq, qb, base, m, c, T::kChunk);
    stage<T::P>(sdo, db, base, m, d, T::kChunk);
    for (int i = threadIdx.x; i < T::kChunk; i += kThreads) {
      const bool in = base + i < m;
      sl[i] = in ? lse[(size_t)b * m + base + i] : 0.0f;
      sdl[i] = in ? delta[(size_t)b * m + base + i] : 0.0f;
    }
    __syncthreads();
    const int r0 = warp * T::kSub;
    const int cnt = min(T::kSub, m - base - r0);
#pragma unroll
    for (int r = 0; r < T::kSub; ++r) {
      if (r < cnt) {
        const float s = dot_row<G>(kr, sq + (r0 + r) * T::P + c0) * scale;
        const float dp = dot_row<G>(vr, sdo + (r0 + r) * T::P + c0);
        const float p = expf(s - sl[r0 + r]);
        const float ds = p * (dp - sdl[r0 + r]) * scale;
        axpy_row(dvr, p, sdo + (r0 + r) * T::P + c0);
        axpy_row(dkr, ds, sq + (r0 + r) * T::P + c0);
      }
    }
  }

  __syncthreads();
  float* red = smem;  // [warp][2 * kPerLane][32]
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    red[(warp * 2 * kPerLane + i) * 32 + lane] = dkr[i];
    red[(warp * 2 * kPerLane + kPerLane + i) * 32 + lane] = dvr[i];
  }
  __syncthreads();
  if (warp != 0 || !live) return;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    float sk = 0.0f, sv = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      sk += red[(w * 2 * kPerLane + i) * 32 + lane];
      sv += red[(w * 2 * kPerLane + kPerLane + i) * 32 + lane];
    }
    if (c0 + i < c) dk[krow * c + c0 + i] = sk;
    if (c0 + i < d) dv[krow * d + c0 + i] = sv;
  }
}

size_t fwd_smem(int p, int chunk) {
  const size_t stage = (size_t)2 * chunk * p * sizeof(float);
  const size_t merge = (size_t)kWarps * (kPerLane + 2) * 32 * sizeof(float);
  return stage > merge ? stage : merge;
}

size_t dq_smem(int p, int chunk) {
  const size_t stage = (size_t)2 * chunk * p * sizeof(float);
  const size_t merge = (size_t)kWarps * kPerLane * 32 * sizeof(float);
  return stage > merge ? stage : merge;
}

size_t dkdv_smem(int p, int chunk) {
  const size_t stage = ((size_t)2 * chunk * p + 2 * chunk) * sizeof(float);
  const size_t merge = (size_t)kWarps * 2 * kPerLane * 32 * sizeof(float);
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

template <int G>
int bwd(const float* q, const float* k, const float* v, const float* o, const float* lse,
        const float* dout, float* dq, float* dk, float* dv, float* delta, int b, int m, int n,
        int c, int d, float scale, cudaStream_t stream) {
  using T = Tile<G>;
  const size_t s1 = dq_smem(T::P, T::kChunk), s2 = dkdv_smem(T::P, T::kChunk);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<G>, s1);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkdv_kernel<G>, s2);
  if (err != cudaSuccess) return (int)err;
  const dim3 g1((m + T::kRows - 1) / T::kRows, b), g2((n + T::kRows - 1) / T::kRows, b);
  flash_bwd_dq_kernel<G><<<g1, kThreads, s1, stream>>>(q, k, v, o, lse, dout, dq, delta, m, n,
                                                         c, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Same stream: delta is written before the dK/dV kernel reads it.
  flash_bwd_dkdv_kernel<G><<<g2, kThreads, s2, stream>>>(q, k, v, lse, delta, dout, dk, dv, m,
                                                           n, c, d, scale);
  return (int)cudaGetLastError();
}

int lanes_for(int c, int d) {
  const int w = c > d ? c : d;
  if (w < 1 || w > kMaxWidth) return 0;
  int g = 1;
  while (kPerLane * g < w) g *= 2;
  return g;
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

int pasnl_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                    const void* dout, void* dq, void* dk, void* dv, void* delta, int b, int m,
                    int n, int c, int d, float scale, void* stream) {
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  const float *of = (const float*)o, *lf = (const float*)lse, *df = (const float*)dout;
  float *dqf = (float*)dq, *dkf = (float*)dk, *dvf = (float*)dv, *dlf = (float*)delta;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes_for(c, d)) {
    case 1: return bwd<1>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, dlf, b, m, n, c, d, scale, s);
    case 2: return bwd<2>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, dlf, b, m, n, c, d, scale, s);
    case 4: return bwd<4>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, dlf, b, m, n, c, d, scale, s);
    case 8: return bwd<8>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, dlf, b, m, n, c, d, scale, s);
    case 16: return bwd<16>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, dlf, b, m, n, c, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
